"""Per-category text→image generation CLI (torch): SDXL with the optional x4
upscaler, and the DeepFloyd-IF cascade.

Counterpart of ``divergen_tpu/pipeline/generation/txt2img.py:main``, with the
same flags: one prompt file per category (or ``--prompt``),
``{cat}_{count:07d}.png`` naming with ``--offset``, ``--disable_overwrite``
resume, and the sample range of each rank taken from ``RANK`` / ``WORLD_SIZE``
(or from ``torch.distributed`` with ``--dist``).

- ``--stages XL [x4]``: SDXL into ``samples/XL``; with ``x4`` each batch is
  then upscaled ×4 into ``samples/x4``, conditioned on the upscaler's own text
  tower (``--text_ckpt_up``), else on the SDXL towers' states sliced to its
  width, else on hash-seeded states. ``--int8`` runs the W8A8 int8
  transformer matmuls, ``--encoder_reuse`` Faster-Diffusion encoder reuse.
- ``--stages I [II]``: IF stage I (64²) into ``samples/I``, and stage II
  (64 → 256) into ``samples/II``, conditioned on T5 states: from
  ``--t5_dir`` through the host-side ``transformers`` package, else
  hash-seeded at width 4096. A stage list that does not start with ``I`` but
  names an IF stage exits, as in JAX.

Without checkpoints the modules run on random weights drawn from fixed seeds
(random IF UNets at the JAX CLI's reduced sizing; ``--if_unet_ckpt`` /
``--if_unet_ckpt2`` load the IF-I-XL / IF-II-L releases); without both SDXL
text checkpoints the full-width path conditions on hash-seeded
pseudo-embeddings, and ``--tiny`` runs tiny random models and text towers.
``--data_parallel`` splits each SDXL batch over every local card where there
is more than one (``SDXLPipeline(mesh=…)``), as the JAX CLI shards it over
``jax.devices()``; on one card it changes nothing.

    python -m divergen_tpu_torch.pipeline.generation.txt2img \\
        --from_file prompts/ --n_samples 4 --sampler dpmpp_2m --steps 25
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional, Tuple

import numpy as np
import torch

def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser("txt2img")
    p.add_argument("--prompt", type=str, default="a photo of a single object")
    p.add_argument("--from_file", type=str, action="append")
    p.add_argument("--outdir", type=str, default="output/txt2img-samples")
    p.add_argument("--n_samples", type=int, default=1)
    p.add_argument("--max_batch_size", type=int, default=4)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--dist", action="store_true", default=False,
                   help="rank and world size from an initialized torch.distributed")
    p.add_argument("--ckpt_dir", type=str, default="")
    p.add_argument("--unet_ckpt", type=str, default="")
    p.add_argument("--text_ckpt_l", type=str, default="",
                   help="SDXL text tower 1 (CLIP ViT-L/14, HF or openai layout)")
    p.add_argument("--text_ckpt_g", type=str, default="",
                   help="SDXL text tower 2 (OpenCLIP ViT-bigG/14 w/ projection)")
    p.add_argument("--text_ckpt_up", type=str, default="",
                   help="x4-upscaler text tower checkpoint (OpenCLIP ViT-H in HF "
                        "CLIPTextModel layout)")
    p.add_argument("--vae_ckpt", type=str, default="",
                   help="diffusers AutoencoderKL checkpoint (decoder weights)")
    p.add_argument("--bpe_path", type=str, default="",
                   help="CLIP BPE merges file for the tokenizer")
    p.add_argument("--stages", type=str, nargs="+", default=["XL"],
                   help="XL [x4] = SDXL, optionally upscaled x4; I [II] = the "
                        "DeepFloyd-IF cascade (64² stage I, optional 64→256 stage II)")
    p.add_argument("--if_unet_ckpt", type=str, default="",
                   help="diffusers IF-I UNet checkpoint (stage I)")
    p.add_argument("--if_unet_ckpt2", type=str, default="",
                   help="diffusers IF-II UNet checkpoint (stage II)")
    p.add_argument("--t5_dir", type=str, default="",
                   help="T5 encoder dir (transformers layout) for IF conditioning, run on "
                        "the host; hash-seeded states otherwise")
    p.add_argument("--offset", type=int, default=0)
    p.add_argument("--disable_overwrite", action="store_true", default=False)
    p.add_argument("--height", type=int, default=1024)
    p.add_argument("--width", type=int, default=1024)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--sampler", type=str, default="euler", choices=["euler", "dpmpp_2m"])
    p.add_argument("--guidance", type=float, default=7.5)
    p.add_argument("--tiny", action="store_true", help="tiny random model (smoke/test)")
    p.add_argument("--int8", action="store_true",
                   help="W8A8 int8 transformer matmuls (hand-written int8 GEMM kernels)")
    p.add_argument("--encoder_reuse", action="store_true",
                   help="Faster-Diffusion encoder reuse: skip the UNet down path on odd steps")
    p.add_argument("--data_parallel", action="store_true",
                   help="split each SDXL batch over every local card (more than one)")
    p.add_argument("--device", type=str, default="",
                   help="torch device (default: cuda; without a card pass cpu, nothing falls back)")
    return p


def _prompt_files(from_file: Optional[List[str]]) -> List[str]:
    if not from_file:
        return []
    if os.path.isdir(from_file[0]):
        return sorted(glob(os.path.join(from_file[0], "*.txt")))
    return list(from_file)


def _load(module: torch.nn.Module, jax_tree) -> None:
    from ...utils.convert import params_from_jax

    module.load_state_dict(params_from_jax(jax_tree))


def _build_pipeline(args, device: torch.device):
    from ...modeling.layers import flax_init_
    from .pipeline import SDXLPipeline
    from .unet import UNetSDXL
    from .vae import VAEDecoder

    dtype = torch.bfloat16
    # the weights are float either way; with --int8 the pipeline quantizes the
    # transformer matmuls once per generate call, before the step loop
    if args.tiny:
        unet = UNetSDXL.tiny(quant=args.int8, dtype=dtype, device=device)
        vae = VAEDecoder(channels=(32, 32), dtype=dtype, device=device)
    else:
        unet = UNetSDXL(quant=args.int8, dtype=dtype, device=device)
        vae = VAEDecoder(dtype=dtype, device=device)
    gen = torch.Generator(device=device)
    if args.unet_ckpt:
        from ...utils.torch_weights import load_sdxl_unet_params

        _load(unet, load_sdxl_unet_params(args.unet_ckpt, unet))
    else:
        flax_init_(unet, gen.manual_seed(0))
    if args.vae_ckpt:
        from ...utils.torch_weights import load_sdxl_vae_params

        _load(vae, load_sdxl_vae_params(args.vae_ckpt, n_levels=len(vae.channels)))
    else:
        flax_init_(vae, gen.manual_seed(1))
    mesh = None
    if args.data_parallel and device.type == "cuda" and torch.cuda.device_count() > 1:
        mesh = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    pipe = SDXLPipeline(unet, vae, steps=args.steps, guidance_scale=args.guidance,
                        encoder_reuse=args.encoder_reuse, int8=args.int8, mesh=mesh,
                        sampler=args.sampler)
    return pipe, unet.context_dim


def _build_upscaler(args, device: torch.device):
    """Stage III: the x4 upscale pipeline (SD-x4-upscaler geometry, random
    weights) and its output directory."""
    from ...modeling.layers import flax_init_
    from .upscale import UpscalePipeline, upscaler_unet
    from .vae import VAEDecoder

    dtype = torch.bfloat16
    unet = upscaler_unet(dtype=dtype, tiny=args.tiny, device=device)
    # the x4 upscaler's VAE has 3 levels: it decodes x4, not the SDXL VAE's x8
    vae = VAEDecoder(channels=(8, 8, 8) if args.tiny else (128, 256, 512), dtype=dtype,
                     device=device)
    gen = torch.Generator(device=device)
    flax_init_(unet, gen.manual_seed(2))
    flax_init_(vae, gen.manual_seed(3))
    pipe = UpscalePipeline(unet, vae, steps=max(args.steps // 2, 2))
    return pipe, os.path.join(args.outdir, "samples", "x4")


def _generator(device: torch.device, seed: int, fold: int, stage: int = 0) -> torch.Generator:
    """The draws of one batch: the JAX CLI folds (prompt, start) into
    PRNGKey(seed + rank), and a later stage folds 7 into that; the same folds
    over a torch generator (different bits, same roles)."""
    return torch.Generator(device=device).manual_seed(seed * 2**32 + fold + (stage << 56))


def encode_prompts_random(prompts: List[str], ctx_dim: int) -> torch.Tensor:
    """Deterministic pseudo-embeddings when no text-tower checkpoint is given,
    seeded from Python's ``hash`` of the prompt (as the JAX CLI does: string
    hashing is salted per process unless PYTHONHASHSEED is set)."""
    outs = [np.random.default_rng(abs(hash(p)) % (2**31)).standard_normal((77, ctx_dim), np.float32)
            for p in prompts]
    return torch.from_numpy(np.stack(outs))


def _jobs(args) -> List[Tuple[str, str, int]]:
    """(category id, prompt, prompt index) of every prompt, sorted per file."""
    files = _prompt_files(args.from_file)
    jobs = []
    for f in files:
        cat = os.path.basename(f).split(".")[0]
        with open(f) as fh:
            lines = [l.strip() for l in fh.read().splitlines() if l.strip()]
        jobs.extend((cat, prompt, pi) for pi, prompt in enumerate(sorted(lines)))
    if not files:
        jobs.append(("prompt", args.prompt, 0))
    return jobs


def _batches(args, rank: int, per_rank: int, pi: int):
    """(start, sample counts) of each batch of a prompt on this rank."""
    for start in range(0, per_rank, args.max_batch_size):
        bs = min(args.max_batch_size, per_rank - start)
        yield start, [args.offset + pi * args.n_samples + rank * per_rank + start + j
                      for j in range(bs)]


def _build_if_pipelines(args, device: torch.device):
    """Stage I and (with ``II`` in ``--stages``) stage II: the IF-I-XL /
    IF-II-L releases from checkpoints, else random weights at the JAX CLI's
    reduced sizing (``--tiny``: tiny UNets)."""
    from ...modeling.layers import flax_init_
    from .if_unet import IFStageIIPipeline, IFStageIPipeline, IFUNet

    dtype = torch.bfloat16
    kw = dict(dtype=dtype, device=device)
    tiny = dict(channels=(8, 16), layers_per_block=1, encoder_dim=16, head_dim=4, pool_heads=2)
    gen = torch.Generator(device=device)

    def weights(unet, ckpt, seed):
        if ckpt:
            from ...utils.torch_weights import load_if_unet_params

            _load(unet, load_if_unet_params(ckpt, unet))
        else:
            flax_init_(unet, gen.manual_seed(seed))
        return unet

    if args.tiny:
        u1 = IFUNet(**tiny, **kw)
    elif args.if_unet_ckpt:
        u1 = IFUNet.if_i_xl(**kw)
    else:
        # the JAX CLI's random-weight sizing (IF-I-XL's initialization does
        # not fit its 16 GB chip); chip_smoke.py builds the full width
        u1 = IFUNet(channels=(128, 256, 512, 512), **kw)
    pipe1 = IFStageIPipeline(weights(u1, args.if_unet_ckpt, 0), steps=args.steps,
                             guidance_scale=args.guidance)
    pipe2 = None
    if "II" in args.stages:
        if args.tiny:
            u2 = IFUNet(**tiny, in_channels=6, noise_level_cond=True, **kw)
        elif args.if_unet_ckpt2:
            u2 = IFUNet.if_ii_l(**kw)
        else:
            u2 = IFUNet(channels=(64, 128, 256, 256), in_channels=6, attn_start=2,
                        noise_level_cond=True, **kw)
        pipe2 = IFStageIIPipeline(weights(u2, args.if_unet_ckpt2, 1),
                                  steps=max(args.steps // 2, 2))
    return pipe1, pipe2


def _if_text_encoder(args, encoder_dim: int, device: torch.device):
    """T5 states for IF conditioning: the host-side ``transformers`` T5 of
    ``--t5_dir`` (the reference's ``stage_1.encode_prompt``), else
    hash-seeded states of width ``encoder_dim``."""
    if not args.t5_dir:
        return lambda prompts: encode_prompts_random(prompts, encoder_dim).to(device)
    try:
        from transformers import AutoTokenizer, T5EncoderModel
    except ImportError as err:
        raise SystemExit(f"--t5_dir needs the transformers package, which is not installed "
                         f"({err}); leave --t5_dir out for hash-seeded T5 states") from err
    tok = AutoTokenizer.from_pretrained(args.t5_dir)
    t5 = T5EncoderModel.from_pretrained(args.t5_dir).eval()

    @torch.inference_mode()
    def encode(prompts):
        b = tok(prompts, padding="max_length", max_length=77, truncation=True,
                return_tensors="pt")
        out = t5(input_ids=b.input_ids, attention_mask=b.attention_mask).last_hidden_state
        return out[..., :encoder_dim].float().to(device)

    return encode


def run_if_cascade(args) -> int:
    """The IF path: stage I CFG denoise at 64² (16² with ``--tiny``), then
    optionally stage II ×4 (×2 with ``--tiny``); the reference's
    ``samples/I`` and ``samples/II`` with ``{cat}_{count:07d}.png``."""
    from ...utils.dist import entry_device, rank_world
    from ...utils.png import write_png

    device = entry_device(args.device)
    rank, world = rank_world(args.dist)
    per_rank = args.n_samples // world
    if per_rank * world != args.n_samples:
        raise SystemExit("n_samples must divide by world size")
    pipe1, pipe2 = _build_if_pipelines(args, device)
    size = 16 if args.tiny else 64
    dirs = {"I": os.path.join(args.outdir, "samples", "I")}
    if pipe2 is not None:
        dirs["II"] = os.path.join(args.outdir, "samples", "II")
    for d in dirs.values():
        os.makedirs(d, exist_ok=True)
    encode = _if_text_encoder(args, pipe1.unet.encoder_dim, device)
    unc_ctx = encode([""])

    def to_uint8(imgs):
        return ((imgs + 1.0) * 127.5).cpu().numpy().astype(np.uint8)

    n_done = 0
    for cat, prompt, pi in _jobs(args):
        ctx = encode([prompt])
        for start, counts in _batches(args, rank, per_rank, pi):
            names = [f"{cat}_{c:07d}.png" for c in counts]
            if args.disable_overwrite and all(os.path.exists(os.path.join(d, n))
                                              for d in dirs.values() for n in names):
                continue
            bs = len(names)
            ctx_b, unc_b = ctx.expand(bs, -1, -1), unc_ctx.expand(bs, -1, -1)
            imgs = pipe1.generate(_generator(device, args.seed + rank, pi * 100000 + start),
                                  ctx_b, unc_b, size=size)
            for img, n in zip(to_uint8(imgs), names):
                write_png(os.path.join(dirs["I"], n), img)
                n_done += 1
            if pipe2 is not None:
                gen = _generator(device, args.seed + rank, pi * 100000 + start, stage=7)
                up = pipe2.generate(gen, imgs, ctx_b, unc_b, scale=2 if args.tiny else 4)
                for img, n in zip(to_uint8(up), names):
                    write_png(os.path.join(dirs["II"], n), img)
    print(f"done: {n_done} images → {dirs['I']}")
    return 0


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.stages and args.stages[0] == "I":
        return run_if_cascade(args)
    if "I" in args.stages or "II" in args.stages:
        # the cascade is driven by stage I's output: a stage-II-only run is
        # not an entry, and must not fall through to SDXL writing samples/II
        raise SystemExit(f"IF cascade stages {args.stages} must start with 'I' (e.g. --stages "
                         "I II); the SDXL path uses --stages XL [x4]")
    from ...utils.dist import entry_device, rank_world
    from ...utils.png import write_png
    from .pipeline import images_to_uint8

    device = entry_device(args.device)
    rank, world = rank_world(args.dist)
    per_rank = args.n_samples // world
    if per_rank * world != args.n_samples:
        raise SystemExit("n_samples must divide by world size")

    sample_dir = os.path.join(args.outdir, "samples", args.stages[0])
    os.makedirs(sample_dir, exist_ok=True)
    pipe, ctx_dim = _build_pipeline(args, device)
    upscaler = None
    if "x4" in args.stages:
        upscaler, up_dir = _build_upscaler(args, device)
        os.makedirs(up_dir, exist_ok=True)

    encoder = None
    if args.text_ckpt_l and args.text_ckpt_g:
        from ...modeling.text.clip import build_sdxl_text_towers
        from ...utils.torch_weights import load_sdxl_text_params
        from .text import SDXLTextEncoder

        clip_l, big_g = build_sdxl_text_towers(device=device)
        _load(clip_l, load_sdxl_text_params(args.text_ckpt_l))
        _load(big_g, load_sdxl_text_params(args.text_ckpt_g))
        encoder = SDXLTextEncoder(clip_l, big_g, bpe_path=args.bpe_path)
    elif args.tiny:
        from .text import SDXLTextEncoder

        encoder = SDXLTextEncoder.random(seed=args.seed, tiny=True, device=device)
    # stage III's conditioning (the reference passes the prompt to stage 3):
    # the upscaler's own tower, else the SDXL towers' states sliced to its
    # width, else hash-seeded states
    up_encoder = None
    if upscaler is not None and args.text_ckpt_up:
        from ...utils.torch_weights import load_sdxl_text_params
        from .text import UpscalerTextEncoder, tower_from_params

        up_encoder = UpscalerTextEncoder(
            tower_from_params(load_sdxl_text_params(args.text_ckpt_up), device=device),
            bpe_path=args.bpe_path)

    def upscaler_states(prompt):
        up_dim = upscaler.unet.context_dim
        if up_encoder is not None:
            return up_encoder.encode([prompt])[..., :up_dim]
        if encoder is not None:
            return encoder.encode_sliced([prompt], up_dim)
        return encode_prompts_random([prompt], up_dim).to(device)

    pooled_dim = 1280
    use_pooled = not args.tiny
    if encoder is not None:
        unc_ctx, unc_pooled_1 = encoder.encode([""])
    else:
        unc_ctx, unc_pooled_1 = encode_prompts_random([""], ctx_dim).to(device), None

    n_done = 0
    for cat, prompt, pi in _jobs(args):
        if encoder is not None:
            ctx, pooled_1 = encoder.encode([prompt])
        else:
            ctx, pooled_1 = encode_prompts_random([prompt], ctx_dim).to(device), None
        for start, counts in _batches(args, rank, per_rank, pi):
            paths = [os.path.join(sample_dir, f"{cat}_{c:07d}.png") for c in counts]
            if args.disable_overwrite and all(os.path.exists(p) for p in paths):
                continue
            bs = len(paths)
            pooled = unc_pooled = None
            if use_pooled:
                zeros = torch.zeros((bs, pooled_dim), device=device)
                pooled = pooled_1.expand(bs, -1) if pooled_1 is not None else zeros
                unc_pooled = unc_pooled_1.expand(bs, -1) if unc_pooled_1 is not None else zeros
            imgs = pipe.generate(_generator(device, args.seed + rank, pi * 100000 + start),
                                 ctx.expand(bs, -1, -1), unc_ctx.expand(bs, -1, -1),
                                 pooled, unc_pooled, height=args.height, width=args.width)
            imgs = images_to_uint8(imgs)
            for img, path in zip(imgs, paths):
                write_png(path, img)
                n_done += 1
            if upscaler is not None:
                uctx, uunc = upscaler_states(prompt), upscaler_states("")
                gen = _generator(device, args.seed + rank, pi * 100000 + start, stage=7)
                uimgs = upscaler.upscale(gen, torch.from_numpy(imgs).float(),
                                         uctx.expand(bs, -1, -1), uunc.expand(bs, -1, -1))
                for img, path in zip(images_to_uint8(uimgs), paths):
                    write_png(os.path.join(up_dir, os.path.basename(path)), img)
    print(f"done: {n_done} images → {sample_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
