"""Per-category text→image generation CLI, SDXL path (torch).

Counterpart of the ``XL`` path of ``divergen_tpu/pipeline/generation/
txt2img.py:main``, with the same flags: one prompt file per category (or
``--prompt``), ``{cat}_{count:07d}.png`` naming with ``--offset``,
``--disable_overwrite`` resume, and the sample range of each rank taken from
``RANK`` / ``WORLD_SIZE`` (or from ``torch.distributed`` with ``--dist``).
Without ``--unet_ckpt`` / ``--vae_ckpt`` the modules run on random weights
drawn from a fixed seed; without both text checkpoints the full-width path
conditions on hash-seeded pseudo-embeddings, and ``--tiny`` runs tiny random
text towers. ``--int8`` runs the W8A8 int8 transformer matmuls (a ``quant``
UNet, quantized once per generate call). The x4 upscaler, the IF cascade,
``--encoder_reuse`` and ``--data_parallel`` are not ported yet.

    python -m divergen_tpu_torch.pipeline.generation.txt2img \\
        --from_file prompts/ --n_samples 4 --sampler dpmpp_2m --steps 25
"""
from __future__ import annotations

import argparse
import os
from glob import glob
from typing import List, Optional

import numpy as np
import torch

_NOT_PORTED = ("encoder_reuse", "data_parallel")


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
    p.add_argument("--text_ckpt_up", type=str, default="")
    p.add_argument("--vae_ckpt", type=str, default="",
                   help="diffusers AutoencoderKL checkpoint (decoder weights)")
    p.add_argument("--bpe_path", type=str, default="",
                   help="CLIP BPE merges file for the tokenizer")
    p.add_argument("--stages", type=str, nargs="+", default=["XL"],
                   help="XL = SDXL (the only stage ported so far)")
    p.add_argument("--if_unet_ckpt", type=str, default="")
    p.add_argument("--if_unet_ckpt2", type=str, default="")
    p.add_argument("--t5_dir", type=str, default="")
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
    p.add_argument("--encoder_reuse", action="store_true")
    p.add_argument("--data_parallel", action="store_true")
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
    pipe = SDXLPipeline(unet, vae, steps=args.steps, guidance_scale=args.guidance,
                        int8=args.int8, sampler=args.sampler)
    return pipe, unet.context_dim


def encode_prompts_random(prompts: List[str], ctx_dim: int) -> torch.Tensor:
    """Deterministic pseudo-embeddings when no text-tower checkpoint is given,
    seeded from Python's ``hash`` of the prompt (as the JAX CLI does: string
    hashing is salted per process unless PYTHONHASHSEED is set)."""
    outs = [np.random.default_rng(abs(hash(p)) % (2**31)).standard_normal((77, ctx_dim), np.float32)
            for p in prompts]
    return torch.from_numpy(np.stack(outs))


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if args.stages != ["XL"]:
        raise SystemExit(f"--stages {' '.join(args.stages)}: only XL is ported yet "
                         "(the IF cascade and the x4 upscaler are not yet ported)")
    for flag in _NOT_PORTED:
        if getattr(args, flag):
            raise SystemExit(f"--{flag} is not yet ported")
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

    pooled_dim = 1280
    use_pooled = not args.tiny
    if encoder is not None:
        unc_ctx, unc_pooled_1 = encoder.encode([""])
    else:
        unc_ctx, unc_pooled_1 = encode_prompts_random([""], ctx_dim).to(device), None

    files = _prompt_files(args.from_file)
    jobs = []  # (category_id, prompt, prompt_idx)
    for f in files:
        cat = os.path.basename(f).split(".")[0]
        with open(f) as fh:
            lines = [l.strip() for l in fh.read().splitlines() if l.strip()]
        jobs.extend((cat, prompt, pi) for pi, prompt in enumerate(sorted(lines)))
    if not files:
        jobs.append(("prompt", args.prompt, 0))

    n_done = 0
    for cat, prompt, pi in jobs:
        if encoder is not None:
            ctx, pooled_1 = encoder.encode([prompt])
        else:
            ctx, pooled_1 = encode_prompts_random([prompt], ctx_dim).to(device), None
        for start in range(0, per_rank, args.max_batch_size):
            bs = min(args.max_batch_size, per_rank - start)
            counts = [args.offset + pi * args.n_samples + rank * per_rank + start + j
                      for j in range(bs)]
            paths = [os.path.join(sample_dir, f"{cat}_{c:07d}.png") for c in counts]
            if args.disable_overwrite and all(os.path.exists(p) for p in paths):
                continue
            # the JAX CLI folds (prompt, start) into PRNGKey(seed + rank); the
            # same fold over a torch generator (different bits, same roles)
            gen = torch.Generator(device=device).manual_seed(
                (args.seed + rank) * 2**32 + pi * 100000 + start)
            pooled = unc_pooled = None
            if use_pooled:
                zeros = torch.zeros((bs, pooled_dim), device=device)
                pooled = pooled_1.expand(bs, -1) if pooled_1 is not None else zeros
                unc_pooled = unc_pooled_1.expand(bs, -1) if unc_pooled_1 is not None else zeros
            imgs = pipe.generate(gen, ctx.expand(bs, -1, -1), unc_ctx.expand(bs, -1, -1),
                                 pooled, unc_pooled, height=args.height, width=args.width)
            for img, path in zip(images_to_uint8(imgs), paths):
                write_png(path, img)
                n_done += 1
    print(f"done: {n_done} images → {sample_dir}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
