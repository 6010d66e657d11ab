#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles divergen_tpu_torch/csrc/*.cu with nvcc (timed).
3. Kernel phases: each hand-written kernel against its plain torch version
   on the same bf16 inputs (plain version in float32), at the shapes of the
   SDXL slice plus ragged cases. Bound per phase: relative L2 error
   <= 1e-2 and max |error| <= 3e-2 * max |reference|. Prints both errors
   and the median times of kernel and plain version (CUDA events).
4. Small models: a narrow UNet (d = 64 self-attention, GEGLU) and a VAE
   decoder with a d = 512 mid attention, bf16 on the card through the
   kernels, against the same weights in float32 on the CPU.
5. Slice at full SDXL width, launch counters reset just before it:
   (a) the port's ``txt2img.main`` writing two 1024² PNGs;
   (b) ``SDXLTextEncoder.random(tiny=False)`` → ``SDXLPipeline.generate``,
       B = 2 at 1024², DPM-Solver++ 2M, 4 steps; images finite in [0, 255].
   Every kernel's launch counter must have risen during the slice. Then it
   times a CFG denoise step and the VAE decode (medians of 3 runs) and the
   text encode.
6. Prints the kernels' JSON line, the card line, and as the last line
   {"ok": true, "device": {...}}. Any failed phase raises: exit code != 0.
"""
from __future__ import annotations

import json
import os
import statistics
import struct
import subprocess
import sys
import tempfile
import time
import zlib

import torch

STEPS = 4
REL_L2_BOUND = 1e-2
MAX_ABS_BOUND = 3e-2  # times max |reference|


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_pair(kernel_fn, plain_fn, reps: int = 5):
    """Median ms of each, timed in turns (plain, kernel, kernel, plain)."""
    def once(fn):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end)

    kernel_fn(), plain_fn()  # warm-up
    k_ms, p_ms = [], []
    for _ in range(reps):
        p_ms.append(once(plain_fn))
        k_ms.append(once(kernel_fn))
        k_ms.append(once(kernel_fn))
        p_ms.append(once(plain_fn))
    return statistics.median(k_ms), statistics.median(p_ms)


def compare(name: str, got: torch.Tensor, ref: torch.Tensor, rel_l2_bound=REL_L2_BOUND,
            max_abs_bound=MAX_ABS_BOUND):
    got, ref = got.float(), ref.float()
    if got.shape != ref.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got - ref).abs().max().item()
    scale = ref.abs().max().item()
    rel = ((got - ref).norm() / ref.norm().clamp_min(1e-30)).item()
    ok = rel <= rel_l2_bound and err <= max_abs_bound * scale
    log(f"  {name}: max_abs_err {err:.6g} (max|ref| {scale:.6g}), rel_l2 {rel:.6g} "
        f"[{'ok' if ok else 'FAIL'}]")
    if not ok:
        raise AssertionError(f"{name}: error above bound (rel_l2 <= {rel_l2_bound}, "
                             f"max_abs <= {max_abs_bound} * max|ref|)")
    return err


def kernel_phases(gen: torch.Generator):
    import divergen_tpu_torch.ops.flash_attention as fa_mod
    import divergen_tpu_torch.ops.ln_matmul as ln_mod

    dev = torch.device("cuda")

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(torch.bfloat16)

    results = {}

    def record(kernel, err, ms, plain_ms):
        r = results.setdefault(kernel, {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms})
        r["max_abs_err"] = max(r["max_abs_err"], err)

    log("kernel phase: flash_attention_packed")
    for b, n, c, h in ((2, 4096, 640, 10), (2, 1024, 1280, 20), (1, 1000, 640, 10)):
        qkv = randn(b, n, 3 * c)
        got = fa_mod.flash_attention_packed(qkv, h, softmax_mode="rawmax")
        ref = fa_mod.reference_attention_packed(qkv.float(), h)
        err = compare(f"packed B={b} N={n} C={c} H={h}", got, ref)
        ms, pms = time_pair(lambda: fa_mod.flash_attention_packed(qkv, h, "rawmax"),
                            lambda: fa_mod.reference_attention_packed(qkv.float(), h))
        log(f"    kernel {ms:.4f} ms, plain f32 {pms:.4f} ms")
        record("flash_attention_packed", err, ms, pms)

    log("kernel phase: fused_ln_matmul")
    cases = ((8192, 640, 5120, True, "none", False), (2048, 1280, 10240, True, "none", False),
             (4096, 1280, 5120, False, "none", True), (4096, 1280, 5120, False, "gelu", True),
             (1000, 640, 5120, True, "none", True))
    for m, k, n, geglu, act, with_bias in cases:
        x = randn(m, k)
        w = randn(n, k, scale=k ** -0.5).t()  # (K, N) view of an nn.Linear weight
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        beta = 0.1 * torch.randn(k, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev) if with_bias else None
        got = ln_mod.fused_ln_matmul(x, w, gamma, beta, 1e-5, bias, geglu, act)
        ref = ln_mod.ln_matmul_reference(x.float(), w.float(), gamma, beta, 1e-5, bias, geglu, act)
        epi = "geglu" if geglu else act
        err = compare(f"ln_matmul {epi} M={m} K={k} N={n} bias={with_bias}", got, ref)
        ms, pms = time_pair(
            lambda: ln_mod.fused_ln_matmul(x, w, gamma, beta, 1e-5, bias, geglu, act),
            lambda: ln_mod.ln_matmul_reference(x.float(), w.float(), gamma, beta, 1e-5,
                                               bias, geglu, act))
        log(f"    kernel {ms:.4f} ms, plain f32 {pms:.4f} ms")
        record("fused_ln_matmul", err, ms, pms)

    log("kernel phase: flash_attention")
    for bh, sq, sk, d, with_bias in ((1, 16384, 16384, 512, False), (4, 1000, 777, 64, True)):
        q, k, v = randn(bh, sq, d), randn(bh, sk, d), randn(bh, sk, d)
        bias = torch.randn((bh, sq, sk), generator=gen, device=dev) if with_bias else None
        got = fa_mod.flash_attention(q, k, v, bias)
        ref = fa_mod.reference_attention(q.float(), k.float(), v.float(), bias)
        err = compare(f"flash BH={bh} Sq={sq} Sk={sk} D={d} bias={with_bias}", got, ref)
        ms, pms = time_pair(lambda: fa_mod.flash_attention(q, k, v, bias),
                            lambda: fa_mod.reference_attention(q.float(), k.float(),
                                                               v.float(), bias))
        log(f"    kernel {ms:.4f} ms, plain f32 {pms:.4f} ms")
        record("flash_attention", err, ms, pms)
    return results


def small_models():
    """Narrow UNet and VAE, bf16 through the kernels vs float32 plain on the CPU.

    Bound: relative L2 <= 3e-2. The whole network runs in bf16 on the card
    (every dense and conv rounds its output), so the error is larger than
    one kernel's; 3e-2 still fails any kernel that is wrong."""
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL
    from divergen_tpu_torch.pipeline.generation.vae import VAEDecoder

    dev = torch.device("cuda")
    g = torch.Generator().manual_seed(7)
    kw = dict(block_channels=(64, 128), transformer_depths=(0, 1), head_dim=64,
              context_dim=64, layers_per_block=1, text_time=False)
    ref_unet = flax_init_(UNetSDXL(**kw), g).eval()
    unet = UNetSDXL(dtype=torch.bfloat16, device=dev, **kw).eval()
    unet.load_state_dict(ref_unet.state_dict())
    lat = torch.randn((2, 32, 32, 4), generator=g)
    t = torch.tensor([500.0, 20.0])
    ctx = torch.randn((2, 77, 64), generator=g)
    with torch.inference_mode():
        got = unet(lat.to(dev), t.to(dev), ctx.to(dev))
        ref = ref_unet(lat, t, ctx)
    compare("small UNet (d=64 packed attention, GEGLU) vs f32 CPU", got.cpu(), ref,
            rel_l2_bound=3e-2)

    ref_vae = flax_init_(VAEDecoder(channels=(32, 512)), g).eval()
    vae = VAEDecoder(channels=(32, 512), dtype=torch.bfloat16, device=dev).eval()
    vae.load_state_dict(ref_vae.state_dict())
    z = torch.randn((1, 16, 16, 4), generator=g)
    with torch.inference_mode():
        got = vae(z.to(dev))
        ref = ref_vae(z)
    compare("small VAE (d=512 mid attention) vs f32 CPU", got.cpu(), ref, rel_l2_bound=3e-2)


def read_png(path: str):
    """(width, height, decoded pixel bytes) of an 8-bit RGB PNG."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError(f"{path}: not a PNG")
    w, h = struct.unpack(">II", data[16:24])
    pos, idat = 8, b""
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        if tag == b"IDAT":
            idat += data[pos + 8:pos + 8 + length]
        pos += 12 + length
    return w, h, zlib.decompress(idat)


def slice_txt2img(tmp: str):
    from divergen_tpu_torch.pipeline.generation import txt2img

    prompts = os.path.join(tmp, "prompts")
    os.makedirs(prompts)
    with open(os.path.join(prompts, "7.txt"), "w") as f:
        f.write("a photo of a single red apple\n")
    out = os.path.join(tmp, "out")
    t0 = time.perf_counter()
    rc = txt2img.main(["--from_file", prompts, "--outdir", out, "--n_samples", "2",
                       "--max_batch_size", "2", "--height", "1024", "--width", "1024",
                       "--sampler", "dpmpp_2m", "--steps", str(STEPS)])
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"txt2img.main returned {rc}")
    for name in ("7_0000000.png", "7_0000001.png"):
        w, h, raw = read_png(os.path.join(out, "samples", "XL", name))
        if (w, h) != (1024, 1024) or len(raw) != 1024 * (1 + 1024 * 3):
            raise AssertionError(f"{name}: {w}x{h}, {len(raw)} bytes")
    log(f"  txt2img.main wrote 7_0000000.png, 7_0000001.png (1024x1024) in "
        f"{time.perf_counter() - t0:.1f} s (model build included)")


def slice_pipeline():
    from divergen_tpu_torch.modeling.layers import flax_init_
    from divergen_tpu_torch.pipeline.generation.pipeline import SDXLPipeline
    from divergen_tpu_torch.pipeline.generation.text import SDXLTextEncoder
    from divergen_tpu_torch.pipeline.generation.unet import UNetSDXL
    from divergen_tpu_torch.pipeline.generation.vae import VAEDecoder

    dev = torch.device("cuda")
    encoder = SDXLTextEncoder.random(seed=0, tiny=False, device=dev)
    prompts = ["a photo of a single red apple", "a photo of a single wooden chair"]
    ctx, pooled = encoder.encode(prompts)
    unc, unc_pooled = encoder.encode([""] * 2)
    gen = torch.Generator(device=dev)
    unet = flax_init_(UNetSDXL(dtype=torch.bfloat16, device=dev), gen.manual_seed(0))
    vae = flax_init_(VAEDecoder(dtype=torch.bfloat16, device=dev), gen.manual_seed(1))
    pipe = SDXLPipeline(unet, vae, steps=STEPS, sampler="dpmpp_2m")
    imgs = pipe.generate(gen.manual_seed(42), ctx, unc, pooled, unc_pooled, 1024, 1024)
    torch.cuda.synchronize()
    if tuple(imgs.shape) != (2, 1024, 1024, 3):
        raise AssertionError(f"images {tuple(imgs.shape)}")
    if not torch.isfinite(imgs).all() or imgs.min() < 0 or imgs.max() > 255:
        raise AssertionError("images not finite in [0, 255]")
    log(f"  SDXLPipeline.generate: images (2, 1024, 1024, 3), finite, "
        f"range [{imgs.min().item():.1f}, {imgs.max().item():.1f}], "
        f"std {imgs.float().std().item():.2f}")
    return encoder, pipe, (ctx, unc, pooled, unc_pooled)


def timings(encoder, pipe, cond, card: str):
    ctx, unc, pooled, unc_pooled = cond

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    encoder.encode(["warm-up"])
    enc_s, _ = wall(lambda: encoder.encode(["a photo of a single red apple"]))
    gen = torch.Generator(device="cuda").manual_seed(1)
    lat0 = torch.randn((2, 128, 128, 4), generator=gen, device="cuda") * pipe._init_scale
    time_ids = torch.tensor([1024.0, 1024, 0, 0, 1024, 1024], device="cuda").expand(2, 6)
    runs = [wall(lambda: pipe.denoise(lat0, ctx, unc, pooled, unc_pooled, time_ids))
            for _ in range(3)]
    den_s = statistics.median(r[0] for r in runs)
    dec_s = statistics.median(wall(lambda: pipe.decode(runs[0][1]))[0] for _ in range(3))
    log(f"  CFG denoise step (B=2 images, UNet batch 4, 1024²): "
        f"{1000 * den_s / STEPS:.1f} ms/step, median of 3 {STEPS}-step runs [{card}]")
    log(f"  VAE decode (2 images, 1024², one at a time): {dec_s:.3f} s, median of 3 [{card}]")
    log(f"  text encode (CLIP-L + bigG, 1 prompt): {1000 * enc_s:.1f} ms [{card}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from divergen_tpu_torch.ops import _build
    from divergen_tpu_torch.ops.flash_attention import flash_attention, flash_attention_packed
    from divergen_tpu_torch.ops.ln_matmul import fused_ln_matmul

    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    so = _build.build()
    _build.lib()
    log(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    log_path = so.with_suffix(".log")
    if log_path.exists():
        for line in log_path.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log(f"  ptxas: {line.strip()}")

    results = kernel_phases(torch.Generator(device="cuda").manual_seed(0))
    log("small models")
    small_models()

    log("slice: full-width SDXL")
    wrappers = (flash_attention_packed, fused_ln_matmul, flash_attention)
    for w in wrappers:
        w.launches = 0
    with tempfile.TemporaryDirectory() as tmp:
        slice_txt2img(tmp)
    torch.cuda.empty_cache()
    encoder, pipe, cond = slice_pipeline()
    launches = {w.__name__: w.launches for w in wrappers}
    log(f"  kernel launches in the slice: {launches}")
    missing = [name for name, n in launches.items() if n == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    timings(encoder, pipe, cond, card)

    sources = {
        "flash_attention_packed": ("divergen_tpu_torch/csrc/flash_attention.cu",
                                   "divergen_tpu/ops/pallas/flash_attention.py:337"),
        "fused_ln_matmul": ("divergen_tpu_torch/csrc/ln_matmul.cu",
                            "divergen_tpu/ops/pallas/ln_matmul.py:127"),
        "flash_attention": ("divergen_tpu_torch/csrc/flash_attention.cu",
                            "divergen_tpu/ops/pallas/flash_attention.py:146"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], "max_abs_err": results[name]["max_abs_err"],
                "ms": results[name]["ms"], "plain_ms": results[name]["plain_ms"]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
