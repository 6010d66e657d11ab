#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100, sm_90a).

Run from the root of a checkout:  python3 chip_smoke.py

1. Device: requires CUDA; prints the card's name and power limit.
2. Build: compiles divergen_tpu_torch/csrc/*.cu with nvcc (timed).
3. Kernel phases: each hand-written kernel (flash_attention_packed,
   fused_ln_matmul, flash_attention, flash_attention_relpos) against its
   plain torch version on the same bf16 inputs (plain version in float32),
   at the shapes of the SDXL and SAM slices plus ragged cases;
   flash_attention_relpos first on heads-first views of a fused qkv
   projection, as the ViT's attention calls it, then on (BH, N, D). Bound per
   phase: relative L2 error <= 1e-2 and max |error| <= 3e-2 * max
   |reference|. Prints both errors, the median times of kernel and plain
   version (CUDA events) and, at each kernel's main shape, the time of the
   one PyTorch call that computes the same function in bf16
   (``scaled_dot_product_attention``; ``F.linear(F.layer_norm(x))`` + GELU or
   GEGLU) and the card's bound: the larger of operations / 989 TFLOP/s and
   bytes / 3.35 TB/s. The PyTorch call is a yardstick only; the port never
   calls it.
4. Small models: a narrow UNet (d = 64 self-attention, GEGLU), a VAE decoder
   with a d = 512 mid attention, and a narrow SAM whose global layer runs the
   relative-position kernel at d = 80, bf16 on the card through the kernels,
   against the same weights in float32 on the CPU.
5. Slice at full SDXL width, launch counters reset just before it:
   (a) the port's ``txt2img.main`` writing two 1024² PNGs;
   (b) ``SDXLTextEncoder.random(tiny=False)`` → ``SDXLPipeline.generate``,
       B = 2 at 1024², DPM-Solver++ 2M, 4 steps; images finite in [0, 255].
   Every kernel's launch counter must have risen during the slice. Then it
   times a CFG denoise step and the VAE decode (medians of 3 runs) and the
   text encode.
6. Slice of the instance chain at full width (SAM ViT-H, CLIP ViT-L/14),
   launch counters reset just before it:
   (a) the port's ``corner_masks.main`` on the two PNGs of 5(a), batch 4:
       two 1024² mask PNGs with values in {0, 255};
   (b) one round of ``InstanceProducer`` over two categories: the pipeline
       of 5(b) generates, SAM ViT-H masks from corner prompts, ``ClipEncoder``
       scores image x text; then ``LivePool.make_paste_sample`` →
       ``paste_instances_boxframe`` at B 8, P 4, N 8, S 28, patch 128, 896².
   Every SAM forward must launch flash_attention_relpos 4 times and
   fused_ln_matmul 36 times. Then it times SAM per image at B = 4, CLIP per
   image at B = 16 and the compositor per pasted instance (medians of 3).
7. Prints the kernels' JSON line, the card line, and as the last line
   {"ok": true, "device": {...}}. Any failed phase raises: exit code != 0.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

STEPS = 4
PEAK_BF16_FLOPS = 989e12  # H100 SXM, dense
PEAK_BYTES_PER_S = 3.35e12
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
    """Median ms of each, timed in turns (plain, kernel, kernel, plain), and
    the (min, max) of the kernel's timed calls."""
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
    return statistics.median(k_ms), statistics.median(p_ms), (min(k_ms), max(k_ms))


def time_one(fn, reps: int = 10) -> float:
    """Median ms of ``fn`` (CUDA events), after one warm-up call."""
    fn()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(ops: float, nbytes: float):
    """(ms, "operations" | "bytes"): the least time the card could take for
    bf16 tensor-core work of ``ops`` operations moving ``nbytes`` bytes."""
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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

    def randn(*shape, scale=1.0, dtype=torch.bfloat16):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    results = {}

    def record(kernel, err, ms, plain_ms, span, library_fn, ops, nbytes):
        """The first case of a kernel is its main-path shape: its times, the
        PyTorch call's time and the bound are the kernel's numbers."""
        log(f"    kernel {ms:.4f} ms (min {span[0]:.4f}, max {span[1]:.4f} of its timed calls), "
            f"plain f32 {plain_ms:.4f} ms")
        if kernel not in results:
            b_ms, by = bound(ops, nbytes)
            lib_ms = time_one(library_fn)
            log(f"    PyTorch call (bf16) {lib_ms:.4f} ms; bound {b_ms:.4f} ms by {by} "
                f"({ops / 1e9:.1f} GFLOP, {nbytes / 1e6:.1f} MB)")
            results[kernel] = {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
                               "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms}
        results[kernel]["max_abs_err"] = max(results[kernel]["max_abs_err"], err)

    log("kernel phase: flash_attention_packed")
    for b, n, c, h in ((2, 4096, 640, 10), (2, 1024, 1280, 20), (1, 1000, 640, 10)):
        qkv = randn(b, n, 3 * c)
        got = fa_mod.flash_attention_packed(qkv, h, softmax_mode="rawmax")
        ref = fa_mod.reference_attention_packed(qkv.float(), h)
        err = compare(f"packed B={b} N={n} C={c} H={h}", got, ref)
        ms, pms, span = time_pair(lambda: fa_mod.flash_attention_packed(qkv, h, "rawmax"),
                            lambda: fa_mod.reference_attention_packed(qkv.float(), h))
        q4, k4, v4 = (t.reshape(b, n, h, c // h).transpose(1, 2).contiguous()
                      for t in qkv.chunk(3, dim=-1))
        record("flash_attention_packed", err, ms, pms, span,
               lambda: F.scaled_dot_product_attention(q4, k4, v4),
               4.0 * b * h * n * n * (c // h), 2.0 * b * n * 4 * c)

    log("kernel phase: fused_ln_matmul")
    # SDXL's shapes (eps 1e-5), SAM ViT-H's at B = 4 (eps 1e-6), one ragged
    cases = ((8192, 640, 5120, True, "none", False, 1e-5),
             (2048, 1280, 10240, True, "none", False, 1e-5),
             (4096, 1280, 5120, False, "none", True, 1e-5),
             (4096, 1280, 5120, False, "gelu", True, 1e-5),
             (16384, 1280, 3840, False, "none", True, 1e-6),
             (16384, 1280, 5120, False, "gelu", True, 1e-6),
             (1000, 640, 5120, True, "none", True, 1e-5))
    for m, k, n, geglu, act, with_bias, eps in cases:
        x = randn(m, k)
        w = randn(n, k, scale=k ** -0.5).t()  # (K, N) view of an nn.Linear weight
        gamma = 1.0 + 0.1 * torch.randn(k, generator=gen, device=dev)
        beta = 0.1 * torch.randn(k, generator=gen, device=dev)
        bias = 0.1 * torch.randn(n, generator=gen, device=dev) if with_bias else None
        got = ln_mod.fused_ln_matmul(x, w, gamma, beta, eps, bias, geglu, act)
        ref = ln_mod.ln_matmul_reference(x.float(), w.float(), gamma, beta, eps, bias, geglu, act)
        epi = "geglu" if geglu else act
        err = compare(f"ln_matmul {epi} M={m} K={k} N={n} bias={with_bias} eps={eps}", got, ref)
        ms, pms, span = time_pair(
            lambda: ln_mod.fused_ln_matmul(x, w, gamma, beta, eps, bias, geglu, act),
            lambda: ln_mod.ln_matmul_reference(x.float(), w.float(), gamma, beta, eps,
                                               bias, geglu, act))
        g16, b16, wt = gamma.bfloat16(), beta.bfloat16(), w.t()
        bias16 = None if bias is None else bias.bfloat16()

        def library():
            y = F.linear(F.layer_norm(x, (k,), g16, b16, eps), wt, bias16)
            if geglu:
                hidden, gate = y.chunk(2, dim=-1)
                return hidden * F.gelu(gate)
            return F.gelu(y) if act == "gelu" else y

        cols = n // 2 if geglu else n
        record("fused_ln_matmul", err, ms, pms, span, library, 2.0 * m * k * n,
               2.0 * (m * k + k * n + m * cols) + 8.0 * k + (4.0 * n if with_bias else 0.0))

    log("kernel phase: flash_attention")
    for bh, sq, sk, d, with_bias in ((1, 16384, 16384, 512, False), (4, 1000, 777, 64, True)):
        q, k, v = randn(bh, sq, d), randn(bh, sk, d), randn(bh, sk, d)
        bias = torch.randn((bh, sq, sk), generator=gen, device=dev) if with_bias else None
        got = fa_mod.flash_attention(q, k, v, bias)
        ref = fa_mod.reference_attention(q.float(), k.float(), v.float(), bias)
        err = compare(f"flash BH={bh} Sq={sq} Sk={sk} D={d} bias={with_bias}", got, ref)
        ms, pms, span = time_pair(lambda: fa_mod.flash_attention(q, k, v, bias),
                            lambda: fa_mod.reference_attention(q.float(), k.float(),
                                                               v.float(), bias))
        mask = None if bias is None else bias.bfloat16()[None]
        record("flash_attention", err, ms, pms, span,
               lambda: F.scaled_dot_product_attention(q[None], k[None], v[None], attn_mask=mask),
               4.0 * bh * sq * sk * d,
               2.0 * bh * d * 2 * (sq + sk) + (4.0 * bh * sq * sk if with_bias else 0.0))

    log("kernel phase: flash_attention_relpos")
    # First as ViTAttention calls it in SAM ViT-H's global layers, at B = 4 and
    # B = 1: q, k and v are heads-first views of the fused (B, N, 3, heads, d)
    # projection (row stride 3·heads·d), the result is a view of a (B, N, C)
    # buffer. Then the (BH, N, D) layout at the same sizes, a ragged and a
    # non-square grid. Factors of scale 0.7 so that the bias matters.
    for fused, b, heads, (h, w), d in ((True, 4, 16, (64, 64), 80), (True, 1, 16, (64, 64), 80),
                                       (False, 1, 16, (64, 64), 80), (False, 1, 64, (64, 64), 80),
                                       (True, 2, 3, (5, 7), 80), (False, 1, 2, (5, 7), 80),
                                       (False, 1, 2, (8, 16), 80)):
        n, bh = h * w, b * heads
        if fused:
            qkv = randn(b, n, 3, heads, d)
            q, k, v = (qkv[:, :, s].permute(0, 2, 1, 3) for s in range(3))  # (B, heads, N, d)
        else:
            q, k, v = randn(bh, n, d), randn(bh, n, d), randn(bh, n, d)
        bh_t = randn(bh, h, n, scale=0.7, dtype=torch.float32)
        bw_t = randn(bh, w, n, scale=0.7, dtype=torch.float32)

        def plain():
            flat = (t.reshape(bh, n, d).float() for t in (q, k, v))
            return fa_mod.reference_attention_relpos(*flat, bh_t, bw_t, (h, w))

        got = fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w))
        ref = plain()
        if fused:  # as the module reads it: (B, N, C), and that without a copy
            merged = got.permute(0, 2, 1, 3).reshape(b, n, heads * d)
            if merged.data_ptr() != got.data_ptr() or not merged.is_contiguous():
                raise AssertionError("relpos: the result is not a view of a (B, N, C) buffer")
            got = merged
            ref = ref.reshape(b, heads, n, d).permute(0, 2, 1, 3).reshape(b, n, heads * d)
        layout = "views of fused qkv" if fused else "(BH, N, D)"
        err = compare(f"relpos B={b} heads={heads} grid={h}x{w} D={d} {layout}", got, ref)
        del ref
        ms, pms, span = time_pair(
            lambda: fa_mod.flash_attention_relpos(q, k, v, bh_t, bw_t, (h, w)), plain, reps=3)
        mask = None
        if "flash_attention_relpos" not in results:  # the dense bias, built outside the timing
            mask = (bh_t[:, :, None, :] + bw_t[:, None, :, :]).reshape(bh, n, n)
            mask = mask.transpose(1, 2).bfloat16().contiguous().reshape(b, heads, n, n)
        record("flash_attention_relpos", err, ms, pms, span,
               lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask),
               4.0 * bh * n * n * d, 2.0 * 4 * bh * n * d + 4.0 * bh * (h + w) * n)
        del mask
        torch.cuda.empty_cache()
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

    # a narrow SAM: 8x8 tokens, d = 80, layer 0 windowed, layer 1 global through
    # flash_attention_relpos; both layers through fused_ln_matmul. The plain
    # float32 twin on the CPU uses neither. The relative-position tables are
    # zero-initialised, so they are drawn here, or the bias would not matter.
    from divergen_tpu_torch.pipeline.segmentation.sam import SAM, SAMImageEncoder

    kw = dict(img_size=128, dim=160, layers=2, heads=2, window=4, global_layers=(1,))
    ref_sam = flax_init_(SAM(SAMImageEncoder(**kw)), g).eval()
    with torch.no_grad():
        for name, prm in ref_sam.named_parameters():
            if "rel_pos" in name:
                prm.normal_(0.0, 0.3, generator=g)
    sam = SAM(SAMImageEncoder(dtype=torch.bfloat16, ln_gemm=True, flash_attn=True, device=dev,
                              **kw), device=dev).eval()
    sam.load_state_dict(ref_sam.state_dict())
    imgs = torch.rand((2, 128, 128, 3), generator=g) * 255
    pts = torch.tensor([[10.0, 10], [118, 10], [10, 118], [118, 118]]).expand(2, 4, 2)
    lbl = torch.ones((2, 4), dtype=torch.int32)
    with torch.inference_mode():
        masks, iou = sam(imgs.to(dev), pts.to(dev), lbl.to(dev))
        ref_masks, ref_iou = ref_sam(imgs, pts, lbl)
    compare("small SAM (d=80 relpos attention, fused LN GEMMs) mask logits vs f32 CPU",
            masks.cpu(), ref_masks, rel_l2_bound=3e-2, max_abs_bound=1e-1)
    compare("small SAM IoU vs f32 CPU", iou.cpu(), ref_iou, rel_l2_bound=3e-2,
            max_abs_bound=1e-1)


def slice_txt2img(tmp: str):
    from divergen_tpu_torch.pipeline.generation import txt2img
    from divergen_tpu_torch.utils.png import read_png

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
        img = read_png(os.path.join(out, "samples", "XL", name))
        if img.shape != (1024, 1024, 3):
            raise AssertionError(f"{name}: {img.shape}")
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


SAM_KERNEL_LAUNCHES = {"flash_attention_relpos": 4, "fused_ln_matmul": 36}  # per forward
CATEGORIES = {7: "apple", 11: "chair"}


def count_sam_launches(fn, forwards: int, what: str):
    """Run ``fn`` and require the launches of ``forwards`` SAM ViT-H forwards:
    4 global layers through flash_attention_relpos, 32 fc1 + 4 qkv GEMMs
    through fused_ln_matmul."""
    from divergen_tpu_torch.ops.flash_attention import flash_attention_relpos
    from divergen_tpu_torch.ops.ln_matmul import fused_ln_matmul

    wrappers = (flash_attention_relpos, fused_ln_matmul)
    before = [w.launches for w in wrappers]
    out = fn()
    for w, b0 in zip(wrappers, before):
        want = forwards * SAM_KERNEL_LAUNCHES[w.__name__]
        if w.launches - b0 != want:
            raise AssertionError(f"{what}: {w.__name__} launched {w.launches - b0} times, "
                                 f"expected {want}")
    return out


def slice_corner_masks(tmp: str):
    from divergen_tpu_torch.pipeline.segmentation import corner_masks
    from divergen_tpu_torch.utils.png import read_png

    in_dir = os.path.join(tmp, "out", "samples")  # one category, "XL", two PNGs
    out_dir = os.path.join(tmp, "masks")
    t0 = time.perf_counter()
    rc = count_sam_launches(
        lambda: corner_masks.main(["--in_dir", in_dir, "--out_dir", out_dir, "--model_type",
                                   "vit_h", "--batch", "4", "--img_size", "1024"]),
        1, "corner_masks.main")
    torch.cuda.synchronize()
    if rc != 0:
        raise AssertionError(f"corner_masks.main returned {rc}")
    fracs = []
    for name in ("7_0000000.png", "7_0000001.png"):
        m = read_png(os.path.join(out_dir, "XL", name))
        if m.shape != (1024, 1024) or not np.isin(m, (0, 255)).all():
            raise AssertionError(f"mask {name}: shape {m.shape}, values {np.unique(m)[:4]}")
        fracs.append(float((m == 255).mean()))
    log(f"  corner_masks.main wrote 2 masks (1024x1024, values in {{0, 255}}, instance "
        f"fractions {fracs[0]:.3f}, {fracs[1]:.3f}) in {time.perf_counter() - t0:.1f} s "
        f"(model build included)")


def slice_chain(encoder, pipe, card: str):
    """One producer round gen → SAM → CLIP into the pool, then the compositor.
    Returns the function that takes the smoke timings of SAM, CLIP and the
    compositor, to be called once the launch counts have been read."""
    from divergen_tpu_torch.modeling.text.clip import preprocess_images
    from divergen_tpu_torch.modeling.text.tokenizer import SimpleTokenizer
    from divergen_tpu_torch.ops.copy_paste import paste_instances_boxframe
    from divergen_tpu_torch.pipeline.filteration.core import ClipEncoder, clip_preprocess_np
    from divergen_tpu_torch.pipeline.generation.pipeline import images_to_uint8
    from divergen_tpu_torch.pipeline.orchestrator import InstanceProducer, LivePool
    from divergen_tpu_torch.pipeline.segmentation import corner_masks

    dev = torch.device("cuda")
    args = corner_masks.build_argparser().parse_args(["--in_dir", "-", "--out_dir", "-"])
    sam = corner_masks.build_sam(args, dev)  # SAM.vit_h(bf16, ln_gemm, flash_attn)
    batch, size = args.batch, args.img_size
    pts = torch.from_numpy(np.tile(corner_masks.corner_points(size, args.corner_margin),
                                   (batch, 1, 1))).to(dev)
    lbl = torch.ones((batch, 4), dtype=torch.int32, device=dev)
    clip = ClipEncoder("ViT-L/14", batch=16, device=dev)
    tokenizer = SimpleTokenizer(merges=[])
    unc, unc_pooled = encoder.encode([""] * 2)
    gen = torch.Generator(device=dev)
    errors = []

    def guarded(fn):
        def run(*a):
            try:
                return fn(*a)
            except BaseException as e:  # the producer is a thread: keep the error
                errors.append(e)
                raise
        return run

    def generate_fn(cat, rng):
        ctx, pooled = encoder.encode([f"a photo of a single {CATEGORIES[cat]}"] * 2)
        imgs = pipe.generate(gen.manual_seed(int(rng.integers(2**31))), ctx, unc, pooled,
                             unc_pooled, size, size)
        return np.stack(images_to_uint8(imgs))

    def mask_fn(images):
        x = torch.zeros((batch, size, size, 3), device=dev)
        x[: len(images)] = torch.from_numpy(images).to(dev)
        inst = count_sam_launches(
            lambda: corner_masks.predict_instance_masks(sam, x, pts, lbl), 1, "mask_fn")
        return inst[: len(images)].cpu().numpy()

    def score_fn(images, masks, cat):
        white = np.where(masks[..., None], images, 255).astype(np.uint8)
        feats = clip.encode_images(np.stack([clip_preprocess_np(im) for im in white]))
        text = clip.encode_texts(tokenizer.tokenize([f"a photo of a single {CATEGORIES[cat]}"]))
        return (feats @ text.T)[:, 0]

    pool = LivePool(patch_size=128, train_size=(896, 896), max_samples=20)
    # random weights: any score and any non-empty mask is accepted
    prod = InstanceProducer(pool, list(CATEGORIES), guarded(generate_fn), guarded(mask_fn),
                            guarded(score_fn), clip_threshold=-1.0, area_range=(0.0, 1.01),
                            max_rounds=1)
    t0 = time.perf_counter()
    prod.start()
    prod.join(timeout=600)
    torch.cuda.synchronize()
    if errors:
        raise errors[0]
    if prod.is_alive() or prod.produced + prod.rejected != 2 * len(CATEGORIES):
        raise AssertionError(f"producer: alive {prod.is_alive()}, produced {prod.produced}, "
                             f"rejected {prod.rejected}")
    if prod.produced == 0:
        raise AssertionError("producer: every instance mask was empty")
    log(f"  InstanceProducer round: produced {prod.produced}, rejected {prod.rejected} "
        f"(empty masks), pool {pool.counts()} in {time.perf_counter() - t0:.1f} s")

    b, p, n, s, hw = 8, 4, 8, 28, 896
    rng = np.random.default_rng(0)
    samples = [pool.make_paste_sample(rng, max_pastes=p) for _ in range(b)]
    n_pastes = int(sum(smp["patch_valid"].sum() for smp in samples))
    stack = lambda key: torch.from_numpy(np.stack([smp[key] for smp in samples])).to(dev)
    g = torch.Generator(device=dev).manual_seed(3)
    paste_args = (
        torch.rand((b, hw, hw, 3), generator=g, device=dev) * 255,
        torch.ones((b, n, s, s), device=dev),
        torch.tensor([100.0, 100.0, 300.0, 300.0], device=dev).expand(b, n, 4),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
        torch.ones((b, n), dtype=torch.bool, device=dev),
        torch.zeros((b, n), dtype=torch.int32, device=dev),
        stack("patches"), stack("patch_boxes"), stack("patch_classes"), stack("patch_valid"),
        stack("patch_flip"),
    )
    out = paste_instances_boxframe(*paste_args)
    torch.cuda.synchronize()
    shapes = {"image": (b, hw, hw, 3), "masks": (b, n + p, s, s), "boxes": (b, n + p, 4),
              "classes": (b, n + p), "valid": (b, n + p), "instance_source": (b, n + p)}
    for key, shape in shapes.items():
        if tuple(out[key].shape) != shape:
            raise AssertionError(f"paste {key}: {tuple(out[key].shape)} != {shape}")
        if out[key].is_floating_point() and not torch.isfinite(out[key]).all():
            raise AssertionError(f"paste {key}: non-finite")
    pasted = int(out["valid"][:, n:].sum())
    if n_pastes == 0 or pasted == 0:
        raise AssertionError(f"paste: {n_pastes} patches sampled, {pasted} valid after pasting")
    log(f"  paste_instances_boxframe: B={b} P={p} N={n} S={s} at {hw}²; {n_pastes} patches "
        f"sampled from the pool, {pasted} valid after pasting")

    def wall(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    def chain_timings():
        imgs = torch.rand((batch, size, size, 3), generator=g, device=dev) * 255
        with torch.inference_mode():
            sam_s = statistics.median(wall(lambda: sam(imgs, pts, lbl)) for _ in range(3))
            x16 = preprocess_images(torch.rand((16, 224, 224, 3), generator=g, device=dev) * 255)
            clip.vision(x16)  # warm-up at this batch
            clip_s = statistics.median(wall(lambda: clip.vision(x16)) for _ in range(3))
        paste_s = statistics.median(wall(lambda: paste_instances_boxframe(*paste_args))
                                    for _ in range(3))
        log(f"  SAM ViT-H forward (B={batch}, 1024², bf16, fused encoder): "
            f"{sam_s / batch:.4f} s/image, median of 3 [{card}]")
        log(f"  CLIP ViT-L/14 vision (B=16, 224², float32): {1000 * clip_s / 16:.3f} "
            f"ms/image, median of 3 [{card}]")
        log(f"  compositor (B={b} x P={p} at {hw}²): {1000 * paste_s / (b * p):.3f} ms per "
            f"pasted instance, median of 3 [{card}]")

    return chain_timings


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from divergen_tpu_torch.ops import _build
    from divergen_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_attention_packed,
        flash_attention_relpos,
    )
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

    wrappers = (flash_attention_packed, fused_ln_matmul, flash_attention,
                flash_attention_relpos)

    def reset():
        for w in wrappers:
            w.launches = 0

    def read(path_kernels, what):
        counts = {w.__name__: w.launches for w in wrappers}
        log(f"  kernel launches in {what}: {counts}")
        missing = [w.__name__ for w in path_kernels if w.launches == 0]
        if missing:
            raise AssertionError(f"kernels not launched in {what}: {missing}")
        return counts

    with tempfile.TemporaryDirectory() as tmp:
        log("slice: full-width SDXL")
        reset()
        slice_txt2img(tmp)
        torch.cuda.empty_cache()
        encoder, pipe, cond = slice_pipeline()
        sdxl = read((flash_attention_packed, fused_ln_matmul, flash_attention), "the SDXL slice")
        timings(encoder, pipe, cond, card)

        log("slice: instance chain at full width (SAM ViT-H, CLIP ViT-L/14, compositor)")
        reset()
        slice_corner_masks(tmp)
    torch.cuda.empty_cache()
    chain_timings = slice_chain(encoder, pipe, card)
    chain = read(wrappers, "the instance-chain slice")
    chain_timings()
    launches = {name: sdxl[name] + chain[name] for name in sdxl}

    sources = {
        "flash_attention_packed": ("divergen_tpu_torch/csrc/flash_attention.cu",
                                   "divergen_tpu/ops/pallas/flash_attention.py:337"),
        "fused_ln_matmul": ("divergen_tpu_torch/csrc/ln_matmul.cu",
                            "divergen_tpu/ops/pallas/ln_matmul.py:127"),
        "flash_attention": ("divergen_tpu_torch/csrc/flash_attention.cu",
                            "divergen_tpu/ops/pallas/flash_attention.py:146"),
        "flash_attention_relpos": ("divergen_tpu_torch/csrc/flash_attention.cu",
                                   "divergen_tpu/ops/pallas/flash_attention.py:531"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src, "replaces": rep,
                "launches": launches[name], **results[name]}
               for name, (src, rep) in sources.items()]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
