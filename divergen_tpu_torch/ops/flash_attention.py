"""Flash attention: hand-written CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/flash_attention.py``:
``flash_attention`` ((BH, S, D), optional dense bias) and
``flash_attention_packed`` (self-attention straight out of a fused
(B, N, 3C) QKV projection). Both launch ``csrc/flash_attention.cu`` for a
CUDA tensor and use the plain version in this module, the numerics reference,
for a CPU tensor. A CUDA tensor the kernel cannot take raises.

Each wrapper counts its kernel launches in a plain int attribute
(``flash_attention.launches``, ``flash_attention_packed.launches``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

KERNEL_HEAD_DIMS = (64, 512)  # head dims the kernel is instantiated for
SOFTMAX_MODES = ("exact", "rawmax")  # the same math; the TPU's bf16exp is not ported


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain softmax attention, q/k/v (BH, S, D): products in f32, P cast to
    v's dtype before the P@V product, output in q's dtype."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / math.sqrt(d)
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def reference_attention_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain self-attention on fused QKV (B, N, 3C) → (B, N, C)."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    qh, kh, vh = (qkv[..., s * heads * d:(s + 1) * heads * d].reshape(b, n, heads, d)
                  for s in range(3))
    s = torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float()) / math.sqrt(d)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", p.to(vh.dtype).float(), vh.float())
    return out.to(qkv.dtype).reshape(b, n, heads * d)


def _require_kernel_input(name: str, t: torch.Tensor, d: int) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned data")
    if d not in KERNEL_HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel (instantiated: {KERNEL_HEAD_DIMS})")


def _launch(q_ptr, k_ptr, v_ptr, bias, out, batch, heads, sq, sk, d,
            q_strides, kv_strides, o_strides, bias_strides, device) -> None:
    lib = _build.lib()
    code = lib.dg_flash_attention_bf16(
        q_ptr, k_ptr, v_ptr, None if bias is None else bias.data_ptr(),
        out.data_ptr(), batch, heads, sq, sk, d,
        *q_strides, *kv_strides, *o_strides, *bias_strides,
        1.0 / math.sqrt(d), torch.cuda.current_stream(device).cuda_stream,
    )
    _build.check(code, "flash attention kernel launch")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (BH, S, D): q (BH, Sq, D), k/v (BH, Sk, D), optional
    bias broadcastable to (BH, Sq, Sk). Keys are never padded in memory: the
    kernel masks the ragged last K tile by index."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, bias)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if sq == 0 or sk == 0:
        raise ValueError("empty sequence")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_kernel_input(name, t, d)
    bias_strides = (0, 0, 0)
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).expand(bh, sq, sk)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
        bias_strides = (bias.stride(0), 0, bias.stride(1))
    out = torch.empty_like(q)
    flash_attention.launches += 1
    _launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), bias, out, bh, 1, sq, sk, d,
            (sq * d, 0, d), (sk * d, 0, d), (sq * d, 0, d), bias_strides, q.device)
    return out


flash_attention.launches = 0


def flash_attention_packed(qkv: torch.Tensor, heads: int,
                           softmax_mode: str = "exact") -> torch.Tensor:
    """Self-attention on a fused QKV projection, (B, N, 3C) → (B, N, C).

    The channel axis is [q | k | v], H·d channels each; head h of slot s is
    channels [s·C + h·d, s·C + (h+1)·d). The kernel reads q, k and v from
    ``qkv`` by stride and writes (B, N, C) directly: no transpose on either
    side. ``softmax_mode`` is ``"exact"`` or ``"rawmax"``, which are the same
    math (the TPU kernel's two orderings of the scale and the running max)."""
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"softmax_mode {softmax_mode!r} not in {SOFTMAX_MODES}")
    b, n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"channels {c3} do not split into 3 x {heads} heads")
    if qkv.device.type == "cpu":
        return reference_attention_packed(qkv, heads)
    c = c3 // 3
    d = c // heads
    _require_kernel_input("qkv", qkv, d)
    out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
    ptr = qkv.data_ptr()
    esz = qkv.element_size()
    flash_attention_packed.launches += 1
    _launch(ptr, ptr + c * esz, ptr + 2 * c * esz, None, out, b, heads, n, n, d,
            (n * c3, d, c3), (n * c3, d, c3), (n * c, d, c), (0, 0, 0), qkv.device)
    return out


flash_attention_packed.launches = 0
