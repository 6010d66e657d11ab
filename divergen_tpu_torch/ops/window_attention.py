"""Swin window attention: hand-written CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/window_attention.py``, forward only:
``fused_window_attention_packed`` reads q, k and v straight out of the fused
(bn, n, 3C) projection and writes (bn, n, C); ``fused_window_attention`` takes
split (B, H, N, D) tensors. Both compute, per window b and head h,

    softmax(q·kᵀ·d^-½ + bias[h] + mask[b % nW]) · v

with the scale applied to the float32 scores after the product, the
probabilities cast to v's dtype before the second product and the result in
the input's dtype. Both launch ``csrc/window_attention.cu`` for a CUDA tensor
and use the plain version in this module, the numerics reference, for a CPU
tensor. A CUDA tensor the kernel cannot take raises: bfloat16, head dim 32 and
1 ≤ n ≤ 144 only, any head count (there is no lane rule, so six heads take the
packed kernel like any other count).

The JAX kernels carry a ``custom_vjp``; the backward kernels are not ported
yet, so on a CUDA tensor both wrappers raise ``NotImplementedError`` when a
gradient is asked for instead of letting autograd run through the plain
version.

Each wrapper counts its kernel launches in a plain int attribute
(``fused_window_attention_packed.launches``, ``fused_window_attention.launches``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from . import _build

KERNEL_HEAD_DIM = 32  # every Swin variant's head dim
KERNEL_MAX_TOKENS = 144  # a 12 x 12 window; the scores of a row stay in registers


def reference_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor,
                               mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain window attention: q/k/v (B, H, N, D), bias (H, N, N), mask
    (nW, N, N) or None with window b taking ``mask[b % nW]``. Products in
    float32, P cast to v's dtype before P·V, output in q's dtype."""
    b, h, n, d = q.shape
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * (1.0 / math.sqrt(d))
    s = s + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(b // nw, nw, h, n, n) + mask.float()[None, :, None]).reshape(b, h, n, n)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def reference_window_attention_packed(qkv: torch.Tensor, bias: torch.Tensor,
                                      mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """Plain window attention on fused QKV (bn, n, 3C) → (bn, n, C); the
    channel axis is [q | k | v], head-major inside each."""
    bn, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = (qkv[..., s * c:(s + 1) * c].reshape(bn, n, heads, d).permute(0, 2, 1, 3)
               for s in range(3))
    out = reference_window_attention(q, k, v, bias, mask)
    return out.permute(0, 2, 1, 3).reshape(bn, n, c)


def _check_bias_mask(bias: torch.Tensor, mask: Optional[torch.Tensor], batch: int,
                     heads: int, n: int) -> None:
    if bias.shape != (heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({heads}, {n}, {n})")
    if mask is not None:
        if mask.dim() != 3 or mask.shape[1:] != (n, n):
            raise ValueError(f"mask {tuple(mask.shape)} is not (nW, {n}, {n})")
        if batch % mask.shape[0]:
            raise ValueError(f"{batch} windows do not cycle over a mask of {mask.shape[0]}")


def _require_kernel_input(name: str, t: torch.Tensor, n: int, d: int, strided: bool) -> None:
    """Raise on a non-CPU tensor the kernel cannot take. The device is checked
    last, so the other rules can be exercised without a card (a ``meta``
    tensor reaches them)."""
    if t.dtype != torch.bfloat16:
        raise ValueError(f"{name}: the kernel takes bfloat16, got {t.dtype}")
    if d != KERNEL_HEAD_DIM:
        raise ValueError(f"head dim {d} has no kernel (instantiated: {KERNEL_HEAD_DIM})")
    if not 1 <= n <= KERNEL_MAX_TOKENS:
        raise ValueError(f"{n} tokens per window: the kernel takes 1 to {KERNEL_MAX_TOKENS}")
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError("backward not yet ported")
    if strided:
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{name}: the kernel takes a unit last stride and other "
                             f"strides that are multiples of 8, got {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned data")


def _f32_on(t: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    if torch.is_grad_enabled() and t.requires_grad:
        raise NotImplementedError("backward not yet ported")
    return t.to(device=device, dtype=torch.float32).contiguous()


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window attention on split q/k/v (B, H, N, D) → (B, H, N, D) with bias
    (H, N, N) and an optional mask (nW, N, N), B a multiple of nW.

    q, k and v may be strided views with a unit last stride (for example the
    heads-first slices of a fused (B, N, 3, H, D) projection); k and v must
    share strides. The result is contiguous."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, h, n, d = q.shape
    _check_bias_mask(bias, mask, b, h, n)
    if q.device.type == "cpu":
        return reference_window_attention(q, k, v, bias, mask)
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_kernel_input(name, t, n, d, strided=True)
    if k.stride() != v.stride():
        raise ValueError(f"k and v must share strides, got {k.stride()} and {v.stride()}")
    bias = _f32_on(bias, q.device)
    mask = _f32_on(mask, q.device)
    out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
    fused_window_attention.launches += 1
    code = _build.lib().dg_window_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
        None if mask is None else mask.data_ptr(), out.data_ptr(),
        b, h, n, 1 if mask is None else mask.shape[0],
        *q.stride()[:3], *k.stride()[:3], *out.stride()[:3],
        1.0 / math.sqrt(d), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, "window attention kernel launch")
    return out


fused_window_attention.launches = 0


def fused_window_attention_packed(qkv: torch.Tensor, bias: torch.Tensor,
                                  mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """Window attention on a fused QKV projection, (bn, n, 3C) → (bn, n, C).

    The channel axis is [q | k | v], H·d channels each; head h of slot s is
    channels [s·C + h·d, s·C + (h+1)·d). bias is (H, n, n), mask (nW, n, n)
    or None with bn a multiple of nW. The kernel reads q, k and v from ``qkv``
    by stride and writes (bn, n, C) directly: no transpose on either side."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (bn, n, 3C)")
    bn, n, c3 = qkv.shape
    if heads < 1 or c3 % (3 * heads):
        raise ValueError(f"channels {c3} do not split into 3 x {heads} heads")
    _check_bias_mask(bias, mask, bn, heads, n)
    if qkv.device.type == "cpu":
        return reference_window_attention_packed(qkv, bias, mask, heads)
    c = c3 // 3
    _require_kernel_input("qkv", qkv, n, c // heads, strided=False)
    bias = _f32_on(bias, qkv.device)
    mask = _f32_on(mask, qkv.device)
    out = torch.empty((bn, n, c), dtype=qkv.dtype, device=qkv.device)
    fused_window_attention_packed.launches += 1
    code = _build.lib().dg_window_attention_packed_bf16(
        qkv.data_ptr(), bias.data_ptr(), None if mask is None else mask.data_ptr(),
        out.data_ptr(), bn, n, heads, 1 if mask is None else mask.shape[0],
        1.0 / math.sqrt(c // heads), torch.cuda.current_stream(qkv.device).cuda_stream)
    _build.check(code, "packed window attention kernel launch")
    return out


fused_window_attention_packed.launches = 0
