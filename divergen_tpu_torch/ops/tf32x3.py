"""The numerical scheme of the float32 kernels, in plain torch: float32
products on the TF32 tensor cores in three passes ("3xTF32").

Each float32 operand x is held as two TF32 numbers, ``big = tf32(x)`` and
``small = tf32(x - big)``, both rounded to nearest with ties away from zero,
as the card's ``cvt.rna.tf32.f32`` rounds (TF32 keeps float32's exponent and
the top 10 bits of its mantissa; the low 13 bits are clear). ``x - big`` is
exact in float32. A product is then taken as ``a_small·b_big + a_big·b_small
+ a_big·b_big`` with float32 sums: what it leaves out, ``a_small·b_small``
and the rounding of ``small``, is about 2⁻²¹ relative to ``a·b``, the order
of float32's own sums. One pass, ``a_big·b_big``, is about 2⁻¹¹ relative: a
different result, not a float32 one.

The kernels that take it: ``csrc/attention_f32.cu`` (``mma.sync`` m16n8k8,
the split in registers) and ``csrc/ln_matmul.cu``'s float32 GEMM (``wgmma``,
both parts of each operand in shared memory). The window backward of
``attention_f32.cu`` splits by :func:`split_tf32_fast`: ``big`` as above,
``small`` left for the tensor core to truncate (it reads the top 19 bits of
a register), which saves two conversions and costs at most 2⁻²¹ relative.
This module is their CPU emulation, for the tests; no wrapper calls it.
"""
from __future__ import annotations

from typing import Tuple

import torch

MANTISSA_DROPPED = 13  # float32 keeps 23 mantissa bits, TF32 10
_HALF = 1 << (MANTISSA_DROPPED - 1)
_KEEP = -(1 << MANTISSA_DROPPED)  # 0xFFFFE000 as an int32


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32 as ``cvt.rna`` does: half of the last
    kept unit added to the magnitude's bit pattern, the low 13 bits cleared.
    Inf and NaN pass unchanged."""
    if x.dtype != torch.float32:
        raise ValueError(f"round_tf32 takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    rounded = ((bits + _HALF) & _KEEP).view(torch.float32)
    return torch.where(torch.isfinite(x), rounded, x)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with ``big = tf32(x)`` and ``small = tf32(x - big)``."""
    big = round_tf32(x)
    return big, round_tf32(x - big)


def truncate_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) as the tensor core reads a register that holds it: the
    low 13 bits dropped."""
    return (x.contiguous().view(torch.int32) & _KEEP).view(torch.float32)


def split_tf32_fast(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) as the float32 window backward forms them
    (``csrc/attention_f32.cu:split_fast``): ``big = tf32(x)`` rounded, and
    ``small = x - big`` as the tensor core reads it, truncated."""
    big = round_tf32(x)
    return big, truncate_tf32(x - big)


def matmul_3xtf32_reference(a: torch.Tensor, b: torch.Tensor, split=split_tf32) -> torch.Tensor:
    """``a @ b`` as the kernels take it: each product in three TF32 passes,
    the small terms first, float32 sums, the operands split by ``split``. The
    TF32 parts multiply exactly in float32 (11 significant bits each), so a
    float32 product of the parts is what the tensor core forms."""
    a_big, a_small = split(a)
    b_big, b_small = split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def matmul_1xtf32_reference(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in one TF32 pass: what the kernels do NOT take."""
    return round_tf32(a) @ round_tf32(b)


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                        matmul=matmul_3xtf32_reference) -> torch.Tensor:
    """Softmax attention over (..., S, d) with both products taken by
    ``matmul``: the scale applied to the float32 score after the product, as
    ``csrc/attention_f32.cu`` does."""
    s = matmul(q, k.transpose(-1, -2)) * scale
    p = torch.softmax(s, dim=-1)
    return matmul(p, v)
