"""Which CUDA body an attention wrapper launches, and the launch of the
float32 body (``csrc/attention_f32.cu``).

The five attention kernels of ``flash_attention.py`` and
``window_attention.py`` take bfloat16 or float32, as their Pallas kernels
take the input's dtype. bf16 runs each kernel's own body; float32 runs one
float32 body for all of them, whose score bias is a policy (none, dense,
relative position, window), and whose products are float32 FMAs: no operand
is rounded to bf16. :func:`body_for` is the dispatch, a pure function of the
dtype, head dim and bias; any other dtype raises.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import _build

F32_HEAD_DIMS = (32, 64, 80, 512)
BIAS_MODES = {"none": 0, "dense": 1, "relpos": 2, "window": 3}
# the bf16 body of each (bias mode, head dim)
BF16_BODIES = {("none", 64): "dg_flash_attention_sm90", ("dense", 64): "dg_flash_attention_sm90",
               ("none", 512): "dg_flash_attention_d512", ("dense", 512): "dg_flash_attention_d512",
               ("relpos", 80): "dg_flash_attention_relpos_bf16",
               ("window", 32): "dg_window_attention_bf16"}


def body_for(dtype: torch.dtype, d: int, bias_mode: str) -> str:
    """The C entry point that computes attention of head dim ``d`` with the
    score bias ``bias_mode`` on ``dtype`` q, k and v: the float32 body for
    float32, the kernel's bf16 body for bfloat16. Raises on any other dtype
    and on a head dim that has no body."""
    if bias_mode not in BIAS_MODES:
        raise ValueError(f"bias mode {bias_mode!r} not in {tuple(BIAS_MODES)}")
    if dtype == torch.float32:
        if d not in F32_HEAD_DIMS:
            raise ValueError(f"head dim {d} has no float32 kernel (instantiated: {F32_HEAD_DIMS})")
        return "dg_attention_f32"
    if dtype != torch.bfloat16:
        raise ValueError(f"the kernel takes bfloat16 or float32, got {dtype}")
    body = BF16_BODIES.get((bias_mode, d))
    if body is None:
        dims = tuple(dd for mode, dd in BF16_BODIES if mode == bias_mode)
        raise ValueError(f"head dim {d} has no kernel (instantiated: {dims})")
    return body


def launch(q: torch.Tensor, k_ptr: int, v_ptr: int, out: torch.Tensor, *, batch: int,
           heads: int, sq: int, sk: int, d: int, q_strides: Sequence[int],
           kv_strides: Sequence[int], o_strides: Sequence[int], bias_mode: str = "none",
           bias: Optional[torch.Tensor] = None, bias2: Optional[torch.Tensor] = None,
           bias_strides: Sequence[int] = (0, 0, 0), grid=(0, 0), nw: int = 1,
           scale: float = 1.0) -> torch.Tensor:
    """The float32 body on checked CUDA float32 operands: q from ``q`` (its
    data pointer), k and v at the given addresses, all (batch, head, row)
    strided with a unit channel stride, k and v sharing ``kv_strides``; into
    ``out`` at ``o_strides``. ``bias`` and ``bias2`` as ``bias_mode`` reads
    them (``csrc/attention_f32.cu:dg_attention_f32``)."""
    code = _build.lib().dg_attention_f32(
        q.data_ptr(), k_ptr, v_ptr, out.data_ptr(), None if bias is None else bias.data_ptr(),
        None if bias2 is None else bias2.data_ptr(), BIAS_MODES[bias_mode], d, batch, heads,
        sq, sk, *q_strides, *kv_strides, *o_strides, *bias_strides, *grid, nw, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, f"float32 attention ({bias_mode} bias, d = {d}) kernel launch")
    return out
