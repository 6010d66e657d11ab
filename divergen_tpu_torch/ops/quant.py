"""W8A8 dynamic int8 quantization of dense layers (torch).

Counterpart of ``divergen_tpu/ops/quant.py``, with its formulas kept exactly:

* weights: per-output-channel absmax scales, ``max(absmax / 127, 1e-12)``,
  quantized once per generate call (``pipeline.SDXLPipeline(int8=True)``);
* activations: per-row absmax scales with the same formula;
* values: ``round(x / scale)`` (a true division, round half to even) clipped
  to ±127;
* the product: int8 × int8 summed in int32, dequantized by the row scale
  times the column scale.

:func:`int8_matmul` dispatches as the JAX function does on its accelerator:
shapes that ``supported_fused_quant`` admits go to ``int8_matmul_fused_quant``
(activation quantization inside the kernel); every other shape is quantized
here and goes to ``int8_matmul_pallas``. The JAX package sends what neither of
its Pallas kernels tiles (the cross-attention ``attn2_kv``, M = 4 · 77) to
XLA's int32 ``dot_general``; the port's kernel takes a ragged M, so that GEMM
launches it too, computing the same exact int32 sums. Both wrappers run their
plain versions for CPU tensors.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .int8_matmul import (
    int8_matmul_fused_quant,
    int8_matmul_pallas,
    per_127,
    supported_fused_quant,
)


def quantize_weight(w: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(in, out) float → (int8 (in, out), f32 (out,) scale). Symmetric
    per-output-channel absmax."""
    w = w.float()
    scale = per_127(w.abs().amax(dim=0)).clamp_min(1e-12)
    q = torch.round(w / scale[None, :]).clamp(-127, 127).to(torch.int8)
    return q, scale


def quantize_act(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., in) float → int8 + per-row f32 scale (..., 1). Symmetric absmax."""
    ax = x.float()
    scale = per_127(ax.abs().amax(dim=-1, keepdim=True)).clamp_min(1e-12)
    q = torch.round(ax / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def int8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """x (..., in) float; w_q int8 (in, out); w_scale f32 (out,); returns
    (..., out) in ``out_dtype``. ``w_q`` may be the transpose view of an
    (out, in) buffer, which is the layout the kernels read."""
    if w_q.dtype != torch.int8:
        raise ValueError(f"int8_matmul needs int8 weights, got {w_q.dtype}: the layer "
                         "was not run through quantize_unet_ (or was cast after it)")
    lead = x.shape[:-1]
    k, n = w_q.shape
    if x.shape[-1] != k:
        raise ValueError(f"x {tuple(x.shape)} and w_q {tuple(w_q.shape)} do not chain")
    m = 1
    for s in lead:
        m *= s
    x2 = x.reshape(m, k)
    if supported_fused_quant(m, k, n):
        out = int8_matmul_fused_quant(x2, w_q, w_scale, out_dtype=out_dtype)
    else:
        x_q, x_scale = quantize_act(x2)
        out = int8_matmul_pallas(x_q, x_scale, w_q, w_scale, out_dtype=out_dtype)
    return out.reshape(*lead, n)


def quantize_param_tree(params: Dict, select: Optional[Callable[[Tuple[str, ...]], bool]] = None
                        ) -> Dict:
    """Replace 2-D ``kernel`` entries of a flax-style nested dict with int8
    ``kernel_q`` + f32 ``kernel_scale`` wherever ``select(path)`` is True
    (default: every 2-D kernel), as the JAX function does. Modules keep
    their float weights; :func:`..pipeline.generation.unet.quantize_unet_` is
    the module form."""

    def walk(node, path: Tuple[str, ...]):
        if not isinstance(node, dict):
            return node
        kernel = node.get("kernel")
        if kernel is not None and getattr(kernel, "ndim", 0) == 2 and (
                select is None or select(path)):
            q, s = quantize_weight(torch.as_tensor(kernel))
            out = {key: v for key, v in node.items() if key != "kernel"}
            out["kernel_q"] = q
            out["kernel_scale"] = s
            return out
        return {key: walk(v, path + (key,)) for key, v in node.items()}

    return walk(params, ())


def dense_apply(node: Dict, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A dense layer from a raw param node holding either a float ``kernel``
    or a quantized ``kernel_q`` / ``kernel_scale`` pair."""
    if "kernel_q" in node:
        y = int8_matmul(x, node["kernel_q"], node["kernel_scale"], out_dtype=dtype)
    else:
        y = x.to(dtype) @ torch.as_tensor(node["kernel"]).to(dtype)
    if "bias" in node:
        y = y + torch.as_tensor(node["bias"]).to(dtype)
    return y

