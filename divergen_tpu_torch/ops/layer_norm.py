"""Row LayerNorm: hand-written CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/layer_norm.py:fused_layer_norm``:
over the last axis, in f32, ``mean``, then the centred variance
``mean((x − mean)²)``, then ``(x − mean) · rsqrt(var + eps) · gamma + beta``
in x's dtype. For a CUDA tensor it launches ``csrc/layer_norm.cu`` (bf16 or
f32, any C); for a CPU tensor it runs :func:`layer_norm_reference`. A CUDA tensor
the kernel cannot take raises. Launches are counted in
``fused_layer_norm.launches``.

The gradient recomputes through :func:`layer_norm_reference`, as the JAX
``custom_vjp`` does: there is no backward kernel.
"""
from __future__ import annotations

import torch

from . import _build


def layer_norm_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                         eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(dim=-1, keepdim=True)
    y = xc * torch.rsqrt(var + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def _launch(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float) -> torch.Tensor:
    c = x.shape[-1]
    if x.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"fused_layer_norm: the kernel takes bfloat16 or float32, got {x.dtype}")
    if gamma.device != x.device or beta.device != x.device:
        raise ValueError(f"fused_layer_norm: x on {x.device}, gamma on {gamma.device}, "
                         f"beta on {beta.device}")
    if gamma.shape != (c,) or beta.shape != (c,) or x.numel() == 0:
        raise ValueError(f"fused_layer_norm: x {tuple(x.shape)}, gamma {tuple(gamma.shape)}, "
                         f"beta {tuple(beta.shape)}")
    x2 = x.reshape(-1, c).contiguous()
    if x2.data_ptr() % 16:
        raise ValueError("fused_layer_norm: the kernel needs a 16-byte aligned x")
    f32 = dict(device=x.device, dtype=torch.float32)
    gamma = gamma.to(**f32).contiguous()
    beta = beta.to(**f32).contiguous()
    out = torch.empty_like(x2)
    lib = _build.lib()
    fused_layer_norm.launches += 1
    code = lib.dg_layer_norm(x2.data_ptr(), gamma.data_ptr(), beta.data_ptr(), out.data_ptr(),
                             x2.shape[0], c, eps, int(x.dtype == torch.float32),
                             torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "layer norm kernel launch")
    return out.reshape(x.shape)


class _FusedLayerNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, eps):
        ctx.save_for_backward(x, gamma, beta)
        ctx.eps = eps
        if x.device.type == "cpu":
            return layer_norm_reference(x, gamma, beta, eps)
        if x.device.type != "cuda":
            raise ValueError(f"fused_layer_norm: x on {x.device}; the kernel needs CUDA")
        return _launch(x, gamma, beta, eps)

    @staticmethod
    def backward(ctx, gout):
        x, gamma, beta = (t.detach().requires_grad_(True) for t in ctx.saved_tensors)
        with torch.enable_grad():
            y = layer_norm_reference(x, gamma, beta, ctx.eps)
        gx, gg, gb = torch.autograd.grad(y, (x, gamma, beta), gout)
        return gx, gg, gb, None


def fused_layer_norm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis. x (..., C); gamma, beta (C,)."""
    return _FusedLayerNorm.apply(x, gamma, beta, eps)


fused_layer_norm.launches = 0
