"""Text→image pipeline: the CFG denoise loop and the VAE decode (torch).

Counterpart of ``divergen_tpu/pipeline/generation/pipeline.py``. The JAX
``lax.scan`` over steps is a Python loop here; each step runs the UNet once
on the 2B-image batch [uncond | cond] and combines the two halves with the
guidance scale. Both samplers are ported: Euler (SDXL's default) and
DPM-Solver++ 2M. Decoding runs one image at a time, as at 1024² the
decoder's full-resolution activations dominate memory. With
``encoder_reuse`` (Faster-Diffusion, arXiv:2312.09608) even steps run the
whole UNet and keep its down path's features; odd steps run only mid + up on
them with the new timestep, under either sampler. With ``int8`` the
UNet (built with ``quant=True``) holds float weights and quantizes its
transformer matmuls once per ``denoise`` call, before the step loop, as the
JAX pipeline quantizes its parameter tree once per generate call.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .scheduler import (
    SchedulerConfig,
    dpmpp_2m_step,
    dpmpp_init_noise_scale,
    dpmpp_timesteps_sigmas,
    euler_init_noise_scale,
    euler_scale_input,
    euler_sigmas,
    euler_step,
    make_scheduler,
)
from .unet import UNetSDXL, quantize_unet_
from .vae import VAEDecoder


class SDXLPipeline:
    """UNet + VAE decoder + sampler; the modules carry their weights."""

    def __init__(self, unet: UNetSDXL, vae: Optional[VAEDecoder] = None,
                 scheduler: Optional[SchedulerConfig] = None, steps: int = 50,
                 guidance_scale: float = 7.5, encoder_reuse: bool = False,
                 int8: bool = False, mesh=None, sampler: str = "euler"):
        if mesh is not None:
            raise NotImplementedError("mesh (a sharded batch) is not ported yet")
        if sampler not in ("euler", "dpmpp_2m"):
            raise ValueError(f"unknown sampler {sampler!r}")
        if int8 and not unet.quant:
            raise ValueError("int8=True needs a UNet built with quant=True")
        self.int8 = int8
        self.unet = unet.eval()
        self.vae = vae.eval() if vae is not None else None
        self.sched = scheduler or make_scheduler("scaled_linear")
        self.steps = steps
        self.guidance = guidance_scale
        self.encoder_reuse = encoder_reuse
        self.sampler = sampler
        if sampler == "dpmpp_2m":
            ts, sigmas = dpmpp_timesteps_sigmas(self.sched, steps)
            self._init_scale = dpmpp_init_noise_scale(sigmas)
        else:
            ts, sigmas = euler_sigmas(self.sched, steps)
            self._init_scale = euler_init_noise_scale(sigmas)
        self._ts = torch.tensor(ts, dtype=torch.float32, device=self.device)
        self._sigmas = torch.tensor(sigmas, dtype=torch.float32, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_out.weight.device

    @torch.inference_mode()
    def denoise(self, latents: torch.Tensor, context: torch.Tensor,
                uncond_context: torch.Tensor, pooled: Optional[torch.Tensor] = None,
                uncond_pooled: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run every sampler step from the initial (noise-scaled) latents."""
        g = self.guidance
        sigmas, ts = self._sigmas, self._ts
        if self.int8:
            quantize_unet_(self.unet)
        ctx = torch.cat([uncond_context, context], dim=0)
        pl = torch.cat([uncond_pooled, pooled], dim=0) if pooled is not None else None
        tid = torch.cat([time_ids, time_ids], dim=0) if time_ids is not None else None
        x0_prev = torch.zeros_like(latents)
        cache = None
        for i in range(self.steps):
            x = euler_scale_input(latents, sigmas[i])
            t = ts[i].expand(latents.shape[0])
            args = (torch.cat([x, x]), torch.cat([t, t]), ctx, pl, tid)
            if not self.encoder_reuse:
                eps2 = self.unet(*args)
            elif i % 2 == 0:
                eps2, cache = self.unet(*args, return_encoder=True)
            else:
                eps2 = self.unet(*args, cached_encoder=cache)
            eps_u, eps_c = eps2.chunk(2)
            eps = (eps_u + g * (eps_c - eps_u)).to(latents.dtype)
            if self.sampler == "dpmpp_2m":
                x0 = latents - sigmas[i] * eps
                latents = dpmpp_2m_step(latents, x0, x0_prev, i, sigmas, self.steps)
                x0_prev = x0
            else:
                latents = euler_step(latents, eps, sigmas[i], sigmas[i + 1])
        return latents

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → float images in [0, 255], one image at a time."""
        img = torch.cat([self.vae(lat[None]) for lat in latents])
        return torch.clamp((img + 1.0) * 127.5, 0, 255)

    def generate(self, generator: torch.Generator, context: torch.Tensor,
                 uncond_context: torch.Tensor, pooled: Optional[torch.Tensor] = None,
                 uncond_pooled: Optional[torch.Tensor] = None, height: int = 1024,
                 width: int = 1024, decode: bool = True) -> torch.Tensor:
        """Initial noise from ``generator`` (on the pipeline's device), the
        denoise loop, then the decode (or the latents with ``decode=False``)."""
        b = context.shape[0]
        shape = (b, height // 8, width // 8, self.unet.in_channels)
        latents = torch.randn(shape, generator=generator, device=self.device,
                              dtype=torch.float32) * self._init_scale
        time_ids = None
        if pooled is not None:
            # SDXL micro-conditioning: (orig_h, orig_w, crop_y, crop_x, tgt_h, tgt_w)
            time_ids = torch.tensor([height, width, 0, 0, height, width],
                                    dtype=torch.float32, device=self.device).expand(b, 6)
        latents = self.denoise(latents, context, uncond_context, pooled, uncond_pooled,
                               time_ids)
        if decode and self.vae is not None:
            return self.decode(latents)
        return latents


def images_to_uint8(images: torch.Tensor) -> np.ndarray:
    return images.detach().cpu().numpy().astype(np.uint8)
