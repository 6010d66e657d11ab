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

``mesh`` is the counterpart of the JAX pipeline's one-axis ``"data"`` mesh: a
sequence of local devices (a device may repeat). The UNet and the VAE are
replicated once per distinct device; ``generate`` draws the latents at the
global batch's shape, splits them into contiguous row blocks, one a mesh
entry, with the contexts and pooled states, runs each block's denoise loop
and whole-block decode on its device and returns the images in row order on
the first. The blocks' launches come from one thread, interleaved step by
step: the host sets the pace of a CFG step, and the wrappers' launch counters
are plain ints that threads would race on.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence

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
                 int8: bool = False, mesh: Optional[Sequence] = None,
                 sampler: str = "euler"):
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
        self.mesh: Optional[List[torch.device]] = None
        if mesh is not None:
            self._set_mesh(mesh)

    def _set_mesh(self, mesh: Sequence) -> None:
        """Check the mesh's devices and replicate the modules on each
        distinct one. Every entry is a CUDA device, or, where the caller
        built the modules on the CPU, the CPU."""
        devices = [torch.device(d) for d in mesh]
        if not devices:
            raise ValueError("an empty mesh")
        on_cpu = self.device.type == "cpu"
        for d in devices:
            if d.type != "cuda" and not (on_cpu and d.type == "cpu"):
                raise ValueError(f"mesh entry {d}: the mesh takes CUDA devices (or the CPU "
                                 "where the modules were built on the CPU)")
        # an index for every CUDA entry, so that equal devices compare equal
        devices = [torch.device("cuda", torch.cuda.current_device() if d.index is None
                                else d.index) if d.type == "cuda" else d for d in devices]
        self.mesh = devices
        self._replicas = {}
        for d in dict.fromkeys(devices):
            if d == self.device:
                unet, vae = self.unet, self.vae
            else:
                unet = copy.deepcopy(self.unet).to(d)
                vae = copy.deepcopy(self.vae).to(d) if self.vae is not None else None
            self._replicas[d] = (unet, vae, self._sigmas.to(d), self._ts.to(d))

    @property
    def device(self) -> torch.device:
        return self.unet.conv_out.weight.device

    @torch.inference_mode()
    def denoise(self, latents: torch.Tensor, context: torch.Tensor,
                uncond_context: torch.Tensor, pooled: Optional[torch.Tensor] = None,
                uncond_pooled: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Run every sampler step from the initial (noise-scaled) latents."""
        if self.int8:
            quantize_unet_(self.unet)
        out = None
        for out in self._steps(self.unet, self._sigmas, self._ts, latents, context,
                               uncond_context, pooled, uncond_pooled, time_ids):
            pass
        return latents if out is None else out

    def _steps(self, unet, sigmas, ts, latents, context, uncond_context, pooled=None,
               uncond_pooled=None, time_ids=None):
        """The denoise loop on ``unet``'s device, yielding the latents after
        each sampler step."""
        g = self.guidance
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
                eps2 = unet(*args)
            elif i % 2 == 0:
                eps2, cache = unet(*args, return_encoder=True)
            else:
                eps2 = unet(*args, cached_encoder=cache)
            eps_u, eps_c = eps2.chunk(2)
            eps = (eps_u + g * (eps_c - eps_u)).to(latents.dtype)
            if self.sampler == "dpmpp_2m":
                x0 = latents - sigmas[i] * eps
                latents = dpmpp_2m_step(latents, x0, x0_prev, i, sigmas, self.steps)
                x0_prev = x0
            else:
                latents = euler_step(latents, eps, sigmas[i], sigmas[i + 1])
            yield latents

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → float images in [0, 255], one image at a time."""
        img = torch.cat([self.vae(lat[None]) for lat in latents])
        return torch.clamp((img + 1.0) * 127.5, 0, 255)

    @torch.inference_mode()
    def _generate_mesh(self, latents, context, uncond_context, pooled, uncond_pooled,
                       time_ids, decode: bool) -> torch.Tensor:
        """``generate`` over the mesh: row block i on ``mesh[i]``, the blocks'
        sampler steps interleaved from this thread; each block decoded whole
        on its device; the result in row order on the first device."""
        n = len(self.mesh)
        if latents.shape[0] % n:
            raise ValueError(f"a batch of {latents.shape[0]} does not split over a mesh of {n}")
        per = latents.shape[0] // n
        rows = lambda x, i: None if x is None else x[i * per:(i + 1) * per]
        loops, blocks = [], []
        for i, dev in enumerate(self.mesh):
            unet, _, sigmas, ts = self._replicas[dev]
            with _on_device(dev):
                if self.int8:
                    quantize_unet_(unet)
                args = [rows(x, i) for x in (latents, context, uncond_context, pooled,
                                             uncond_pooled, time_ids)]
                args = [None if x is None else x.to(dev) for x in args]
                loops.append(self._steps(unet, sigmas, ts, *args))
                blocks.append(args[0])
        for _ in range(self.steps):
            for i, dev in enumerate(self.mesh):
                with _on_device(dev):
                    blocks[i] = next(loops[i])
        if decode and self.vae is not None:
            for i, dev in enumerate(self.mesh):
                with _on_device(dev):
                    img = self._replicas[dev][1](blocks[i])
                    blocks[i] = torch.clamp((img + 1.0) * 127.5, 0, 255)
        return torch.cat([b.to(self.mesh[0]) for b in blocks])

    def generate(self, generator: torch.Generator, context: torch.Tensor,
                 uncond_context: torch.Tensor, pooled: Optional[torch.Tensor] = None,
                 uncond_pooled: Optional[torch.Tensor] = None, height: int = 1024,
                 width: int = 1024, decode: bool = True) -> torch.Tensor:
        """Initial noise from ``generator`` (on the pipeline's device), the
        denoise loop, then the decode (or the latents with ``decode=False``);
        with a mesh, over its devices (module docstring)."""
        b = context.shape[0]
        shape = (b, height // 8, width // 8, self.unet.in_channels)
        latents = torch.randn(shape, generator=generator, device=self.device,
                              dtype=torch.float32) * self._init_scale
        time_ids = None
        if pooled is not None:
            # SDXL micro-conditioning: (orig_h, orig_w, crop_y, crop_x, tgt_h, tgt_w)
            time_ids = torch.tensor([height, width, 0, 0, height, width],
                                    dtype=torch.float32, device=self.device).expand(b, 6)
        if self.mesh is not None:
            return self._generate_mesh(latents, context, uncond_context, pooled, uncond_pooled,
                                       time_ids, decode)
        latents = self.denoise(latents, context, uncond_context, pooled, uncond_pooled,
                               time_ids)
        if decode and self.vae is not None:
            return self.decode(latents)
        return latents


def _on_device(dev: torch.device):
    """``dev`` made the current CUDA device (the kernel wrappers launch on
    the current device's stream); nothing for the CPU."""
    import contextlib

    return torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext()


def images_to_uint8(images: torch.Tensor) -> np.ndarray:
    return images.detach().cpu().numpy().astype(np.uint8)
