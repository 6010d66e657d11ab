"""Stage III: the x4 latent-diffusion upscaler (torch).

Counterpart of ``divergen_tpu/pipeline/generation/upscale.py``, the SD-x4
upscaler's geometry on the port's ``UNetSDXL``: a 4-channel latent
concatenated with the 3-channel low-res RGB image (7 input channels), text
conditioning at width 1024, and the low-res image's noise level as a class
label (``num_class_embeds=1000``). The low-res image is noised by its own
DDPM schedule (scaled-linear 1e-4 → 2e-2) at that level; the latents are
denoised by Euler with CFG and decoded by a three-level VAE, ×4. The UNet's
self-attention runs kernel 1 and its norm3 → GEGLU kernel 2 (16 launches of
each a UNet call at full width), the VAE's mid attention kernel 3 (one
launch an upscale: the batch decodes at once, as in JAX).
"""
from __future__ import annotations

from typing import Optional

import torch

from .scheduler import (
    SchedulerConfig,
    add_noise,
    euler_init_noise_scale,
    euler_scale_input,
    euler_sigmas,
    euler_step,
    make_scheduler,
)
from .unet import UNetSDXL
from .vae import VAEDecoder


def upscaler_unet(dtype=torch.float32, tiny: bool = False, device=None) -> UNetSDXL:
    """SD-x4-upscaler UNet: 7 in-channels (4 latent + 3 low-res RGB), 4 out,
    blocks (256, 512, 512, 1024) with attention on the inner three levels,
    context width 1024 (OpenCLIP-H text states), 1000 noise-level classes."""
    if tiny:
        return UNetSDXL(in_channels=7, out_channels=4, block_channels=(16, 32),
                        transformer_depths=(0, 1), context_dim=32, head_dim=8,
                        layers_per_block=1, num_class_embeds=1000, text_time=False,
                        dtype=dtype, device=device)
    return UNetSDXL(in_channels=7, out_channels=4, block_channels=(256, 512, 512, 1024),
                    transformer_depths=(0, 1, 1, 1), context_dim=1024, head_dim=64,
                    layers_per_block=2, num_class_embeds=1000, text_time=False,
                    dtype=dtype, device=device)


class UpscalePipeline:
    """x4 latent super-resolution: (B, h, w, 3) RGB in 0..255 → (B, 4h, 4w, 3)
    in [0, 255]. ``low_res_noise_level`` (100, the reference's stage-III
    setting) is both the class label and the low-res image's noise level."""

    def __init__(self, unet: UNetSDXL, vae: Optional[VAEDecoder] = None,
                 scheduler: Optional[SchedulerConfig] = None, steps: int = 25,
                 guidance_scale: float = 7.5, low_res_noise_level: int = 100,
                 low_res_scheduler: Optional[SchedulerConfig] = None):
        self.unet = unet.eval()
        self.vae = vae.eval() if vae is not None else None
        self.sched = scheduler or make_scheduler("scaled_linear")
        self.steps = steps
        self.guidance = guidance_scale
        self.noise_level = int(low_res_noise_level)
        # diffusers' low_res_scheduler of the x4 upscaler
        self.low_res_sched = low_res_scheduler or make_scheduler("scaled_linear", start=1e-4,
                                                                 end=2e-2)
        ts, sigmas = euler_sigmas(self.sched, steps)
        self._init_scale = euler_init_noise_scale(sigmas)
        self._ts = torch.tensor(ts, dtype=torch.float32, device=self.device)
        self._sigmas = torch.tensor(sigmas, dtype=torch.float32, device=self.device)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_out.weight.device

    @torch.inference_mode()
    def denoise(self, latents: torch.Tensor, low_res: torch.Tensor, context: torch.Tensor,
                uncond_context: torch.Tensor) -> torch.Tensor:
        """Every Euler step from the initial (noise-scaled) latents; the UNet
        sees [latents ‖ low-res image] and the noise level as its class."""
        g, sigmas = self.guidance, self._sigmas
        b = latents.shape[0]
        ctx = torch.cat([uncond_context, context])
        low2 = torch.cat([low_res, low_res])
        nl2 = torch.full((2 * b,), self.noise_level, dtype=torch.long, device=latents.device)
        for i in range(self.steps):
            x = euler_scale_input(latents, sigmas[i])
            t = self._ts[i].expand(b)
            inp = torch.cat([torch.cat([x, x]), low2], dim=-1)
            eps_u, eps_c = self.unet(inp, torch.cat([t, t]), ctx, class_labels=nl2).chunk(2)
            eps = (eps_u + g * (eps_c - eps_u)).to(latents.dtype)
            latents = euler_step(latents, eps, sigmas[i], sigmas[i + 1])
        return latents

    @torch.inference_mode()
    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        """Latents → float images in [0, 255], the batch at once."""
        return torch.clamp((self.vae(latents) + 1.0) * 127.5, 0, 255)

    def upscale(self, generator: torch.Generator, images: torch.Tensor, context: torch.Tensor,
                uncond_context: torch.Tensor, decode: bool = True) -> torch.Tensor:
        b, h, w, _ = images.shape
        low = images.to(self.device, torch.float32) / 127.5 - 1.0
        noise = torch.randn(low.shape, generator=generator, device=self.device)
        low = add_noise(self.low_res_sched, low, noise, self.noise_level)
        # the latent grid is the low-res image's: the x4 VAE decodes it to 4h x 4w
        latents = torch.randn((b, h, w, 4), generator=generator,
                              device=self.device) * self._init_scale
        latents = self.denoise(latents, low, context.to(self.device),
                               uncond_context.to(self.device))
        if decode and self.vae is not None:
            return self.decode(latents)
        return latents
