"""SD/SDXL VAE decoder and encoder (torch, NHWC).

Counterpart of ``divergen_tpu/pipeline/generation/vae.py``: latents → pixels
in (-1, 1) and back. Four scales of (128, 256, 512, 512) channels (the x4
upscaler's VAE has three, (128, 256, 512), and so decodes ×4), three res
blocks each on the way up and two on the way down, one single-head mid
attention (d = 512, through ``flash_attention`` once the latent grid exceeds
128 tokens), scaling factor 0.13025 for SDXL (the JAX default, kept for the
x4 VAE too). ``conv_out`` (and the encoder's ``quant_conv``) run in float32.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modeling.layers import Conv, Dense
from .unet import GroupNorm32, _attention, upsample_nearest2x


class VAEResBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm1 = GroupNorm32(in_channels, device)
        self.conv1 = Conv(in_channels, out_channels, 3, **kw)
        self.norm2 = GroupNorm32(out_channels, device)
        self.conv2 = Conv(out_channels, out_channels, 3, **kw)
        self.shortcut = (Conv(in_channels, out_channels, 1, **kw)
                         if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.shortcut is not None:
            x = self.shortcut(x)
        return x + h


class VAEAttention(nn.Module):
    """One-head self-attention over the latent grid."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.norm = GroupNorm32(channels, device)
        self.q = Dense(channels, channels, **kw)
        self.k = Dense(channels, channels, **kw)
        self.v = Dense(channels, channels, **kw)
        self.proj_out = Dense(channels, channels, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        y = self.norm(x).reshape(b, h * w, c)
        o = self.proj_out(_attention(self.q(y), self.k(y), self.v(y), heads=1))
        return x + o.reshape(b, h, w, c)


class VAEDecoder(nn.Module):
    def __init__(self, channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4, scaling_factor: float = 0.13025,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.channels = tuple(channels)
        self.scaling_factor = scaling_factor
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        ch = self.channels[-1]
        self.post_quant_conv = Conv(latent_channels, latent_channels, 1, **kw)
        self.conv_in = Conv(latent_channels, ch, 3, **kw)
        self.mid_res0 = VAEResBlock(ch, ch, **kw)
        self.mid_attn = VAEAttention(ch, **kw)
        self.mid_res1 = VAEResBlock(ch, ch, **kw)
        cur = ch
        for lvl, ch in enumerate(reversed(self.channels)):
            for i in range(3):
                self.add_module(f"up{lvl}_res{i}", VAEResBlock(cur, ch, **kw))
                cur = ch
            if lvl < len(self.channels) - 1:
                self.add_module(f"up{lvl}_conv", Conv(cur, cur, 3, **kw))
        self.norm_out = GroupNorm32(cur, device)
        self.conv_out = Conv(cur, 3, 3, dtype=torch.float32, device=device)

    def forward(self, latents: torch.Tensor) -> torch.Tensor:
        z = latents.to(self.dtype) / self.scaling_factor
        x = self.conv_in(self.post_quant_conv(z))
        x = self.mid_res1(self.mid_attn(self.mid_res0(x)))
        for lvl in range(len(self.channels)):
            for i in range(3):
                x = getattr(self, f"up{lvl}_res{i}")(x)
            if lvl < len(self.channels) - 1:
                x = getattr(self, f"up{lvl}_conv")(upsample_nearest2x(x))
        x = F.silu(self.norm_out(x))
        return self.conv_out(x)  # (-1, 1) range


class VAEEncoder(nn.Module):
    """Images in (-1, 1) → scaled latents: the posterior's mean (its mode),
    or with a ``generator`` a sample mean + exp(logvar / 2) · ε."""

    def __init__(self, channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4, scaling_factor: float = 0.13025,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.channels = tuple(channels)
        self.scaling_factor = scaling_factor
        kw = dict(dtype=dtype, device=device)
        self.conv_in = Conv(3, self.channels[0], 3, **kw)
        cur = self.channels[0]
        for lvl, ch in enumerate(self.channels):
            for i in range(2):
                self.add_module(f"down{lvl}_res{i}", VAEResBlock(cur, ch, **kw))
                cur = ch
            if lvl < len(self.channels) - 1:
                self.add_module(f"down{lvl}_conv", Conv(ch, ch, 3, stride=2, **kw))
        self.mid_res0 = VAEResBlock(cur, cur, **kw)
        self.mid_attn = VAEAttention(cur, **kw)
        self.mid_res1 = VAEResBlock(cur, cur, **kw)
        self.norm_out = GroupNorm32(cur, device)
        f32 = dict(dtype=torch.float32, device=device)
        self.conv_out = Conv(cur, 2 * latent_channels, 3, **f32)
        self.quant_conv = Conv(2 * latent_channels, 2 * latent_channels, 1, **f32)

    def forward(self, images: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        x = self.conv_in(images)
        for lvl in range(len(self.channels)):
            for i in range(2):
                x = getattr(self, f"down{lvl}_res{i}")(x)
            if lvl < len(self.channels) - 1:
                x = getattr(self, f"down{lvl}_conv")(x)
        x = self.mid_res1(self.mid_attn(self.mid_res0(x)))
        x = self.quant_conv(self.conv_out(F.silu(self.norm_out(x))))
        mean, logvar = x.chunk(2, dim=-1)
        if generator is not None:
            eps = torch.randn(mean.shape, generator=generator, device=mean.device,
                              dtype=mean.dtype)
            mean = mean + torch.exp(0.5 * logvar.clamp(-30, 20)) * eps
        return mean * self.scaling_factor
