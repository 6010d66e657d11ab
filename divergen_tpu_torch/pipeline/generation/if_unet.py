"""DeepFloyd-IF cascade UNets and pipelines (torch, NHWC): stage I (64²
text → image) and stage II (64 → 256 super-resolution).

Counterpart of ``divergen_tpu/pipeline/generation/if_unet.py``: the
Imagen-style pixel-space UNet that diffusers' ``UNet2DConditionModel`` builds
for the IF configs, with

* resnets with ``time_embedding_norm="scale_shift"`` (FiLM from the time
  embedding), tanh-approximate GELU (``jax.nn.gelu``'s default), and the
  down / up sampling inside a resnet (average pool / nearest ×2 of both
  branches);
* ``AttnAddedKVProcessor`` attention: queries from the group-normed spatial
  tokens, keys and values the projected T5 states followed by the spatial
  self keys and values, one attention per resnet from ``attn_start`` on;
* ``addition_embed_type="text"``: the attention-pooled raw T5 states added to
  the time embedding (``TextTimeEmbedding``);
* 2·C output channels: ε and the learned-range variance interpolant of
  ``scheduler.ddpm_learned_range_step``;
* stage II: 6 input channels (noisy latents ⊕ the bilinear-upscaled stage-I
  frame, noised to ``noise_level``) and noise-level conditioning.

The group norms are flax ``nn.GroupNorm``'s: min(32, C) groups, eps 1e-5 and,
having no dtype, a float32 output whatever the input's (``layers.GroupNorm``).
The attentions compute their scores in float32, as the JAX package's einsums
with ``preferred_element_type=float32``; no Pallas kernel serves them there,
so none does here. Submodules carry the flax scope names, so
``utils.convert.params_from_jax`` maps an ``init`` tree (or
``utils.torch_weights.convert_if_unet``'s) one to one. Random draws come from
a ``torch.Generator``; the denoise loops take each step's noise through
``step_noise``.
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modeling.layers import Conv, Dense, GroupNorm, LayerNorm, avg_pool
from .scheduler import (
    SchedulerConfig,
    add_noise,
    ddpm_learned_range_step,
    ddpm_timesteps,
    make_scheduler,
)
from .unet import timestep_embedding, upsample_nearest2x


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _gn(channels: int, device=None) -> GroupNorm:
    """flax ``nn.GroupNorm(num_groups=min(32, C), epsilon=1e-5)``."""
    return GroupNorm(min(32, channels), channels, eps=1e-5, device=device)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, Nq, C) × (B, Nk, C) attention: scores in float32, P cast to v's
    dtype, the P·V product in v's dtype."""
    b, nq, c = q.shape
    d = c // heads
    split = lambda t: t.reshape(t.shape[0], t.shape[1], heads, d)
    s = torch.einsum("bqhd,bkhd->bhqk", split(q).float(), split(k).float()) / math.sqrt(d)
    p = torch.softmax(s, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", p, split(v)).reshape(b, nq, c)


class AttentionPooling(nn.Module):
    """diffusers ``AttentionPooling``: a class token, mean(x) + a learned
    positional embedding, attends over [cls; x]."""

    def __init__(self, dim: int, num_heads: int, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.num_heads = num_heads
        self.positional_embedding = nn.Parameter(torch.zeros(1, dim, device=device))
        self.q_proj = Dense(dim, dim, **kw)
        self.k_proj = Dense(dim, dim, **kw)
        self.v_proj = Dense(dim, dim, **kw)
        self.raw_init_std = {"positional_embedding": dim ** -0.5}

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # (B, L, D) -> (B, D)
        cls = x.mean(dim=1, keepdim=True) + self.positional_embedding[None].to(x.dtype)
        tokens = torch.cat([cls, x], dim=1)
        out = _attend(self.q_proj(cls), self.k_proj(tokens), self.v_proj(tokens),
                      self.num_heads)
        return out[:, 0]


class TextTimeEmbedding(nn.Module):
    """diffusers ``TextTimeEmbedding``: LayerNorm → attention pool → proj →
    LayerNorm (flax's default eps, 1e-6)."""

    def __init__(self, encoder_dim: int, time_embed_dim: int, num_heads: int = 64,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.norm1 = LayerNorm(encoder_dim, eps=1e-6, device=device)
        self.pool = AttentionPooling(encoder_dim, num_heads, dtype, device)
        self.proj = Dense(encoder_dim, time_embed_dim, dtype=dtype, device=device)
        self.norm2 = LayerNorm(time_embed_dim, eps=1e-6, device=device)

    def forward(self, ctx: torch.Tensor) -> torch.Tensor:  # (B, L, D) -> (B, T)
        return self.norm2(self.proj(self.pool(self.norm1(ctx))))


class IFResBlock(nn.Module):
    """``ResnetBlock2D`` with scale-shift time conditioning: GN → GELU →
    (resample) → conv, GN · (1 + scale) + shift, GELU → conv, + the input
    (resampled, through a 1×1 ``conv_shortcut`` when the widths differ)."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 down: bool = False, up: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        self.down, self.up = down, up
        self.norm1 = _gn(in_channels, device)
        self.conv1 = Conv(in_channels, out_channels, 3, **kw)
        self.time_emb_proj = Dense(temb_dim, 2 * out_channels, **kw)
        self.norm2 = _gn(out_channels, device)
        self.conv2 = Conv(out_channels, out_channels, 3, **kw)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        h = gelu(self.norm1(x))
        if self.down:
            x, h = avg_pool(x, 2, 2), avg_pool(h, 2, 2)
        elif self.up:
            x, h = upsample_nearest2x(x), upsample_nearest2x(h)
        h = self.conv1(h)
        scale, shift = self.time_emb_proj(gelu(temb))[:, None, None, :].chunk(2, dim=-1)
        h = self.conv2(gelu(self.norm2(h) * (1.0 + scale) + shift))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class AddedKVAttention(nn.Module):
    """``Attention`` + ``AttnAddedKVProcessor``: q from the group-normed
    spatial tokens; keys and values [projected encoder states ; spatial self
    K/V]; ``to_out``; the residual. max(C // head_dim, 1) heads."""

    def __init__(self, channels: int, context_dim: int, head_dim: int = 64,
                 dtype=torch.float32, device=None):
        super().__init__()
        kw = dict(dtype=dtype, device=device)
        c = channels
        self.heads = max(c // head_dim, 1)
        self.group_norm = _gn(c, device)
        self.to_q = Dense(c, c, **kw)
        self.to_k = Dense(c, c, **kw)
        self.to_v = Dense(c, c, **kw)
        self.add_k_proj = Dense(context_dim, c, **kw)
        self.add_v_proj = Dense(context_dim, c, **kw)
        self.to_out = Dense(c, c, **kw)

    def forward(self, x: torch.Tensor, ctx: torch.Tensor) -> torch.Tensor:
        b, hh, ww, c = x.shape
        n = self.group_norm(x).reshape(b, hh * ww, c)
        k = torch.cat([self.add_k_proj(ctx), self.to_k(n)], dim=1)
        v = torch.cat([self.add_v_proj(ctx), self.to_v(n)], dim=1)
        o = self.to_out(_attend(self.to_q(n), k, v, self.heads))
        return x + o.reshape(b, hh, ww, c)


class IFUNet(nn.Module):
    """IF-config ``UNet2DConditionModel``: ``channels[i]`` per level, levels
    from ``attn_start`` on pair every resnet with an added-KV attention (the
    mid block always has one). ``if_i_xl`` / ``if_ii_l`` are the public
    release sizings."""

    def __init__(self, channels: Sequence[int] = (704, 1408, 2816, 2816),
                 layers_per_block: int = 3, in_channels: int = 3, out_channels: int = 6,
                 encoder_dim: int = 4096, context_dim: Optional[int] = None,
                 head_dim: int = 64, pool_heads: int = 64, attn_start: int = 1,
                 noise_level_cond: bool = False, dtype=torch.float32, device=None):
        super().__init__()
        self.channels = tuple(channels)
        self.layers_per_block = layers_per_block
        self.in_channels, self.encoder_dim = in_channels, encoder_dim
        self.attn_start, self.noise_level_cond = attn_start, noise_level_cond
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        c0 = self.channels[0]
        tdim = 4 * c0
        self.time_emb_1 = Dense(c0, tdim, **kw)
        self.time_emb_2 = Dense(tdim, tdim, **kw)
        if noise_level_cond:
            self.class_emb_1 = Dense(c0, tdim, **kw)
            self.class_emb_2 = Dense(tdim, tdim, **kw)
        self.add_embedding = TextTimeEmbedding(encoder_dim, tdim, pool_heads, **kw)
        ctx_dim = encoder_dim
        if context_dim is not None:
            self.encoder_hid_proj = Dense(encoder_dim, context_dim, **kw)
            ctx_dim = context_dim

        def res(name, cin, cout, **updown):
            self.add_module(name, IFResBlock(cin, cout, tdim, **updown, **kw))

        def attn(name, ch):
            self.add_module(name, AddedKVAttention(ch, ctx_dim, head_dim, **kw))

        self.conv_in = Conv(in_channels, c0, 3, **kw)
        n = len(self.channels)
        cur, skips = c0, [c0]
        for i, ch in enumerate(self.channels):
            for j in range(layers_per_block):
                res(f"down_{i}_res_{j}", cur, ch)
                if i >= attn_start:
                    attn(f"down_{i}_attn_{j}", ch)
                cur = ch
                skips.append(ch)
            if i < n - 1:
                res(f"down_{i}_downsample", ch, ch, down=True)
                skips.append(ch)
        res("mid_res_0", cur, self.channels[-1])
        attn("mid_attn", self.channels[-1])
        res("mid_res_1", self.channels[-1], self.channels[-1])
        cur = self.channels[-1]
        for i in reversed(range(n)):
            ch = self.channels[i]
            for j in range(layers_per_block + 1):
                res(f"up_{i}_res_{j}", cur + skips.pop(), ch)
                if i >= attn_start:
                    attn(f"up_{i}_attn_{j}", ch)
                cur = ch
            if i > 0:
                res(f"up_{i}_upsample", ch, ch, up=True)
        self.conv_norm_out = _gn(cur, device)
        # conv_out runs in float32, as in the JAX module
        self.conv_out = Conv(cur, out_channels, 3, dtype=torch.float32, device=device)

    def forward(self, sample: torch.Tensor, t: torch.Tensor, ctx: torch.Tensor,
                noise_level: Optional[torch.Tensor] = None) -> torch.Tensor:
        """sample (B, H, W, in_channels) in [-1, 1], t (B,), ctx (B, L,
        encoder_dim) T5 states, noise_level (B,) for stage II → (B, H, W,
        out_channels) float32."""
        c0 = self.channels[0]
        emb = self.time_emb_2(gelu(self.time_emb_1(timestep_embedding(t, c0))))
        if self.noise_level_cond:
            ne = self.class_emb_1(timestep_embedding(noise_level, c0))
            emb = emb + self.class_emb_2(gelu(ne))
        # the pool reads the RAW T5 states (diffusers applies add_embedding
        # before encoder_hid_proj)
        emb = emb + self.add_embedding(ctx.to(self.dtype))
        if hasattr(self, "encoder_hid_proj"):
            ctx = self.encoder_hid_proj(ctx)
        ctx = ctx.to(self.dtype)

        x = self.conv_in(sample)
        skips = [x]
        n = len(self.channels)
        for i in range(n):
            for j in range(self.layers_per_block):
                x = getattr(self, f"down_{i}_res_{j}")(x, emb)
                if i >= self.attn_start:
                    x = getattr(self, f"down_{i}_attn_{j}")(x, ctx)
                skips.append(x)
            if i < n - 1:
                x = getattr(self, f"down_{i}_downsample")(x, emb)
                skips.append(x)
        x = self.mid_res_1(self.mid_attn(self.mid_res_0(x, emb), ctx), emb)
        for i in reversed(range(n)):
            for j in range(self.layers_per_block + 1):
                x = getattr(self, f"up_{i}_res_{j}")(torch.cat([x, skips.pop()], dim=-1), emb)
                if i >= self.attn_start:
                    x = getattr(self, f"up_{i}_attn_{j}")(x, ctx)
            if i > 0:
                x = getattr(self, f"up_{i}_upsample")(x, emb)
        return self.conv_out(gelu(self.conv_norm_out(x)))

    @classmethod
    def if_i_xl(cls, dtype=torch.bfloat16, device=None) -> "IFUNet":
        """Stage I XL (~4.3 B parameters): 704/1408/2816/2816 × 3 layers."""
        return cls(dtype=dtype, device=device)

    @classmethod
    def if_ii_l(cls, dtype=torch.bfloat16, device=None) -> "IFUNet":
        """Stage II L (~1.2 B): 320/640/1280/1280, attention at the two
        deepest levels, 6-channel input, noise-level conditioning."""
        return cls(channels=(320, 640, 1280, 1280), layers_per_block=3, in_channels=6,
                   attn_start=2, noise_level_cond=True, dtype=dtype, device=device)


def resize_bilinear(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """NHWC ``jax.image.resize(..., "bilinear")`` for an upscale: half-pixel
    centres, taps past an edge dropped and the rest renormalized, which is
    ``F.interpolate(align_corners=False)``'s clamp to the edge sample."""
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode="bilinear",
                      align_corners=False)
    return y.permute(0, 2, 3, 1)


class IFStageIPipeline:
    """Stage I: 64² pixel-space CFG denoise, ancestral DDPM with the
    learned-range variance and dynamic thresholding (diffusers
    ``IFPipeline``'s loop)."""

    def __init__(self, unet: IFUNet, steps: int = 100, guidance_scale: float = 7.0,
                 scheduler: Optional[SchedulerConfig] = None):
        self.unet = unet.eval()
        self.steps = steps
        self.guidance = guidance_scale
        self.sched = scheduler or make_scheduler("cosine")
        ts = ddpm_timesteps(self.sched, steps)
        ratio = self.sched.num_train_timesteps // steps
        self._ts = [int(t) for t in ts]
        self._prev = [int(t) - ratio for t in ts]  # < 0: the final step

    @property
    def device(self) -> torch.device:
        return self.unet.conv_out.weight.device

    def step_noise(self, generator: torch.Generator, shape, i: int) -> torch.Tensor:
        """The noise of step ``i`` (a test may replace this method)."""
        return torch.randn(shape, generator=generator, device=self.device)

    def _cfg_eps(self, lat: torch.Tensor, t: int, ctx2: torch.Tensor,
                 extra: Optional[torch.Tensor] = None):
        """ε with guidance and the cond branch's variance interpolant."""
        b = lat.shape[0]
        t2 = torch.full((2 * b,), t, dtype=torch.long, device=lat.device)
        nl = None if extra is None else torch.cat([extra, extra])
        out = self.unet(torch.cat([lat, lat]), t2, ctx2, noise_level=nl)
        eps2, var2 = out.chunk(2, dim=-1)
        eps_u, eps_c = eps2.chunk(2)
        return eps_u + self.guidance * (eps_c - eps_u), var2.chunk(2)[1]

    def _step(self, lat, eps, var, i, generator):
        noise = self.step_noise(generator, lat.shape, i)
        return ddpm_learned_range_step(self.sched, lat, eps, var, self._ts[i], self._prev[i],
                                       noise)

    @torch.inference_mode()
    def denoise(self, lat: torch.Tensor, ctx2: torch.Tensor,
                generator: torch.Generator) -> torch.Tensor:
        for i in range(self.steps):
            eps, var = self._cfg_eps(lat, self._ts[i], ctx2)
            lat = self._step(lat, eps, var, i, generator)
        return lat

    def generate(self, generator: torch.Generator, context: torch.Tensor,
                 uncond_context: torch.Tensor, size: int = 64) -> torch.Tensor:
        """→ (B, size, size, 3) float32 images in [-1, 1]."""
        b = context.shape[0]
        lat = torch.randn((b, size, size, self.unet.in_channels), generator=generator,
                          device=self.device)
        ctx2 = torch.cat([uncond_context, context]).to(self.device)
        return self.denoise(lat, ctx2, generator).clamp(-1.0, 1.0)


class IFStageIIPipeline(IFStageIPipeline):
    """Stage II super-resolution: the stage-I output upscaled (bilinear),
    noised to ``noise_level`` by the scheduler's forward process, concatenated
    channel-wise and denoised at the larger size with noise-level
    conditioning (``IFSuperResolutionPipeline``)."""

    def __init__(self, unet: IFUNet, steps: int = 50, guidance_scale: float = 4.0,
                 scheduler: Optional[SchedulerConfig] = None):
        super().__init__(unet, steps, guidance_scale, scheduler)

    @torch.inference_mode()
    def denoise(self, lat: torch.Tensor, cond: torch.Tensor, ctx2: torch.Tensor,
                nl: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
        c = lat.shape[-1]
        for i in range(self.steps):
            eps, var = self._cfg_eps(torch.cat([lat, cond], dim=-1), self._ts[i], ctx2, nl)
            lat = self._step(lat, eps[..., :c], var[..., :c], i, generator)
        return lat

    def generate(self, generator: torch.Generator, image: torch.Tensor,
                 context: torch.Tensor, uncond_context: torch.Tensor,
                 noise_level: int = 250, scale: int = 4) -> torch.Tensor:
        """``image`` (B, h, w, 3) in [-1, 1] → (B, h·scale, w·scale, 3)."""
        b, h, w, _ = image.shape
        hs, ws = h * scale, w * scale
        up = resize_bilinear(image.to(self.device, torch.float32), hs, ws)
        nl = torch.full((b,), noise_level, dtype=torch.long, device=self.device)
        noise = torch.randn(up.shape, generator=generator, device=self.device)
        cond = add_noise(self.sched, up, noise, noise_level)
        lat = torch.randn((b, hs, ws, 3), generator=generator, device=self.device)
        ctx2 = torch.cat([uncond_context, context]).to(self.device)
        return self.denoise(lat, cond, ctx2, nl, generator).clamp(-1.0, 1.0)
