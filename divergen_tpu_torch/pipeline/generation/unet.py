"""SDXL-architecture diffusion UNet (torch, NHWC).

Counterpart of ``divergen_tpu/pipeline/generation/unet.py`` on its default
path: blocks (320, 640, 1280); down = [ResOnly, CrossAttn(depth 2),
CrossAttn(depth 10)]; mid CrossAttn(depth 10); context dim 2048; the
"text_time" added conditioning (pooled 1280 + 6 Fourier time ids → 2816 →
1280). Self-attention runs through ``flash_attention_packed`` on the fused
(B, N, 3C) projection, and norm3 → GEGLU through ``fused_ln_matmul``
(``ln_gemm="geglu"``); both launch hand-written CUDA kernels on the card.
Cross-attention over ≤128 text tokens stays plain torch, as the JAX package
leaves it to XLA. Submodules carry the flax scope names, so
``utils.convert.params_from_jax`` maps the JAX tree one to one.

The serving options of the JAX module are ported too: ``quant`` (W8A8 int8
transformer matmuls through ``ops/int8_matmul.py``, after
:func:`quantize_unet_`; it turns ``ln_gemm`` off, as in JAX), ``fused_ln``
(the transformer LayerNorms through ``ops/layer_norm.py``) and ``fused_gn``
(every GroupNorm, with its SiLU, through ``ops/group_norm.py``). So is
``conv_matmul="fused"``: each ResBlock's norm → SiLU → 3×3 conv pairs run as
one ``ops/gn_conv.py:fused_gn_silu_conv3x3`` call each (forward only; the
ResBlocks then ignore ``fused_gn``, as in JAX). None of them changes the
parameters, so checkpoints and converters are the same. The x4 upscaler's
``num_class_embeds`` (a noise-level embedding added to the time embedding)
and Faster-Diffusion encoder reuse (``return_encoder`` / ``cached_encoder``)
are ported as well.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modeling.layers import Conv, Dense, LayerNorm
from ...ops.flash_attention import flash_attention, flash_attention_packed
from ...ops.gn_conv import fused_gn_silu_conv3x3
from ...ops.group_norm import fused_group_norm
from ...ops.layer_norm import fused_layer_norm
from ...ops.ln_matmul import fused_ln_matmul
from ...ops.quant import int8_matmul, quantize_weight


def timestep_embedding(t: torch.Tensor, dim: int, max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal embedding in float32, (B,) → (B, dim): cos half, then sin
    half (diffusers, flip_sin_to_cos=True)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32, device=t.device) / half)
    args = t.float()[:, None] * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class GroupNorm32(nn.Module):
    """GroupNorm over NHWC with gcd(32, C) groups and eps 1e-6 (the diffusers
    UNet/VAE value), float32 statistics and affine, output in the input's
    dtype. The affine lives in the child ``GroupNorm_0``, as in flax.

    As in the JAX module, the moments are taken per channel over (H, W) and
    then combined within each group (var = E[x²] − E[x]²): on NHWC this is a
    reduction over the leading spatial axes, where ``F.group_norm`` would
    copy to NCHW and reduce each whole group in one block."""

    def __init__(self, channels: int, device=None):
        super().__init__()
        self.GroupNorm_0 = nn.GroupNorm(math.gcd(32, channels), channels, eps=1e-6,
                                        device=device, dtype=torch.float32)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gn = self.GroupNorm_0
        b, c = x.shape[0], x.shape[-1]
        per_group = c // gn.num_groups
        xf = x.float()
        mean = xf.mean(dim=(1, 2)).view(b, gn.num_groups, per_group).mean(-1)
        var = xf.square().mean(dim=(1, 2)).view(b, gn.num_groups, per_group).mean(-1)
        var = var - mean * mean
        scale = torch.rsqrt(var + gn.eps).repeat_interleave(per_group, dim=-1) * gn.weight
        shift = gn.bias - mean.repeat_interleave(per_group, dim=-1) * scale
        return torch.addcmul(shift[:, None, None], xf, scale[:, None, None]).to(x.dtype)


def _group_norm(x: torch.Tensor, norm: GroupNorm32, fused: bool, silu: bool) -> torch.Tensor:
    """``norm`` (+ SiLU), either plain or through the fused kernel (the JAX
    ``_gn_silu``; eps 1e-6, gcd(32, C) groups, output in x's dtype)."""
    if not fused:
        y = norm(x)
        return F.silu(y) if silu else y
    gn = norm.GroupNorm_0
    return fused_group_norm(x, gn.weight, gn.bias, gn.num_groups, gn.eps, silu)


class FusedLayerNorm(LayerNorm):
    """``LayerNorm`` (same parameters) through ``fused_layer_norm``, on the
    input cast to the module's dtype, as the JAX ``FusedLayerNorm`` does."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__(channels, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_layer_norm(x.to(self.compute_dtype), self.weight, self.bias, self.eps)


class MaybeQuantDense(Dense):
    """``Dense`` that, built with ``quant=True``, multiplies in int8: the
    float ``weight`` and ``bias`` stay (so a state dict loads unchanged),
    :func:`quantize_unet_` fills the non-persistent buffers ``weight_q``
    (int8, (out, in): the (N, K) row-major operand the kernels read) and
    ``weight_scale`` (f32, (out,)), and the forward runs
    ``ops.quant.int8_matmul`` on them, then adds the bias in the output
    dtype."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 quant: bool = False, dtype=None, device=None):
        super().__init__(in_features, out_features, bias=bias, dtype=dtype, device=device)
        self.quant = quant
        self.register_buffer("weight_q", None, persistent=False)
        self.register_buffer("weight_scale", None, persistent=False)

    @torch.no_grad()
    def quantize_(self) -> None:
        """Quantize the float weight into ``weight_q`` / ``weight_scale``."""
        q, scale = quantize_weight(self.weight.t())
        self.weight_q = q.t().contiguous()
        self.weight_scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.quant:
            return super().forward(x)
        if self.weight_q is None:
            raise RuntimeError("a quant layer runs only after quantize_unet_ filled weight_q")
        dt = self.compute_dtype or self.weight.dtype
        y = int8_matmul(x, self.weight_q.t(), self.weight_scale, out_dtype=dt)
        return y if self.bias is None else y + self.bias.to(dt)


def transformer_quant_select(path: Tuple[str, ...]) -> bool:
    """Module paths of the int8 layers: the big transformer matmuls (time and
    class embeddings and the convs stay in the float dtype)."""
    name = path[-1]
    return name.startswith(("attn1_", "attn2_", "ff_")) or name in ("proj_in", "proj_out")


@torch.no_grad()
def quantize_unet_(unet: nn.Module) -> List[str]:
    """Fill the int8 buffers of every layer that ``transformer_quant_select``
    picks, from its float weight: the module form of the JAX
    ``quantize_param_tree(params, select=transformer_quant_select)``. Returns
    the names of the quantized layers. Raises if a picked layer cannot run
    int8 (a UNet built without ``quant``)."""
    names = []
    for name, mod in unet.named_modules():
        if not name or not isinstance(mod, nn.Linear):
            continue
        if not transformer_quant_select(tuple(name.split("."))):
            continue
        if not (isinstance(mod, MaybeQuantDense) and mod.quant):
            raise ValueError(f"{name} is not an int8 layer: build the UNet with quant=True")
        mod.quantize_()
        names.append(name)
    return names


def _check_conv_matmul(conv_matmul) -> None:
    """The port takes the JAX option's ``False`` and ``"fused"``; ``True``,
    ``'im2col'`` and ``'tapsum'`` were A/B knobs for TPU measurement."""
    if conv_matmul is not False and conv_matmul != "fused":
        raise NotImplementedError(f"conv_matmul={conv_matmul!r} is not ported: the port takes "
                                  "False or \"fused\"")


class ResBlock(nn.Module):
    """GroupNorm → SiLU → 3×3 conv, + the time embedding, GroupNorm → SiLU →
    3×3 conv, + the input (through a 1×1 ``conv_shortcut`` when the widths
    differ). With ``conv_matmul="fused"`` each norm → SiLU → conv runs as one
    ``fused_gn_silu_conv3x3`` call on the same submodules (the JAX
    ``ResBlock._fused``)."""

    def __init__(self, in_channels: int, out_channels: int, temb_dim: int,
                 dtype=torch.float32, device=None, fused_gn: bool = False, conv_matmul=False):
        super().__init__()
        _check_conv_matmul(conv_matmul)
        kw = dict(dtype=dtype, device=device)
        self.fused_gn, self.conv_matmul = fused_gn, conv_matmul
        self.norm1 = GroupNorm32(in_channels, device)
        self.conv1 = Conv(in_channels, out_channels, 3, **kw)
        self.time_emb_proj = Dense(temb_dim, out_channels, **kw)
        self.norm2 = GroupNorm32(out_channels, device)
        self.conv2 = Conv(out_channels, out_channels, 3, **kw)
        self.conv_shortcut = (Conv(in_channels, out_channels, 1, **kw)
                              if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        if self.conv_matmul == "fused":
            return self._fused(x, emb)
        h = self.conv1(_group_norm(x, self.norm1, self.fused_gn, silu=True))
        h = h + self.time_emb_proj(F.silu(emb))[:, None, None, :]
        h = self.conv2(_group_norm(h, self.norm2, self.fused_gn, silu=True))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def _fused(self, x: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """The JAX ``ResBlock._fused``: the time embedding added in float32
        and cast back to x's dtype between the two fused calls."""
        n1, n2 = self.norm1.GroupNorm_0, self.norm2.GroupNorm_0
        h = fused_gn_silu_conv3x3(x, n1.weight, n1.bias, self.conv1.weight, self.conv1.bias)
        e = self.time_emb_proj(F.silu(emb))
        h = (h.float() + e.float()[:, None, None, :]).to(x.dtype)
        h = fused_gn_silu_conv3x3(h, n2.weight, n2.bias, self.conv2.weight, self.conv2.bias)
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, Nq, C) x (B, Nk, C) multi-head attention. Over ≤128 keys (the
    77 text tokens) plain torch; longer key sets go through
    ``flash_attention`` in (B·H, N, d) layout."""
    b, nq, c = q.shape
    nk = k.shape[1]
    d = c // heads
    if nk <= 128:
        qh = q.reshape(b, nq, heads, d)
        kh = k.reshape(b, nk, heads, d)
        vh = v.reshape(b, nk, heads, d)
        s = torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float()) / math.sqrt(d)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", p.to(vh.dtype).float(), vh.float())
        return out.to(q.dtype).reshape(b, nq, c)

    def heads_first(t: torch.Tensor, n: int) -> torch.Tensor:
        return t.reshape(b, n, heads, d).transpose(1, 2).reshape(b * heads, n, d).contiguous()

    out = flash_attention(heads_first(q, nq), heads_first(k, nk), heads_first(v, nk))
    return out.reshape(b, heads, nq, d).transpose(1, 2).reshape(b, nq, c)


class TransformerBlock(nn.Module):
    """self-attn → cross-attn → GEGLU FF (diffusers BasicTransformerBlock)."""

    def __init__(self, channels: int, heads: int, context_dim: int,
                 dtype=torch.float32, ln_gemm="geglu", device=None, quant: bool = False,
                 fused_ln: bool = False):
        super().__init__()
        if ln_gemm not in ("geglu", False):
            raise ValueError(f"ln_gemm {ln_gemm!r}: the port has 'geglu' and False")
        c = channels
        kw = dict(quant=quant, dtype=dtype, device=device)
        # the int8 path keeps every LayerNorm standalone (unet.py:386 of the JAX module)
        self.heads, self.ln_gemm = heads, (False if quant else ln_gemm)

        def norm():
            return FusedLayerNorm(c, dtype, device) if fused_ln else LayerNorm(c, device=device)

        self.norm1 = norm()
        self.attn1_qkv = MaybeQuantDense(c, 3 * c, bias=False, **kw)
        self.attn1_out = MaybeQuantDense(c, c, **kw)
        self.norm2 = norm()
        self.attn2_q = MaybeQuantDense(c, c, bias=False, **kw)
        self.attn2_kv = MaybeQuantDense(context_dim, 2 * c, bias=False, **kw)
        self.attn2_out = MaybeQuantDense(c, c, **kw)
        self.norm3 = norm()
        self.ff_geglu = MaybeQuantDense(c, 8 * c, **kw)
        self.ff_out = MaybeQuantDense(4 * c, c, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        qkv = self.attn1_qkv(self.norm1(x))
        x = x + self.attn1_out(
            flash_attention_packed(qkv, self.heads, softmax_mode="rawmax"))
        q = self.attn2_q(self.norm2(x))
        k, v = self.attn2_kv(context).chunk(2, dim=-1)
        x = x + self.attn2_out(_attention(q, k, v, self.heads))
        if self.ln_gemm == "geglu":
            # LayerNorm folded into the GEGLU projection; the weight's
            # transpose view is the (K, N) operand, read without a copy
            b, n, c = x.shape
            h = fused_ln_matmul(x.reshape(b * n, c), self.ff_geglu.weight.t(),
                                self.norm3.weight, self.norm3.bias, self.norm3.eps,
                                self.ff_geglu.bias, geglu=True).reshape(b, n, -1)
        else:
            a, gate = self.ff_geglu(self.norm3(x)).chunk(2, dim=-1)
            h = a * F.gelu(gate)
        return x + self.ff_out(h)


class SpatialTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, depth: int, context_dim: int,
                 dtype=torch.float32, ln_gemm="geglu", device=None, quant: bool = False,
                 fused_ln: bool = False, fused_gn: bool = False):
        super().__init__()
        self.depth = depth
        self.fused_gn = fused_gn
        self.norm = GroupNorm32(channels, device)
        kw = dict(quant=quant, dtype=dtype, device=device)
        self.proj_in = MaybeQuantDense(channels, channels, **kw)
        for i in range(depth):
            self.add_module(f"block{i}", TransformerBlock(
                channels, heads, context_dim, dtype, ln_gemm, device, quant, fused_ln))
        self.proj_out = MaybeQuantDense(channels, channels, **kw)

    def forward(self, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        res = x
        x = _group_norm(x, self.norm, self.fused_gn, silu=False)
        x = self.proj_in(x).reshape(b, h * w, c)
        for i in range(self.depth):
            x = getattr(self, f"block{i}")(x, context)
        return self.proj_out(x.reshape(b, h, w, c)) + res


class Downsample(nn.Module):
    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, stride=2, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest ×2, then a 3×3 conv."""

    def __init__(self, channels: int, dtype=torch.float32, device=None):
        super().__init__()
        self.conv = Conv(channels, channels, 3, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(upsample_nearest2x(x))


def upsample_nearest2x(x: torch.Tensor) -> torch.Tensor:
    """NHWC nearest-neighbour ×2 (``jax.image.resize`` "nearest")."""
    y = F.interpolate(x.permute(0, 3, 1, 2), scale_factor=2, mode="nearest")
    return y.permute(0, 2, 3, 1)


class UNetSDXL(nn.Module):
    """SDXL-base UNet. Inputs NHWC latents (B, H/8, W/8, 4).

    ``text_time`` builds the pooled-text + time-ids added conditioning
    (``add_embed_1/2``); the JAX module creates it when it is initialized with
    those inputs. ``quant``, ``fused_ln``, ``fused_gn`` and
    ``conv_matmul="fused"`` are the JAX module's serving options (see the
    module docstring); a ``quant`` UNet runs after :func:`quantize_unet_`.
    ``num_class_embeds`` adds a learned embedding of ``class_labels`` to the
    time embedding (``class_embed``; the x4 upscaler's noise level).
    ``return_encoder`` / ``cached_encoder`` are Faster-Diffusion encoder
    reuse (arXiv:2312.09608): a call with ``return_encoder`` also returns the
    down path's ``(x, skips)``, and a call given them skips the down path and
    runs mid + up on them (cast to the module's dtype) with its own time
    embedding."""

    def __init__(self, in_channels: int = 4, out_channels: int = 4,
                 block_channels: Sequence[int] = (320, 640, 1280),
                 layers_per_block: int = 2,
                 transformer_depths: Sequence[int] = (0, 2, 10),
                 context_dim: int = 2048, head_dim: int = 64,
                 addition_time_embed_dim: int = 256, pooled_proj_dim: int = 2816,
                 text_time: bool = True, num_class_embeds: Optional[int] = None,
                 quant: bool = False, ln_gemm="geglu", fused_ln: bool = False,
                 fused_gn: bool = False, conv_matmul=False, dtype=torch.float32, device=None):
        super().__init__()
        _check_conv_matmul(conv_matmul)
        self.quant, self.fused_gn, self.conv_matmul = quant, fused_gn, conv_matmul
        self.in_channels = in_channels
        self.block_channels = tuple(block_channels)
        self.layers_per_block = layers_per_block
        self.transformer_depths = tuple(transformer_depths)
        self.context_dim = context_dim
        self.addition_time_embed_dim = addition_time_embed_dim
        self.dtype = dtype
        kw = dict(dtype=dtype, device=device)
        ch0 = self.block_channels[0]
        temb = 4 * ch0
        self.time_embed_1 = Dense(ch0, temb, **kw)
        self.time_embed_2 = Dense(temb, temb, **kw)
        if text_time:
            self.add_embed_1 = Dense(pooled_proj_dim, temb, **kw)
            self.add_embed_2 = Dense(temb, temb, **kw)
        if num_class_embeds is not None:
            self.class_embed = nn.Embedding(num_class_embeds, temb, **kw)
        self.conv_in = Conv(in_channels, ch0, 3, **kw)

        def attn(name, ch, depth):
            if depth:
                self.add_module(name, SpatialTransformer(
                    ch, ch // head_dim, depth, context_dim, dtype, ln_gemm, device, quant,
                    fused_ln, fused_gn))

        def res(cin, cout):
            return ResBlock(cin, cout, temb, dtype, device, fused_gn, conv_matmul)

        cur, skips = ch0, [ch0]
        n = len(self.block_channels)
        for lvl, ch in enumerate(self.block_channels):
            for i in range(layers_per_block):
                self.add_module(f"down{lvl}_res{i}", res(cur, ch))
                attn(f"down{lvl}_attn{i}", ch, self.transformer_depths[lvl])
                cur = ch
                skips.append(ch)
            if lvl < n - 1:
                self.add_module(f"down{lvl}_ds", Downsample(ch, **kw))
                skips.append(ch)
        self.mid_res0 = res(cur, cur)
        attn("mid_attn", cur, self.transformer_depths[-1])
        self.mid_res1 = res(cur, cur)
        for lvl in reversed(range(n)):
            ch = self.block_channels[lvl]
            for i in range(layers_per_block + 1):
                self.add_module(f"up{lvl}_res{i}", res(cur + skips.pop(), ch))
                attn(f"up{lvl}_attn{i}", ch, self.transformer_depths[lvl])
                cur = ch
            if lvl > 0:
                self.add_module(f"up{lvl}_us", Upsample(ch, **kw))
        self.norm_out = GroupNorm32(cur, device)
        # conv_out runs in float32, as in the JAX module
        self.conv_out = Conv(cur, out_channels, 3, dtype=torch.float32, device=device)

    def _attn(self, name: str, x: torch.Tensor, context: torch.Tensor) -> torch.Tensor:
        block = getattr(self, name, None)
        return x if block is None else block(x, context)

    def forward(self, latents: torch.Tensor, timesteps: torch.Tensor,
                context: torch.Tensor, pooled_text: Optional[torch.Tensor] = None,
                time_ids: Optional[torch.Tensor] = None,
                class_labels: Optional[torch.Tensor] = None,
                cached_encoder: Optional[Tuple] = None,
                return_encoder: bool = False):
        ch0 = self.block_channels[0]
        emb = self.time_embed_1(timestep_embedding(timesteps, ch0))
        emb = self.time_embed_2(F.silu(emb))
        if pooled_text is not None and time_ids is not None:
            ids = timestep_embedding(time_ids.reshape(-1), self.addition_time_embed_dim)
            ids = ids.reshape(latents.shape[0], -1)
            add = torch.cat([pooled_text, ids.to(pooled_text.dtype)], dim=-1)
            add = self.add_embed_2(F.silu(self.add_embed_1(add)))
            emb = emb + add
        if class_labels is not None and hasattr(self, "class_embed"):
            emb = emb + self.class_embed(class_labels.long())

        context = context.to(self.dtype)
        n = len(self.block_channels)
        if cached_encoder is None:
            x = self.conv_in(latents)
            skips = [x]
            for lvl in range(n):
                for i in range(self.layers_per_block):
                    x = getattr(self, f"down{lvl}_res{i}")(x, emb)
                    x = self._attn(f"down{lvl}_attn{i}", x, context)
                    skips.append(x)
                if lvl < n - 1:
                    x = getattr(self, f"down{lvl}_ds")(x)
                    skips.append(x)
        else:
            x, cached_skips = cached_encoder
            x = x.to(self.dtype)
            skips = [s.to(self.dtype) for s in cached_skips]
        encoder_state = (x, tuple(skips))
        x = self.mid_res0(x, emb)
        x = self._attn("mid_attn", x, context)
        x = self.mid_res1(x, emb)
        for lvl in reversed(range(n)):
            for i in range(self.layers_per_block + 1):
                x = torch.cat([x, skips.pop()], dim=-1)
                x = getattr(self, f"up{lvl}_res{i}")(x, emb)
                x = self._attn(f"up{lvl}_attn{i}", x, context)
            if lvl > 0:
                x = getattr(self, f"up{lvl}_us")(x)
        x = _group_norm(x, self.norm_out, self.fused_gn, silu=True)
        x = self.conv_out(x)
        return (x, encoder_state) if return_encoder else x

    @classmethod
    def tiny(cls, **kw) -> "UNetSDXL":
        """Small config for tests."""
        kw.setdefault("text_time", False)
        return cls(block_channels=(32, 64), transformer_depths=(0, 1), context_dim=64,
                   head_dim=16, layers_per_block=1, **kw)
