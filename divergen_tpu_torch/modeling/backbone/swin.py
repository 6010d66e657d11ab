"""Swin Transformer backbone (torch), NHWC.

Counterpart of ``divergen_tpu/modeling/backbone/swin.py``: window attention
with a relative-position bias, shifted windows, patch merging, four stages
named ``s2..s5`` (strides 4/8/16/32). Submodules carry the flax scope names
(``patch_embed``, ``stage0_block1.attn.qkv``, ``merge0.reduction``,
``s3_norm``, …), so ``utils.convert.params_from_jax`` maps a flax tree
mechanically.

Every W-MSA goes through ``ops.window_attention.fused_window_attention_packed``:
the hand-written kernel on the card, its plain version on the CPU, at any
head count. The shift mask and the relative-position index are computed from
static shapes with numpy and cached.

Window shrinking. As in the JAX package a block whose feature map is smaller
than the window attends over ``min(window, h, w)`` tokens a side, with no
shift, and its bias table then has ``(2·shrunk − 1)²`` rows. A flax module
sizes that table from the input it sees at ``init``; an ``nn.Module`` has to
know at construction. ``SwinTransformer(input_size=(H, W))`` names the
canvas the model is built for and sizes every block's table from it;
``input_size=None`` means no block shrinks (full tables, which is what a
published checkpoint holds, and what any input with a last-stage map of at
least the window needs, e.g. 896² at window 12). A forward whose maps would
shrink a window to another size than the block was built for raises.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ...ops.tracing import real
from ...ops.window_attention import fused_window_attention_packed
from ..layers import Conv, Dense, DropPath, LayerNorm

SIZE2CONFIG = {
    # embed_dim, depths, num_heads, window, drop_path_rate
    "T": (96, (2, 2, 6, 2), (3, 6, 12, 24), 7, 0.2),
    "S": (96, (2, 2, 18, 2), (3, 6, 12, 24), 7, 0.2),
    "B": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7, 0.3),
    "B-22k": (128, (2, 2, 18, 2), (4, 8, 16, 32), 7, 0.3),
    "B-22k-384": (128, (2, 2, 18, 2), (4, 8, 16, 32), 12, 0.3),
    "L-22k": (192, (2, 2, 18, 2), (6, 12, 24, 48), 7, 0.3),
    "L-22k-384": (192, (2, 2, 18, 2), (6, 12, 24, 48), 12, 0.3),
}

LN_EPS = 1e-5  # every LayerNorm of the Swin trunk


@functools.lru_cache(maxsize=None)
def _relative_position_index(window: int) -> np.ndarray:
    """(W·W, W·W) int index into the (2W−1)² bias table."""
    coords = np.stack(np.meshgrid(np.arange(window), np.arange(window), indexing="ij"))
    flat = coords.reshape(2, -1)
    rel = flat[:, :, None] - flat[:, None, :]  # 2, W·W, W·W
    rel = rel.transpose(1, 2, 0) + (window - 1)
    return (rel[:, :, 0] * (2 * window - 1) + rel[:, :, 1]).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _shift_attn_mask(hp: int, wp: int, window: int, shift: int) -> np.ndarray:
    """(num_windows, W·W, W·W) additive mask for shifted windows: −100 between
    tokens that the cyclic shift brought together from different regions."""
    img = np.zeros((hp, wp), np.int32)
    cnt = 0
    for hs in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
        for ws in (slice(0, -window), slice(-window, -shift), slice(-shift, None)):
            img[hs, ws] = cnt
            cnt += 1
    win = img.reshape(hp // window, window, wp // window, window)
    win = win.transpose(0, 2, 1, 3).reshape(-1, window * window)
    diff = win[:, None, :] != win[:, :, None]
    return np.where(diff, -100.0, 0.0).astype(np.float32)


def _shift_attn_mask_on(hp: int, wp: int, window: int, shift: int,
                        device: torch.device) -> torch.Tensor:
    """The shift mask as a float32 tensor on ``device``, kept between calls
    (at 224 × 224 tokens and window 12 it is 361 windows of 144 × 144). It
    is made on real tensors even under a tracer (``ops.tracing.real``), so
    the cache never holds a fake one and an exported program holds the mask
    as a constant on the device."""
    return real(lambda: _shift_attn_mask_cached(hp, wp, window, shift, device))


@functools.lru_cache(maxsize=32)
def _shift_attn_mask_cached(hp: int, wp: int, window: int, shift: int,
                            device: torch.device) -> torch.Tensor:
    return torch.from_numpy(_shift_attn_mask(hp, wp, window, shift)).to(device)


def window_partition(x: torch.Tensor, window: int) -> torch.Tensor:
    """(B, H, W, C) → (B·nW, window·window, C), windows batch-major; H and W
    are multiples of window."""
    b, h, w, c = x.shape
    x = x.reshape(b, h // window, window, w // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window * window, c)


def window_reverse(x: torch.Tensor, window: int, h: int, w: int) -> torch.Tensor:
    b = x.shape[0] // ((h // window) * (w // window))
    x = x.reshape(b, h // window, w // window, window, window, -1).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, h, w, -1)


class WindowAttention(nn.Module):
    """W-MSA with a relative-position bias over windows of ``window`` ×
    ``window`` tokens. The bias table stays float32."""

    raw_init_std = {"relative_position_bias_table": 0.02}

    def __init__(self, dim: int, window: int, num_heads: int, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.dim, self.window, self.num_heads, self.dtype = dim, window, num_heads, dtype
        self.qkv = Dense(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Dense(dim, dim, dtype=dtype, device=device)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window - 1) ** 2, num_heads, device=device))
        index = torch.from_numpy(_relative_position_index(window).reshape(-1)).long()
        self.register_buffer("relative_position_index", index.to(device), persistent=False)

    def relative_position_bias(self) -> torch.Tensor:
        """(heads, n, n) float32, gathered from the table."""
        n = self.window * self.window
        bias = self.relative_position_bias_table[self.relative_position_index]
        return bias.reshape(n, n, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x (bn, n, C) windows; mask (nW, n, n) float32 or None."""
        qkv, bias = self.qkv(x), self.relative_position_bias()
        return self.proj(fused_window_attention_packed(qkv, bias, mask, self.num_heads))


class SwinBlock(nn.Module):
    """One (shifted-)window transformer block. ``window`` is the configured
    window and ``built_window`` the possibly smaller one the block was sized
    for (see the module docstring)."""

    def __init__(self, dim: int, num_heads: int, window: int, shift: int,
                 mlp_ratio: float = 4.0, drop_path: float = 0.0, dtype=torch.float32,
                 built_window: Optional[int] = None, device=None):
        super().__init__()
        self.window, self.shift = window, shift
        self.built_window = window if built_window is None else built_window
        self.norm1 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.attn = WindowAttention(dim, self.built_window, num_heads, dtype=dtype,
                                    device=device)
        self.drop_path = DropPath(drop_path)
        self.norm2 = LayerNorm(dim, eps=LN_EPS, device=device)
        self.mlp_fc1 = Dense(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.mlp_fc2 = Dense(int(dim * mlp_ratio), dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> torch.Tensor:
        b, h, w, c = x.shape
        window = min(self.window, h, w)
        if window != self.built_window:
            raise ValueError(
                f"a {h} x {w} feature map needs windows of {window}, but this block was built "
                f"for windows of {self.built_window}: build the model with the input_size "
                "it is called with")
        shift = self.shift if window == self.window else 0
        shortcut = x
        x = self.norm1(x)
        # padding comes after the norm: pad tokens are exact zeros and take
        # part as keys
        pad_b = (window - h % window) % window
        pad_r = (window - w % window) % window
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        hp, wp = h + pad_b, w + pad_r
        mask = None
        if shift > 0:
            x = torch.roll(x, (-shift, -shift), dims=(1, 2))
            mask = _shift_attn_mask_on(hp, wp, window, shift, x.device)
        xw = self.attn(window_partition(x, window), mask)
        x = window_reverse(xw, window, hp, wp)
        if shift > 0:
            x = torch.roll(x, (shift, shift), dims=(1, 2))
        if pad_b or pad_r:
            x = x[:, :h, :w]
        x = shortcut + self.drop_path(x, deterministic)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + self.drop_path(y, deterministic)


class PatchMerging(nn.Module):
    """2×2 patch merge and channel doubling; odd sizes are zero-padded
    first. The four patches are concatenated dw-major, dh-minor."""

    def __init__(self, dim: int, dtype=torch.float32, device=None):
        super().__init__()
        self.norm = LayerNorm(4 * dim, eps=LN_EPS, device=device)
        self.reduction = Dense(4 * dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, c = x.shape
        if h % 2 or w % 2:
            x = F.pad(x, (0, 0, 0, w % 2, 0, h % 2))
            h, w = h + h % 2, w + w % 2
        x = x.reshape(b, h // 2, 2, w // 2, 2, c).permute(0, 1, 3, 4, 2, 5)
        return self.reduction(self.norm(x.reshape(b, h // 2, w // 2, 4 * c)))


def stage_map_sizes(input_size: Tuple[int, int], patch_size: int,
                    num_stages: int) -> Tuple[Tuple[int, int], ...]:
    """The (h, w) token maps of the stages for an (H, W) input."""
    h = -(-input_size[0] // patch_size)
    w = -(-input_size[1] // patch_size)
    sizes = []
    for _ in range(num_stages):
        sizes.append((h, w))
        h, w = -(-h // 2), -(-w // 2)
    return tuple(sizes)


class SwinTransformer(nn.Module):
    """Four-stage Swin pyramid: ``{"s2": stride 4, …, "s5": stride 32}`` from
    (B, H, W, 3) input already normalized and in the compute dtype.

    ``input_size`` is the (H, W) canvas the model is built for, or None for
    "no window shrinks" (module docstring). With ``remat`` each block runs
    under ``torch.utils.checkpoint`` whenever gradients are recorded (the JAX
    package wraps its blocks in ``nn.remat``): the block's activations are
    dropped after the forward and recomputed in the backward, so its window
    attention launches twice per step."""

    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window: int = 7,
                 mlp_ratio: float = 4.0, drop_path_rate: float = 0.2, patch_size: int = 4,
                 out_features: Sequence[str] = ("s2", "s3", "s4", "s5"),
                 dtype=torch.float32, remat: bool = False,
                 input_size: Optional[Tuple[int, int]] = None, device=None):
        super().__init__()
        self.patch_size, self.depths, self.out_features = patch_size, tuple(depths), tuple(out_features)
        self.dtype, self.remat = dtype, remat
        self.patch_embed = Conv(3, embed_dim, patch_size, stride=patch_size, padding=0,
                                dtype=dtype, device=device)
        self.patch_norm = LayerNorm(embed_dim, eps=LN_EPS, device=device)
        total = sum(depths)
        dprs = [drop_path_rate * i / max(total - 1, 1) for i in range(total)]
        maps = (stage_map_sizes(input_size, patch_size, len(depths)) if input_size is not None
                else ((window, window),) * len(depths))
        dim, blk = embed_dim, 0
        for stage, depth in enumerate(depths):
            for i in range(depth):
                self.add_module(f"stage{stage}_block{i}", SwinBlock(
                    dim, num_heads[stage], window, 0 if i % 2 == 0 else window // 2,
                    mlp_ratio, dprs[blk], dtype=dtype,
                    built_window=min(window, *maps[stage]), device=device))
                blk += 1
            if f"s{stage + 2}" in self.out_features:
                self.add_module(f"s{stage + 2}_norm", LayerNorm(dim, eps=LN_EPS, device=device))
            if stage < len(depths) - 1:
                self.add_module(f"merge{stage}", PatchMerging(dim, dtype=dtype, device=device))
                dim *= 2

    @classmethod
    def from_size(cls, size: str, dtype=torch.float32, remat: bool = False,
                  **kw) -> "SwinTransformer":
        embed, depths, heads, window, dpr = SIZE2CONFIG[size]
        return cls(embed_dim=embed, depths=depths, num_heads=heads, window=window,
                   drop_path_rate=dpr, dtype=dtype, remat=remat, **kw)

    def forward(self, x: torch.Tensor, deterministic: bool = True) -> Dict[str, torch.Tensor]:
        p = self.patch_size
        _, h, w, _ = x.shape
        pad_b = (p - h % p) % p
        pad_r = (p - w % p) % p
        if pad_b or pad_r:
            x = F.pad(x, (0, 0, 0, pad_r, 0, pad_b))
        x = self.patch_norm(self.patch_embed(x))
        outputs: Dict[str, torch.Tensor] = {}
        for stage, depth in enumerate(self.depths):
            for i in range(depth):
                block = getattr(self, f"stage{stage}_block{i}")
                if self.remat and torch.is_grad_enabled():
                    # nothing random runs in a block unless DropPath is on
                    x = checkpoint(block, x, deterministic, use_reentrant=False,
                                   preserve_rng_state=not deterministic)
                else:
                    x = block(x, deterministic)
            name = f"s{stage + 2}"
            if name in self.out_features:
                outputs[name] = getattr(self, f"{name}_norm")(x)
            if stage < len(self.depths) - 1:
                x = getattr(self, f"merge{stage}")(x)
        return outputs
