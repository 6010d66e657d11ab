"""CLIP text towers (torch).

Counterpart of ``divergen_tpu/modeling/text/clip.py``: pre-LN residual
blocks, QuickGELU (OpenAI CLIP) or exact GELU (OpenCLIP bigG), a causal mask
of -1e9, argmax-EOT pooling, and the penultimate hidden states that SDXL
conditions on. Submodules carry the flax scope names (``resblock{i}.ln_1``,
``attn.in_proj``, ``mlp_c_fc``, …) so ``utils.convert.params_from_jax`` maps
the JAX tree one to one. ``CLIPVision`` comes with the filtration slice.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Dense, LayerNorm


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(1.702 * x)


class MultiHeadAttention(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32, device=None):
        super().__init__()
        self.width, self.heads = width, heads
        self.in_proj = Dense(width, 3 * width, dtype=dtype, device=device)
        self.out_proj = Dense(width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, c = x.shape
        d = self.width // self.heads
        q, k, v = self.in_proj(x).chunk(3, dim=-1)
        q = q.reshape(b, n, self.heads, d)
        k = k.reshape(b, n, self.heads, d)
        v = v.reshape(b, n, self.heads, d)
        attn = torch.einsum("bnhd,bmhd->bhnm", (q * d**-0.5).float(), k.float())
        if mask is not None:
            attn = attn + mask.float()
        attn = torch.softmax(attn, dim=-1).to(q.dtype)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, c)
        return self.out_proj(out)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int, dtype=torch.float32,
                 act: str = "quick_gelu", device=None):
        super().__init__()
        self.act = act
        self.ln_1 = LayerNorm(width, device=device)
        self.attn = MultiHeadAttention(width, heads, dtype, device)
        self.ln_2 = LayerNorm(width, device=device)
        self.mlp_c_fc = Dense(width, 4 * width, dtype=dtype, device=device)
        self.mlp_c_proj = Dense(4 * width, width, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attn(self.ln_1(x), mask)
        y = self.mlp_c_fc(self.ln_2(x))
        y = quick_gelu(y) if self.act == "quick_gelu" else F.gelu(y)
        return x + self.mlp_c_proj(y)


class CLIPText(nn.Module):
    """Causal text transformer; returns the projected EOT embedding."""

    def __init__(self, embed_dim: int = 768, context_length: int = 77,
                 vocab_size: int = 49408, width: int = 768, heads: int = 12,
                 layers: int = 12, dtype=torch.float32, act: str = "quick_gelu",
                 device=None):
        super().__init__()
        self.layers = layers
        self.dtype = dtype
        self.token_embedding = nn.Embedding(vocab_size, width, dtype=dtype, device=device)
        self.positional_embedding = nn.Parameter(
            torch.zeros(context_length, width, device=device))
        for i in range(layers):
            self.add_module(f"resblock{i}", ResidualAttentionBlock(width, heads, dtype, act, device))
        self.ln_final = LayerNorm(width, device=device)
        self.text_projection = nn.Parameter(torch.zeros(width, embed_dim, device=device))
        self.raw_init_std = {"positional_embedding": 0.01, "text_projection": width**-0.5}

    def forward(self, tokens: torch.Tensor, return_sequence: bool = False,
                penultimate: bool = False):
        """tokens (B, L) int. Default: projected EOT embedding (B, embed_dim).
        With ``return_sequence``: also the hidden states, final-LN output or
        the penultimate layer's raw states (``penultimate=True``, SDXL's
        conditioning)."""
        b, l = tokens.shape
        x = self.token_embedding(tokens) + self.positional_embedding[:l].to(self.dtype)[None]
        mask = torch.triu(torch.full((l, l), -1e9, device=tokens.device), diagonal=1)[None, None]
        hidden = None
        for i in range(self.layers):
            if i == self.layers - 1:
                hidden = x  # penultimate hidden states
            x = getattr(self, f"resblock{i}")(x, mask)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)  # EOT has the largest id (CLIP convention)
        pooled = x[torch.arange(b, device=x.device), eot] @ self.text_projection.to(x.dtype)
        if return_sequence:
            return pooled, (hidden if penultimate else x)
        return pooled


def build_sdxl_text_towers(dtype=torch.float32, device=None) -> Tuple[CLIPText, CLIPText]:
    """The two SDXL conditioning towers: CLIP ViT-L/14 text (768 wide,
    QuickGELU) and OpenCLIP ViT-bigG/14 text (1280 wide, exact GELU, 1280-d
    projection)."""
    clip_l = CLIPText(embed_dim=768, width=768, heads=12, layers=12, dtype=dtype,
                      device=device)
    big_g = CLIPText(embed_dim=1280, width=1280, heads=20, layers=32, dtype=dtype,
                     act="gelu", device=device)
    return clip_l, big_g
