"""CLIP text and vision towers (torch).

Counterpart of ``divergen_tpu/modeling/text/clip.py``: pre-LN residual
blocks, QuickGELU (OpenAI CLIP) or exact GELU (OpenCLIP bigG), a causal mask
of -1e9, argmax-EOT pooling, and the penultimate hidden states that SDXL
conditions on. Submodules carry the flax scope names (``resblock{i}.ln_1``,
``attn.in_proj``, ``mlp_c_fc``, …) so ``utils.convert.params_from_jax`` maps
the JAX tree one to one. ``CLIPVision`` is the ViT tower with cls-token
pooling that the filtration stage scores images with: 257 tokens at d = 64,
dense attention as in the JAX package. Every LayerNorm here has eps 1e-5.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..layers import Conv, Dense, LayerNorm


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


class CLIPVision(nn.Module):
    """ViT tower with cls-token pooling and output projection."""

    def __init__(self, embed_dim: int = 768, image_size: int = 224, patch: int = 14,
                 width: int = 1024, heads: int = 16, layers: int = 24,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.layers, self.width, self.dtype = layers, width, dtype
        self.conv1 = Conv(3, width, patch, stride=patch, padding=0, bias=False, dtype=dtype,
                          device=device)
        n_pos = (image_size // patch) ** 2 + 1
        self.class_embedding = nn.Parameter(torch.zeros(width, device=device))
        self.positional_embedding = nn.Parameter(torch.zeros(n_pos, width, device=device))
        self.ln_pre = LayerNorm(width, device=device)
        for i in range(layers):
            self.add_module(f"resblock{i}",
                            ResidualAttentionBlock(width, heads, dtype, device=device))
        self.ln_post = LayerNorm(width, device=device)
        self.proj = nn.Parameter(torch.zeros(width, embed_dim, device=device))
        self.raw_init_std = {"class_embedding": 0.02, "positional_embedding": 0.02,
                             "proj": width**-0.5}

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images (B, H, W, 3) normalized → (B, embed_dim)."""
        b = images.shape[0]
        x = self.conv1(images).reshape(b, -1, self.width)
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = self.ln_pre(x + self.positional_embedding[None, : x.shape[1]].to(x.dtype))
        for i in range(self.layers):
            x = getattr(self, f"resblock{i}")(x)
        x = self.ln_post(x[:, 0])
        return x @ self.proj.to(x.dtype)


CLIP_CONFIGS = {
    # embed_dim, vision(width, layers, heads, patch), text(width, layers, heads)
    "ViT-B/32": (512, (768, 12, 12, 32), (512, 12, 8)),
    "ViT-B/16": (512, (768, 12, 12, 16), (512, 12, 8)),
    "ViT-L/14": (768, (1024, 24, 16, 14), (768, 12, 12)),
}

CLIP_PIXEL_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_PIXEL_STD = (0.26862954, 0.26130258, 0.27577711)


def build_clip(name: str = "ViT-L/14", image_size: int = 224, dtype=torch.float32,
               device=None) -> Tuple[CLIPVision, CLIPText]:
    embed, (vw, vl, vh, vp), (tw, tl, th) = CLIP_CONFIGS[name]
    vision = CLIPVision(embed_dim=embed, image_size=image_size, patch=vp, width=vw,
                        heads=vh, layers=vl, dtype=dtype, device=device)
    text = CLIPText(embed_dim=embed, width=tw, heads=th, layers=tl, dtype=dtype,
                    device=device)
    return vision, text


def preprocess_images(images: torch.Tensor) -> torch.Tensor:
    """uint8/float RGB 0..255 (B, H, W, 3) → CLIP-normalized float32."""
    x = images.float() / 255.0
    mean = torch.tensor(CLIP_PIXEL_MEAN, device=x.device)
    std = torch.tensor(CLIP_PIXEL_STD, device=x.device)
    return (x - mean) / std


def normalize(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return v / torch.linalg.norm(v, dim=dim, keepdim=True).clamp_min(1e-8)


def build_sdxl_text_towers(dtype=torch.float32, device=None) -> Tuple[CLIPText, CLIPText]:
    """The two SDXL conditioning towers: CLIP ViT-L/14 text (768 wide,
    QuickGELU) and OpenCLIP ViT-bigG/14 text (1280 wide, exact GELU, 1280-d
    projection)."""
    clip_l = CLIPText(embed_dim=768, width=768, heads=12, layers=12, dtype=dtype,
                      device=device)
    big_g = CLIPText(embed_dim=1280, width=1280, heads=20, layers=32, dtype=dtype,
                     act="gelu", device=device)
    return clip_l, big_g
