"""SAM (Segment Anything) in torch: image encoder, prompt encoder and mask
decoder behind one call.

Counterpart of ``divergen_tpu/pipeline/segmentation/sam.py``: a ViTDet-style
plain ViT (windowed attention of size 14 with 4 global layers, decomposed
relative positions) with a 256-channel neck; a prompt encoder with
random-fourier positional encoding and learned point-type embeddings; a
two-way transformer decoder emitting 3 ranked masks and IoU scores. One
``SAM.forward`` is set_image + predict on a batch of images. Submodules carry
the flax scope names, so ``utils.convert.params_from_jax(tree, sam)`` maps the
JAX tree one to one.

Only the encoder takes a compute ``dtype``; the prompt encoder and the decoder
hold float32 weights and run in float32 on the encoder's embedding.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ...modeling.backbone.vit import LN_EPS, ViTBlock
from ...modeling.layers import Conv, ConvTranspose, Dense, LayerNorm


# ---------------- image encoder (ViTDet) ----------------
class SAMImageEncoder(nn.Module):
    def __init__(self, img_size: int = 1024, patch: int = 16, dim: int = 1280,
                 layers: int = 32, heads: int = 16, window: int = 14,
                 global_layers: Tuple[int, ...] = (7, 15, 23, 31), out_channels: int = 256,
                 dtype=torch.float32, ln_gemm: bool = False, flash_attn: bool = False,
                 device=None):
        super().__init__()
        self.img_size, self.patch, self.dim, self.layers = img_size, patch, dim, layers
        self.heads, self.window, self.global_layers = heads, window, tuple(global_layers)
        self.out_channels, self.dtype = out_channels, dtype
        grid = img_size // patch
        self.patch_embed = Conv(3, dim, patch, stride=patch, padding=0, dtype=dtype,
                                device=device)
        self.pos_embed = nn.Parameter(torch.zeros(grid, grid, dim, device=device))
        self.raw_init_std = {"pos_embed": 0.02}
        for i in range(layers):
            win = 0 if i in global_layers else window
            self.add_module(f"block{i}", ViTBlock(
                dim, heads, win, dtype, ln_gemm=ln_gemm, flash_attn=flash_attn,
                input_hw=(grid, grid), device=device))
        # neck: 1x1 → LN → 3x3 → LN, convs without bias
        self.neck_conv1 = Conv(dim, out_channels, 1, bias=False, dtype=dtype, device=device)
        self.neck_ln1 = LayerNorm(out_channels, eps=LN_EPS, device=device)
        self.neck_conv2 = Conv(out_channels, out_channels, 3, bias=False, dtype=dtype,
                               device=device)
        self.neck_ln2 = LayerNorm(out_channels, eps=LN_EPS, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(B, S, S, 3) normalized → (B, S/16, S/16, 256)."""
        x = self.patch_embed(x)
        x = x + self.pos_embed[None, : x.shape[1], : x.shape[2]].to(x.dtype)
        for i in range(self.layers):
            x = getattr(self, f"block{i}")(x)
        x = self.neck_ln1(self.neck_conv1(x))
        return self.neck_ln2(self.neck_conv2(x))


# ---------------- prompt encoder ----------------
class PromptEncoder(nn.Module):
    def __init__(self, embed_dim: int = 256, img_size: int = 1024, device=None):
        super().__init__()
        self.img_size = img_size
        self.pe_gaussian = nn.Parameter(torch.zeros(2, embed_dim // 2, device=device))
        for name in ("point_fg", "point_bg", "not_a_point", "no_mask_embed"):
            setattr(self, name, nn.Parameter(torch.zeros(embed_dim, device=device)))
        self.raw_init_std = dict.fromkeys(
            ("pe_gaussian", "point_fg", "point_bg", "not_a_point", "no_mask_embed"), 1.0)

    def _fourier(self, coords: torch.Tensor) -> torch.Tensor:
        proj = (2.0 * coords - 1.0) @ self.pe_gaussian * (2.0 * math.pi)
        return torch.cat([torch.sin(proj), torch.cos(proj)], dim=-1)

    def forward(self, points: torch.Tensor, labels: torch.Tensor):
        """points (B, P, 2) xy pixels; labels (B, P) 1 = fg, 0 = bg, -1 = pad.
        Returns (sparse (B, P, C), the dense no-mask embedding (C,))."""
        emb = self._fourier(points / self.img_size)
        fg, bg, pad = self.point_fg, self.point_bg, self.not_a_point
        type_emb = torch.where((labels == 1)[..., None], fg,
                               torch.where((labels == 0)[..., None], bg, pad))
        emb = torch.where((labels < 0)[..., None], pad, emb + type_emb)
        return emb, self.no_mask_embed

    def dense_pe(self, hw: Tuple[int, int]) -> torch.Tensor:
        """Positional encoding over the embedding grid, (h, w, C)."""
        h, w = hw
        dev = self.pe_gaussian.device
        ys = (torch.arange(h, dtype=torch.float32, device=dev) + 0.5) / h
        xs = (torch.arange(w, dtype=torch.float32, device=dev) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        return self._fourier(torch.stack([gx, gy], dim=-1))  # xy order


# ---------------- mask decoder ----------------
class TwoWayAttention(nn.Module):
    def __init__(self, dim: int, heads: int, downsample: int = 1, device=None):
        super().__init__()
        self.heads = heads
        self.d_model = dim // downsample
        self.q = Dense(dim, self.d_model, device=device)
        self.k = Dense(dim, self.d_model, device=device)
        self.v = Dense(dim, self.d_model, device=device)
        self.out = Dense(self.d_model, dim, device=device)

    def forward(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
        d = self.d_model // self.heads
        b, nq, _ = q.shape
        nk = k.shape[1]
        qq = self.q(q).reshape(b, nq, self.heads, d)
        kk = self.k(k).reshape(b, nk, self.heads, d)
        vv = self.v(v).reshape(b, nk, self.heads, d)
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", qq * d**-0.5, kk), dim=-1)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, vv).reshape(b, nq, self.d_model)
        return self.out(out)


class TwoWayBlock(nn.Module):
    def __init__(self, dim: int = 256, heads: int = 8, device=None):
        super().__init__()
        self.self_attn = TwoWayAttention(dim, heads, device=device)
        self.t2i = TwoWayAttention(dim, heads, 2, device=device)
        self.i2t = TwoWayAttention(dim, heads, 2, device=device)
        self.mlp1 = Dense(dim, 2048, device=device)
        self.mlp2 = Dense(2048, dim, device=device)
        for name in ("ln1", "ln2", "ln3", "ln4"):
            setattr(self, name, LayerNorm(dim, eps=LN_EPS, device=device))

    def forward(self, tokens, image, token_pe, image_pe, first: bool = False):
        # the first block skips the PE and the residual on self-attention
        if first:
            tokens = self.ln1(self.self_attn(tokens, tokens, tokens))
        else:
            q = tokens + token_pe
            tokens = self.ln1(tokens + self.self_attn(q, q, tokens))
        q = tokens + token_pe
        k = image + image_pe
        tokens = self.ln2(tokens + self.t2i(q, k, image))
        tokens = self.ln3(tokens + self.mlp2(F.relu(self.mlp1(tokens))))
        q = tokens + token_pe
        image = self.ln4(image + self.i2t(k, q, tokens))
        return tokens, image


class MaskDecoder(nn.Module):
    """Token slots are [iou, mask0 … mask3]; the multimask outputs are mask
    slots 1..3, and ``hyper{slot}_fc{j}`` is indexed by the absolute slot."""

    def __init__(self, dim: int = 256, num_masks: int = 3, num_mask_tokens: int = 4,
                 depth: int = 2, device=None):
        super().__init__()
        self.dim, self.num_masks, self.num_mask_tokens, self.depth = (
            dim, num_masks, num_mask_tokens, depth)
        self.first_slot = 1 if num_mask_tokens > num_masks else 0
        self.output_tokens = nn.Parameter(torch.zeros(1 + num_mask_tokens, dim, device=device))
        self.raw_init_std = {"output_tokens": 1.0}
        for i in range(depth):
            self.add_module(f"block{i}", TwoWayBlock(dim, device=device))
        self.final_t2i = TwoWayAttention(dim, 8, 2, device=device)
        self.ln_final = LayerNorm(dim, eps=LN_EPS, device=device)
        self.up1 = ConvTranspose(dim, dim // 4, 2, device=device)
        self.up_ln = LayerNorm(dim // 4, eps=LN_EPS, device=device)
        self.up2 = ConvTranspose(dim // 4, dim // 8, 2, device=device)
        for m in range(num_masks):
            for j in range(3):
                self.add_module(f"hyper{self.first_slot + m}_fc{j}",
                                Dense(dim, dim // 8 if j == 2 else dim, device=device))
        for j in range(3):
            self.add_module(f"iou_fc{j}",
                            Dense(dim, num_mask_tokens if j == 2 else dim, device=device))

    def forward(self, image_emb: torch.Tensor, image_pe: torch.Tensor, sparse: torch.Tensor,
                dense: Optional[torch.Tensor] = None):
        """image_emb (B, h, w, C); image_pe (h, w, C); sparse (B, P, C); dense
        optional (C,) or (B, h, w, C), added to the image embedding. Returns
        the multimask outputs: masks (B, 3, 4h, 4w) and iou (B, 3)."""
        b, h, w, c = image_emb.shape
        if dense is not None:
            image_emb = image_emb + dense
        tokens = torch.cat([self.output_tokens.expand(b, -1, -1), sparse], dim=1)
        token_pe = tokens  # SAM uses the original tokens as their own PE
        image = image_emb.reshape(b, h * w, c)
        pe = image_pe.reshape(1, h * w, c).expand(b, -1, -1)
        for i in range(self.depth):
            tokens, image = getattr(self, f"block{i}")(tokens, image, token_pe, pe,
                                                       first=(i == 0))
        q = tokens + token_pe
        tokens = self.ln_final(tokens + self.final_t2i(q, image + pe, image))
        iou = tokens[:, 0]
        s0 = self.first_slot
        mask_tokens = tokens[:, 1 + s0: 1 + s0 + self.num_masks]
        img = F.gelu(self.up_ln(self.up1(image.reshape(b, h, w, c))))
        img = F.gelu(self.up2(img))  # (B, 4h, 4w, C/8)
        hyper = []
        for m in range(self.num_masks):
            y = mask_tokens[:, m]
            for j in range(3):
                y = getattr(self, f"hyper{s0 + m}_fc{j}")(y if j == 0 else F.relu(y))
            hyper.append(y)
        masks = torch.einsum("bmc,bhwc->bmhw", torch.stack(hyper, dim=1), img)
        for j in range(3):
            iou = getattr(self, f"iou_fc{j}")(iou if j == 0 else F.relu(iou))
        return masks, iou[:, s0: s0 + self.num_masks]


class SAM(nn.Module):
    """Full promptable segmentation model; one call = set_image + predict."""

    def __init__(self, encoder: SAMImageEncoder,
                 pixel_mean: Tuple[float, ...] = (123.675, 116.28, 103.53),
                 pixel_std: Tuple[float, ...] = (58.395, 57.12, 57.375), device=None):
        super().__init__()
        self.encoder = encoder
        self.prompt = PromptEncoder(img_size=encoder.img_size, device=device)
        self.decoder = MaskDecoder(device=device)
        self.register_buffer("pixel_mean", torch.tensor(pixel_mean, device=device),
                             persistent=False)
        self.register_buffer("pixel_std", torch.tensor(pixel_std, device=device),
                             persistent=False)

    def forward(self, images: torch.Tensor, points: torch.Tensor, labels: torch.Tensor):
        """images (B, S, S, 3) RGB 0..255; points (B, P, 2) xy; labels (B, P).
        Returns (mask_logits (B, 3, S/4, S/4), iou (B, 3))."""
        emb = self.encoder((images - self.pixel_mean) / self.pixel_std)
        sparse, dense = self.prompt(points, labels)
        pe = self.prompt.dense_pe(emb.shape[1:3])
        return self.decoder(emb, pe, sparse, dense)

    @classmethod
    def vit_h(cls, dtype=torch.float32, ln_gemm: bool = False, flash_attn: bool = False,
              device=None) -> "SAM":
        return cls(SAMImageEncoder(dtype=dtype, ln_gemm=ln_gemm, flash_attn=flash_attn,
                                   device=device), device=device)

    @classmethod
    def vit_b(cls, dtype=torch.float32, ln_gemm: bool = False, device=None) -> "SAM":
        return cls(SAMImageEncoder(dim=768, layers=12, heads=12, global_layers=(2, 5, 8, 11),
                                   dtype=dtype, ln_gemm=ln_gemm, device=device), device=device)

    @classmethod
    def tiny(cls, img_size: int = 64, device=None) -> "SAM":
        return cls(SAMImageEncoder(img_size=img_size, dim=32, layers=2, heads=2, window=4,
                                   global_layers=(1,), device=device), device=device)


def upscale_masks(mask_logits: torch.Tensor, out_size: int) -> torch.Tensor:
    """S/4 logits (B, M, h, w) → image-size logits (SAM's bilinear postprocess)."""
    return F.interpolate(mask_logits, size=(out_size, out_size), mode="bilinear",
                         align_corners=False, antialias=False)
