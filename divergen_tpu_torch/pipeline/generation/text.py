"""SDXL prompt conditioning: the two CLIP text towers, fused (torch).

Counterpart of ``divergen_tpu/pipeline/generation/text.py``: tokenize for both
towers, run CLIP ViT-L/14 and OpenCLIP ViT-bigG/14, concatenate their
penultimate hidden states (768 + 1280 = 2048) as the cross-attention context
and take bigG's projected EOT embedding (1280) as the pooled add-embedding.
SDXL has no padding mask, so the pad ids matter: tower 1 pads with EOT,
tower 2 with 0.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ...modeling.layers import flax_init_
from ...modeling.text.clip import CLIPText, build_sdxl_text_towers
from ...modeling.text.tokenizer import SimpleTokenizer


def tiny_sdxl_text_towers(dtype=torch.float32, device=None) -> Tuple[CLIPText, CLIPText]:
    """Miniature tower pair with the real dual-tower wiring (tests). Hidden
    widths sum to 64 = UNetSDXL.tiny's context_dim."""
    clip_l = CLIPText(embed_dim=24, width=24, heads=2, layers=2, vocab_size=49408,
                      dtype=dtype, device=device)
    big_g = CLIPText(embed_dim=40, width=40, heads=2, layers=2, vocab_size=49408,
                     dtype=dtype, act="gelu", device=device)
    return clip_l, big_g


class SDXLTextEncoder:
    """Both towers and the tokenizer behind one ``encode`` call."""

    def __init__(self, clip_l: CLIPText, big_g: CLIPText, bpe_path: str = ""):
        self.clip_l = clip_l.eval()
        self.big_g = big_g.eval()
        self.tokenizer = (
            SimpleTokenizer(bpe_path=bpe_path) if bpe_path else SimpleTokenizer(merges=[])
        )
        self._eot = self.tokenizer.eot

    @classmethod
    def random(cls, seed: int = 0, tiny: bool = False, dtype=torch.float32,
               device=None) -> "SDXLTextEncoder":
        """Random-weight towers with the real architecture and real BPE
        tokens, drawn from ``seed`` (tower 1) and ``seed + 1`` (tower 2)."""
        build = tiny_sdxl_text_towers if tiny else build_sdxl_text_towers
        clip_l, big_g = build(dtype=dtype, device=device)
        gen = torch.Generator(device=clip_l.positional_embedding.device)
        flax_init_(clip_l, gen.manual_seed(seed))
        flax_init_(big_g, gen.manual_seed(seed + 1))
        return cls(clip_l, big_g)

    @property
    def device(self) -> torch.device:
        return self.clip_l.positional_embedding.device

    def tokenize(self, prompts: List[str]) -> Tuple[np.ndarray, np.ndarray]:
        tok_l = self.tokenizer.tokenize(prompts, pad_id=self._eot)
        tok_g = self.tokenizer.tokenize(prompts, pad_id=0)
        return tok_l, tok_g

    @torch.inference_mode()
    def encode(self, prompts: List[str]) -> Tuple[torch.Tensor, torch.Tensor]:
        """prompts → (ctx (B, 77, 2048), pooled (B, 1280)), float32."""
        tok_l, tok_g = (torch.as_tensor(t, dtype=torch.long, device=self.device)
                        for t in self.tokenize(prompts))
        _, hid_l = self.clip_l(tok_l, return_sequence=True, penultimate=True)
        pooled_g, hid_g = self.big_g(tok_g, return_sequence=True, penultimate=True)
        ctx = torch.cat([hid_l.float(), hid_g.float()], dim=-1)
        return ctx, pooled_g.float()
