"""SDXL prompt conditioning: the two CLIP text towers, fused (torch).

Counterpart of ``divergen_tpu/pipeline/generation/text.py``: tokenize for both
towers, run CLIP ViT-L/14 and OpenCLIP ViT-bigG/14, concatenate their
penultimate hidden states (768 + 1280 = 2048) as the cross-attention context
and take bigG's projected EOT embedding (1280) as the pooled add-embedding.
SDXL has no padding mask, so the pad ids matter: tower 1 pads with EOT,
tower 2 with 0. Stage III (the x4 upscaler) conditions on its own tower's
final-layer states (``UpscalerTextEncoder``) or, without that checkpoint, on
the SDXL features sliced to its width (``SDXLTextEncoder.encode_sliced``).
"""
from __future__ import annotations

from typing import List, Mapping, Tuple

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

    def encode_sliced(self, prompts: List[str], ctx_dim: int) -> torch.Tensor:
        """The concatenated tower states at width ``ctx_dim``: sliced, or
        zero-padded where they are narrower (stage III's conditioning when no
        upscaler tower is loaded)."""
        ctx, _ = self.encode(prompts)
        if ctx.shape[-1] < ctx_dim:
            return torch.nn.functional.pad(ctx, (0, ctx_dim - ctx.shape[-1]))
        return ctx[..., :ctx_dim]


def tower_from_params(params: Mapping, act: str = "gelu", dtype=torch.float32,
                      device=None) -> CLIPText:
    """A ``CLIPText`` of a converted checkpoint's shapes (a tree of
    ``utils.torch_weights.load_sdxl_text_params``), its weights loaded: the
    SD-x4 upscaler's OpenCLIP ViT-H tower in HF layout (width 1024, 23 layers,
    exact GELU)."""
    from ...utils.convert import params_from_jax

    p = params["params"] if "params" in params else params
    pos = np.asarray(p["positional_embedding"])
    vocab, width = np.asarray(p["token_embedding"]["embedding"]).shape
    tower = CLIPText(embed_dim=int(np.asarray(p["text_projection"]).shape[-1]),
                     context_length=int(pos.shape[0]), vocab_size=int(vocab), width=int(width),
                     heads=max(int(width) // 64, 1),
                     layers=sum(1 for k in p if k.startswith("resblock")), dtype=dtype,
                     act=act, device=device)
    tower.load_state_dict(params_from_jax(p))
    return tower


class UpscalerTextEncoder:
    """Stage-III prompt conditioning through the upscaler's own CLIP tower:
    its final-layer hidden states (the HF checkpoint ships without its last
    layer), prompts padded with EOT as diffusers' CLIPTokenizer pads."""

    def __init__(self, tower: CLIPText, bpe_path: str = ""):
        self.tower = tower.eval()
        self.tokenizer = (
            SimpleTokenizer(bpe_path=bpe_path) if bpe_path else SimpleTokenizer(merges=[])
        )

    @property
    def device(self) -> torch.device:
        return self.tower.positional_embedding.device

    @torch.inference_mode()
    def encode(self, prompts: List[str]) -> torch.Tensor:
        """prompts → (B, 77, width) float32; the caller slices to the UNet's
        context width."""
        tok = self.tokenizer.tokenize(prompts, pad_id=self.tokenizer.eot)
        _, hidden = self.tower(torch.as_tensor(tok, dtype=torch.long, device=self.device),
                               return_sequence=True)
        return hidden.float()
