"""Torch-checkpoint → parameter-tree converters (numpy only).

The port's own copy of the converters it uses from
``divergen_tpu/utils/torch_weights.py``: each maps a torch ``state_dict``
(openai CLIP, segment-anything SAM, diffusers SDXL and IF UNets / AutoencoderKL, HF
``CLIPTextModel``, Swin, a detectron2 detector checkpoint) into the nested tree that the JAX package's flax modules
hold — linear kernels (in, out), conv kernels (kh, kw, in, out) — which
``utils.convert.params_from_jax`` then turns into the port's ``state_dict``.
Pure name mapping: no module is constructed, ``torch.load`` only
deserializes tensors. ``load_swin_into`` and ``load_d2_detector_into`` compose
the detector's converters with ``params_from_jax`` and load the result into
the port's modules. ``convert_if_unet`` maps a diffusers IF UNet checkpoint
onto ``pipeline/generation/if_unet.py:IFUNet``.
"""
from __future__ import annotations

import logging
import re
from typing import Any, Dict

import numpy as np

logger = logging.getLogger(__name__)


def load_state_dict(path: str) -> Dict[str, np.ndarray]:
    """.pth/.pt/.pkl → {name: numpy}."""
    if path.endswith(".pkl"):
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        sd = data.get("model", data)
        return {k: np.asarray(v) for k, v in sd.items() if isinstance(v, np.ndarray)}
    import torch

    data = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(data, dict):
        for key in ("state_dict", "model", "params"):
            if key in data and isinstance(data[key], dict):
                data = data[key]
                break
    return {k: v.detach().numpy() if hasattr(v, "detach") else np.asarray(v) for k, v in data.items()}


def _t_linear(w: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(w.T)


def _t_conv(w: np.ndarray) -> np.ndarray:
    # (O, I, H, W) → (H, W, I, O)
    return np.ascontiguousarray(w.transpose(2, 3, 1, 0))


def _assign(tree: Dict, path: str, value: np.ndarray, expect=None):
    keys = path.split("/")
    node = tree
    for k in keys[:-1]:
        node = node[k]
    old = node[keys[-1]]
    if tuple(old.shape) != tuple(value.shape):
        raise ValueError(f"{path}: shape {value.shape} != expected {old.shape}")
    node[keys[-1]] = value.astype(np.asarray(old).dtype)


# ---------------- CLIP (openai jit/state-dict format) ----------------
def convert_clip_text(sd: Dict[str, np.ndarray], prefix: str = "") -> Dict:
    """openai CLIP text tower → CLIPText params dict."""
    p: Dict[str, Any] = {}
    p["token_embedding"] = {"embedding": sd[f"{prefix}token_embedding.weight"]}
    p["positional_embedding"] = sd[f"{prefix}positional_embedding"]
    p["text_projection"] = sd[f"{prefix}text_projection"]
    p["ln_final"] = {
        "scale": sd[f"{prefix}ln_final.weight"],
        "bias": sd[f"{prefix}ln_final.bias"],
    }
    i = 0
    while f"{prefix}transformer.resblocks.{i}.ln_1.weight" in sd:
        rb = f"{prefix}transformer.resblocks.{i}."
        p[f"resblock{i}"] = _convert_resblock(sd, rb)
        i += 1
    return {"params": p}


def _convert_resblock(sd, rb: str) -> Dict:
    return {
        "ln_1": {"scale": sd[rb + "ln_1.weight"], "bias": sd[rb + "ln_1.bias"]},
        "ln_2": {"scale": sd[rb + "ln_2.weight"], "bias": sd[rb + "ln_2.bias"]},
        "attn": {
            "in_proj": {
                "kernel": _t_linear(sd[rb + "attn.in_proj_weight"]),
                "bias": sd[rb + "attn.in_proj_bias"],
            },
            "out_proj": {
                "kernel": _t_linear(sd[rb + "attn.out_proj.weight"]),
                "bias": sd[rb + "attn.out_proj.bias"],
            },
        },
        "mlp_c_fc": {
            "kernel": _t_linear(sd[rb + "mlp.c_fc.weight"]),
            "bias": sd[rb + "mlp.c_fc.bias"],
        },
        "mlp_c_proj": {
            "kernel": _t_linear(sd[rb + "mlp.c_proj.weight"]),
            "bias": sd[rb + "mlp.c_proj.bias"],
        },
    }


def convert_clip_vision(sd: Dict[str, np.ndarray], prefix: str = "visual.") -> Dict:
    p: Dict[str, Any] = {}
    p["conv1"] = {"kernel": _t_conv(sd[prefix + "conv1.weight"])}
    p["class_embedding"] = sd[prefix + "class_embedding"]
    p["positional_embedding"] = sd[prefix + "positional_embedding"]
    p["ln_pre"] = {"scale": sd[prefix + "ln_pre.weight"], "bias": sd[prefix + "ln_pre.bias"]}
    p["ln_post"] = {"scale": sd[prefix + "ln_post.weight"], "bias": sd[prefix + "ln_post.bias"]}
    p["proj"] = sd[prefix + "proj"]
    i = 0
    while f"{prefix}transformer.resblocks.{i}.ln_1.weight" in sd:
        p[f"resblock{i}"] = _convert_resblock(sd, f"{prefix}transformer.resblocks.{i}.")
        i += 1
    return {"params": p}


def load_clip_params(path: str, model_name: str = "ViT-L/14") -> Dict:
    sd = load_state_dict(path)
    return {"vision": convert_clip_vision(sd), "text": convert_clip_text(sd)}


# ---------------- SAM ----------------
def convert_sam(sd: Dict[str, np.ndarray], layers: int) -> Dict:
    p: Dict[str, Any] = {"encoder": {}, "prompt": {}, "decoder": {}}
    e = p["encoder"]
    e["patch_embed"] = {
        "kernel": _t_conv(sd["image_encoder.patch_embed.proj.weight"]),
        "bias": sd["image_encoder.patch_embed.proj.bias"],
    }
    e["pos_embed"] = sd["image_encoder.pos_embed"][0]
    for i in range(layers):
        b = f"image_encoder.blocks.{i}."
        blk = {
            "norm1": {"scale": sd[b + "norm1.weight"], "bias": sd[b + "norm1.bias"]},
            "norm2": {"scale": sd[b + "norm2.weight"], "bias": sd[b + "norm2.bias"]},
            "attn": {
                "qkv": {"kernel": _t_linear(sd[b + "attn.qkv.weight"]), "bias": sd[b + "attn.qkv.bias"]},
                "proj": {"kernel": _t_linear(sd[b + "attn.proj.weight"]), "bias": sd[b + "attn.proj.bias"]},
                "rel_pos_h": sd[b + "attn.rel_pos_h"],
                "rel_pos_w": sd[b + "attn.rel_pos_w"],
            },
            "mlp_fc1": {"kernel": _t_linear(sd[b + "mlp.lin1.weight"]), "bias": sd[b + "mlp.lin1.bias"]},
            "mlp_fc2": {"kernel": _t_linear(sd[b + "mlp.lin2.weight"]), "bias": sd[b + "mlp.lin2.bias"]},
        }
        e[f"block{i}"] = blk
    e["neck_conv1"] = {"kernel": _t_conv(sd["image_encoder.neck.0.weight"])}
    e["neck_ln1"] = {"scale": sd["image_encoder.neck.1.weight"], "bias": sd["image_encoder.neck.1.bias"]}
    e["neck_conv2"] = {"kernel": _t_conv(sd["image_encoder.neck.2.weight"])}
    e["neck_ln2"] = {"scale": sd["image_encoder.neck.3.weight"], "bias": sd["image_encoder.neck.3.bias"]}

    pr = p["prompt"]
    pr["pe_gaussian"] = sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"]
    pr["point_bg"] = sd["prompt_encoder.point_embeddings.0.weight"][0]
    pr["point_fg"] = sd["prompt_encoder.point_embeddings.1.weight"][0]
    pr["not_a_point"] = sd["prompt_encoder.not_a_point_embed.weight"][0]
    pr["no_mask_embed"] = sd["prompt_encoder.no_mask_embed.weight"][0]
    # box-corner embeddings (point_embeddings.2/3) and mask_downscaling are
    # prompt types the corner-point protocol never uses — not mapped

    # ---- mask decoder (segment_anything mask_decoder.py + transformer.py) ----
    d = p["decoder"]

    def attn(src):
        return {
            ours: {
                "kernel": _t_linear(sd[f"{src}.{theirs}.weight"]),
                "bias": sd[f"{src}.{theirs}.bias"],
            }
            for ours, theirs in (
                ("q", "q_proj"), ("k", "k_proj"), ("v", "v_proj"),
                ("out", "out_proj"),
            )
        }

    def ln(src):
        return {"scale": sd[f"{src}.weight"], "bias": sd[f"{src}.bias"]}

    def lin(src):
        return {"kernel": _t_linear(sd[f"{src}.weight"]), "bias": sd[f"{src}.bias"]}

    tr = "mask_decoder.transformer"
    i = 0
    while f"{tr}.layers.{i}.norm1.weight" in sd:
        L = f"{tr}.layers.{i}"
        d[f"block{i}"] = {
            "self_attn": attn(f"{L}.self_attn"),
            "t2i": attn(f"{L}.cross_attn_token_to_image"),
            "i2t": attn(f"{L}.cross_attn_image_to_token"),
            "ln1": ln(f"{L}.norm1"), "ln2": ln(f"{L}.norm2"),
            "ln3": ln(f"{L}.norm3"), "ln4": ln(f"{L}.norm4"),
            "mlp1": lin(f"{L}.mlp.lin1"), "mlp2": lin(f"{L}.mlp.lin2"),
        }
        i += 1
    d["final_t2i"] = attn(f"{tr}.final_attn_token_to_image")
    d["ln_final"] = ln(f"{tr}.norm_final_attn")
    # [iou_token | mask_token 0..3] — matches MaskDecoder.output_tokens
    d["output_tokens"] = np.concatenate(
        [sd["mask_decoder.iou_token.weight"], sd["mask_decoder.mask_tokens.weight"]], 0
    )

    def deconv(src):
        # torch ConvTranspose2d (in,out,kh,kw) → flax (kh,kw,in,out) + the
        # scatter↔fractionally-strided-conv spatial flip
        w = sd[f"{src}.weight"].transpose(2, 3, 0, 1)
        return {"kernel": np.ascontiguousarray(w[::-1, ::-1]),
                "bias": sd[f"{src}.bias"]}

    d["up1"] = deconv("mask_decoder.output_upscaling.0")
    d["up_ln"] = ln("mask_decoder.output_upscaling.1")  # LayerNorm2d ≡ channel LN
    d["up2"] = deconv("mask_decoder.output_upscaling.3")
    # hypernetworks for the multimask token slots 1..3 (slot 0 is the
    # single-mask output the pipeline never requests)
    for m in range(1, 4):
        for j in range(3):
            d[f"hyper{m}_fc{j}"] = lin(
                f"mask_decoder.output_hypernetworks_mlps.{m}.layers.{j}"
            )
    for j in range(3):
        d[f"iou_fc{j}"] = lin(f"mask_decoder.iou_prediction_head.layers.{j}")
    return {"params": p}


def load_sam_params(path: str, sam_module) -> Dict:
    """Load + convert a segment-anything checkpoint for ``sam_module``."""
    return convert_sam(load_state_dict(path), sam_module.encoder.layers)


# ---------------- SDXL UNet (diffusers) ----------------
def convert_sdxl_unet(sd: Dict[str, np.ndarray], unet) -> Dict:
    """diffusers ``UNet2DConditionModel`` state dict → ``UNetSDXL`` params.

    Walks the diffusers naming scheme programmatically from the flax config
    (block_channels / layers_per_block / transformer_depths), so it covers
    every resnet, attention block and transformer layer of SDXL-base
    (~2.6 B params). diffusers up_blocks are indexed coarse→fine; ours are
    ``up{lvl}`` with lvl = channel level, so up_blocks.k ↔ up{n-1-k}.
    """
    out: Dict[str, Any] = {}
    mapped = [0]

    def lin(dst, src):
        if f"{src}.weight" not in sd:
            return
        d = out.setdefault(dst, {})
        d["kernel"] = _t_linear(sd[f"{src}.weight"])
        if f"{src}.bias" in sd:
            d["bias"] = sd[f"{src}.bias"]
        mapped[0] += 1

    def conv(dst, src):
        if f"{src}.weight" not in sd:
            return
        node = out
        parts = dst.split("/")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = {"kernel": _t_conv(sd[f"{src}.weight"]), "bias": sd[f"{src}.bias"]}
        mapped[0] += 1

    def norm(dst, src, group=True):
        if f"{src}.weight" not in sd:
            return
        entry = {"scale": sd[f"{src}.weight"], "bias": sd[f"{src}.bias"]}
        if group:  # GroupNorm32 wraps an anonymous nn.GroupNorm
            out[dst] = {"GroupNorm_0": entry}
        else:
            out[dst] = entry
        mapped[0] += 1

    def resblock(dst, src):
        o = out.setdefault(dst, {})

        def _norm(name, s):
            if f"{s}.weight" in sd:
                o[name] = {"GroupNorm_0": {"scale": sd[f"{s}.weight"], "bias": sd[f"{s}.bias"]}}
                mapped[0] += 1

        def _conv(name, s):
            if f"{s}.weight" in sd:
                o[name] = {"kernel": _t_conv(sd[f"{s}.weight"]), "bias": sd[f"{s}.bias"]}
                mapped[0] += 1

        def _lin(name, s):
            if f"{s}.weight" in sd:
                o[name] = {"kernel": _t_linear(sd[f"{s}.weight"]), "bias": sd[f"{s}.bias"]}
                mapped[0] += 1

        _norm("norm1", f"{src}.norm1")
        _conv("conv1", f"{src}.conv1")
        _lin("time_emb_proj", f"{src}.time_emb_proj")
        _norm("norm2", f"{src}.norm2")
        _conv("conv2", f"{src}.conv2")
        _conv("conv_shortcut", f"{src}.conv_shortcut")

    def transformer(dst, src, depth):
        o = out.setdefault(dst, {})

        def _place(name, d):
            o_ref = o
            parts = name.split("/")
            for p in parts[:-1]:
                o_ref = o_ref.setdefault(p, {})
            o_ref[parts[-1]] = d

        def _lin(name, s, bias=True):
            if f"{s}.weight" in sd:
                d = {"kernel": _t_linear(sd[f"{s}.weight"])}
                if bias and f"{s}.bias" in sd:
                    d["bias"] = sd[f"{s}.bias"]
                _place(name, d)
                mapped[0] += 1

        def _lin_cat(name, sources):
            # fused projection (attn1_qkv / attn2_kv): concat the separate
            # torch matrices along the output dim (bias-free in diffusers)
            if all(f"{s}.weight" in sd for s in sources):
                d = {"kernel": np.concatenate(
                    [_t_linear(sd[f"{s}.weight"]) for s in sources], axis=1)}
                _place(name, d)
                mapped[0] += len(sources)

        if f"{src}.norm.weight" in sd:
            o["norm"] = {"GroupNorm_0": {"scale": sd[f"{src}.norm.weight"],
                                         "bias": sd[f"{src}.norm.bias"]}}
            mapped[0] += 1
        _lin("proj_in", f"{src}.proj_in")
        _lin("proj_out", f"{src}.proj_out")
        for j in range(depth):
            tb = f"{src}.transformer_blocks.{j}"
            for nname, s in (("norm1", f"{tb}.norm1"), ("norm2", f"{tb}.norm2"),
                             ("norm3", f"{tb}.norm3")):
                if f"{s}.weight" in sd:
                    o.setdefault(f"block{j}", {})[nname] = {
                        "scale": sd[f"{s}.weight"], "bias": sd[f"{s}.bias"]
                    }
                    mapped[0] += 1
            _lin_cat(f"block{j}/attn1_qkv",
                     [f"{tb}.attn1.to_q", f"{tb}.attn1.to_k", f"{tb}.attn1.to_v"])
            _lin(f"block{j}/attn1_out", f"{tb}.attn1.to_out.0")
            _lin(f"block{j}/attn2_q", f"{tb}.attn2.to_q", bias=False)
            _lin_cat(f"block{j}/attn2_kv",
                     [f"{tb}.attn2.to_k", f"{tb}.attn2.to_v"])
            _lin(f"block{j}/attn2_out", f"{tb}.attn2.to_out.0")
            _lin(f"block{j}/ff_geglu", f"{tb}.ff.net.0.proj")
            _lin(f"block{j}/ff_out", f"{tb}.ff.net.2")

    lin("time_embed_1", "time_embedding.linear_1")
    lin("time_embed_2", "time_embedding.linear_2")
    lin("add_embed_1", "add_embedding.linear_1")
    lin("add_embed_2", "add_embedding.linear_2")
    if "class_embedding.weight" in sd:  # x4 upscaler noise-level embedding
        out["class_embed"] = {"embedding": sd["class_embedding.weight"]}
        mapped[0] += 1
    conv("conv_in", "conv_in")
    conv("conv_out", "conv_out")
    norm("norm_out", "conv_norm_out")

    n_levels = len(unet.block_channels)
    lpb = unet.layers_per_block
    depths = unet.transformer_depths
    for lvl in range(n_levels):
        for i in range(lpb):
            resblock(f"down{lvl}_res{i}", f"down_blocks.{lvl}.resnets.{i}")
            if depths[lvl]:
                transformer(
                    f"down{lvl}_attn{i}", f"down_blocks.{lvl}.attentions.{i}", depths[lvl]
                )
        if lvl < n_levels - 1:
            conv(f"down{lvl}_ds/conv", f"down_blocks.{lvl}.downsamplers.0.conv")
    resblock("mid_res0", "mid_block.resnets.0")
    resblock("mid_res1", "mid_block.resnets.1")
    transformer("mid_attn", "mid_block.attentions.0", depths[-1])
    for k in range(n_levels):  # diffusers up index k ↔ our level n-1-k
        lvl = n_levels - 1 - k
        for i in range(lpb + 1):
            resblock(f"up{lvl}_res{i}", f"up_blocks.{k}.resnets.{i}")
            if depths[lvl]:
                transformer(
                    f"up{lvl}_attn{i}", f"up_blocks.{k}.attentions.{i}", depths[lvl]
                )
        if lvl > 0:
            conv(f"up{lvl}_us/conv", f"up_blocks.{k}.upsamplers.0.conv")

    logger.info("convert_sdxl_unet: %d modules mapped from %d torch keys",
                mapped[0], len(sd))
    return {"params": out}


def load_sdxl_unet_params(path: str, unet) -> Dict:
    """Load + convert a diffusers SDXL UNet checkpoint (safetensors/.pth)."""
    sd = load_state_dict(path)
    return convert_sdxl_unet(sd, unet)


# ---------------- HF/transformers CLIPTextModel (SDXL text towers) --------
def convert_hf_clip_text(sd: Dict[str, np.ndarray], prefix: str = "text_model.") -> Dict:
    """HF ``CLIPTextModel(WithProjection)`` state dict → ``CLIPText`` params.

    The SDXL checkpoints ship their towers in transformers layout
    (``text_model.encoder.layers.N.self_attn.{q,k,v}_proj`` etc. — the
    reference loads them via ``StableDiffusionXLPipeline.from_pretrained``,
    ``txt2img_diffusers_stages_from_txt.py:136-198``); openai-layout
    checkpoints go through :func:`convert_clip_text` instead. The separate
    q/k/v projections concat into our fused ``in_proj`` (q|k|v order)."""
    p: Dict[str, Any] = {}
    emb = f"{prefix}embeddings."
    p["token_embedding"] = {"embedding": sd[f"{emb}token_embedding.weight"]}
    p["positional_embedding"] = sd[f"{emb}position_embedding.weight"]
    p["ln_final"] = {
        "scale": sd[f"{prefix}final_layer_norm.weight"],
        "bias": sd[f"{prefix}final_layer_norm.bias"],
    }
    width = sd[f"{emb}token_embedding.weight"].shape[1]
    if "text_projection.weight" in sd:  # CLIPTextModelWithProjection (bigG)
        p["text_projection"] = _t_linear(sd["text_projection.weight"])
    else:
        # tower 1 (CLIP-L) is used penultimate-hidden-only in SDXL; the
        # module still owns a projection param — keep it inert
        p["text_projection"] = np.zeros((width, width), np.float32)
    i = 0
    while f"{prefix}encoder.layers.{i}.layer_norm1.weight" in sd:
        lyr = f"{prefix}encoder.layers.{i}."
        p[f"resblock{i}"] = {
            "ln_1": {"scale": sd[lyr + "layer_norm1.weight"],
                     "bias": sd[lyr + "layer_norm1.bias"]},
            "ln_2": {"scale": sd[lyr + "layer_norm2.weight"],
                     "bias": sd[lyr + "layer_norm2.bias"]},
            "attn": {
                "in_proj": {
                    "kernel": np.concatenate(
                        [_t_linear(sd[lyr + f"self_attn.{w}_proj.weight"])
                         for w in ("q", "k", "v")], axis=1),
                    "bias": np.concatenate(
                        [sd[lyr + f"self_attn.{w}_proj.bias"]
                         for w in ("q", "k", "v")]),
                },
                "out_proj": {
                    "kernel": _t_linear(sd[lyr + "self_attn.out_proj.weight"]),
                    "bias": sd[lyr + "self_attn.out_proj.bias"],
                },
            },
            "mlp_c_fc": {"kernel": _t_linear(sd[lyr + "mlp.fc1.weight"]),
                         "bias": sd[lyr + "mlp.fc1.bias"]},
            "mlp_c_proj": {"kernel": _t_linear(sd[lyr + "mlp.fc2.weight"]),
                           "bias": sd[lyr + "mlp.fc2.bias"]},
        }
        i += 1
    return {"params": p}


def load_sdxl_text_params(path: str) -> Dict:
    """Load one SDXL text tower (HF transformers or openai layout)."""
    sd = load_state_dict(path)
    if any(k.startswith("text_model.") for k in sd):
        return convert_hf_clip_text(sd)
    return convert_clip_text(sd)


# ---------------- diffusers AutoencoderKL (SDXL VAE) ----------------------
def _convert_vae_resblock(sd, src: str) -> Dict:
    o: Dict[str, Any] = {}
    for ours, theirs in (("norm1", "norm1"), ("norm2", "norm2")):
        o[ours] = {"GroupNorm_0": {"scale": sd[f"{src}.{theirs}.weight"],
                                   "bias": sd[f"{src}.{theirs}.bias"]}}
    for ours, theirs in (("conv1", "conv1"), ("conv2", "conv2")):
        o[ours] = {"kernel": _t_conv(sd[f"{src}.{theirs}.weight"]),
                   "bias": sd[f"{src}.{theirs}.bias"]}
    if f"{src}.conv_shortcut.weight" in sd:
        o["shortcut"] = {"kernel": _t_conv(sd[f"{src}.conv_shortcut.weight"]),
                         "bias": sd[f"{src}.conv_shortcut.bias"]}
    return o


def _convert_vae_attention(sd, src: str) -> Dict:
    # modern diffusers: group_norm + to_q/to_k/to_v/to_out.0 (Linear);
    # legacy (<0.16) used query/key/value/proj_attn
    names = (("to_q", "to_k", "to_v", "to_out.0")
             if f"{src}.to_q.weight" in sd
             else ("query", "key", "value", "proj_attn"))
    o: Dict[str, Any] = {
        "norm": {"GroupNorm_0": {"scale": sd[f"{src}.group_norm.weight"],
                                 "bias": sd[f"{src}.group_norm.bias"]}}
    }
    for ours, theirs in zip(("q", "k", "v", "proj_out"), names):
        w = sd[f"{src}.{theirs}.weight"]
        if w.ndim == 4:  # legacy 1x1-conv layout
            w = w[:, :, 0, 0]
        o[ours] = {"kernel": _t_linear(w), "bias": sd[f"{src}.{theirs}.bias"]}
    return o


def convert_sdxl_vae(sd: Dict[str, np.ndarray], n_levels: int = 4,
                     decoder_only: bool = False) -> Dict:
    """diffusers ``AutoencoderKL`` state dict → ``VAEDecoder`` params (and
    ``VAEEncoder`` params unless absent/``decoder_only``).

    Returns ``{"decoder": {...}, "encoder": {...}|None}`` param trees. Our
    decoder's ``up{lvl}`` enumerates ``reversed(channels)`` (lvl 0 =
    widest), matching diffusers ``up_blocks.k`` order 1:1."""
    dec: Dict[str, Any] = {}
    dec["post_quant_conv"] = {"kernel": _t_conv(sd["post_quant_conv.weight"]),
                              "bias": sd["post_quant_conv.bias"]}
    dec["conv_in"] = {"kernel": _t_conv(sd["decoder.conv_in.weight"]),
                      "bias": sd["decoder.conv_in.bias"]}
    dec["mid_res0"] = _convert_vae_resblock(sd, "decoder.mid_block.resnets.0")
    dec["mid_res1"] = _convert_vae_resblock(sd, "decoder.mid_block.resnets.1")
    dec["mid_attn"] = _convert_vae_attention(sd, "decoder.mid_block.attentions.0")
    for lvl in range(n_levels):
        for i in range(3):
            dec[f"up{lvl}_res{i}"] = _convert_vae_resblock(
                sd, f"decoder.up_blocks.{lvl}.resnets.{i}")
        if f"decoder.up_blocks.{lvl}.upsamplers.0.conv.weight" in sd:
            dec[f"up{lvl}_conv"] = {
                "kernel": _t_conv(sd[f"decoder.up_blocks.{lvl}.upsamplers.0.conv.weight"]),
                "bias": sd[f"decoder.up_blocks.{lvl}.upsamplers.0.conv.bias"],
            }
    dec["norm_out"] = {"GroupNorm_0": {"scale": sd["decoder.conv_norm_out.weight"],
                                       "bias": sd["decoder.conv_norm_out.bias"]}}
    dec["conv_out"] = {"kernel": _t_conv(sd["decoder.conv_out.weight"]),
                       "bias": sd["decoder.conv_out.bias"]}

    enc = None
    if not decoder_only and "encoder.conv_in.weight" in sd:
        enc = {}
        enc["conv_in"] = {"kernel": _t_conv(sd["encoder.conv_in.weight"]),
                          "bias": sd["encoder.conv_in.bias"]}
        for lvl in range(n_levels):
            for i in range(2):
                enc[f"down{lvl}_res{i}"] = _convert_vae_resblock(
                    sd, f"encoder.down_blocks.{lvl}.resnets.{i}")
            if f"encoder.down_blocks.{lvl}.downsamplers.0.conv.weight" in sd:
                enc[f"down{lvl}_conv"] = {
                    "kernel": _t_conv(
                        sd[f"encoder.down_blocks.{lvl}.downsamplers.0.conv.weight"]),
                    "bias": sd[f"encoder.down_blocks.{lvl}.downsamplers.0.conv.bias"],
                }
        enc["mid_res0"] = _convert_vae_resblock(sd, "encoder.mid_block.resnets.0")
        enc["mid_res1"] = _convert_vae_resblock(sd, "encoder.mid_block.resnets.1")
        enc["mid_attn"] = _convert_vae_attention(sd, "encoder.mid_block.attentions.0")
        enc["norm_out"] = {"GroupNorm_0": {"scale": sd["encoder.conv_norm_out.weight"],
                                           "bias": sd["encoder.conv_norm_out.bias"]}}
        enc["conv_out"] = {"kernel": _t_conv(sd["encoder.conv_out.weight"]),
                           "bias": sd["encoder.conv_out.bias"]}
        enc["quant_conv"] = {"kernel": _t_conv(sd["quant_conv.weight"]),
                             "bias": sd["quant_conv.bias"]}
    return {"decoder": {"params": dec}, "encoder": {"params": enc} if enc else None}


def load_sdxl_vae_params(path: str, n_levels: int = 4) -> Dict:
    """Load + convert a diffusers AutoencoderKL checkpoint; returns the
    VAEDecoder params tree (use convert_sdxl_vae for the encoder too)."""
    sd = load_state_dict(path)
    return convert_sdxl_vae(sd, n_levels=n_levels)["decoder"]


# ---------------- Swin ----------------
def convert_swin(sd: Dict[str, np.ndarray], depths=(2, 2, 18, 2)) -> Dict:
    """swin_*_patch4_window*.pth → our SwinTransformer params (under the
    meta-arch this mounts at params['params']['bottom_up'])."""
    p: Dict[str, Any] = {}
    p["patch_embed"] = {
        "kernel": _t_conv(sd["patch_embed.proj.weight"]),
        "bias": sd["patch_embed.proj.bias"],
    }
    p["patch_norm"] = {
        "scale": sd["patch_embed.norm.weight"],
        "bias": sd["patch_embed.norm.bias"],
    }
    for stage, depth in enumerate(depths):
        for blk in range(depth):
            b = f"layers.{stage}.blocks.{blk}."
            q: Dict[str, Any] = {}
            q["norm1"] = {"scale": sd[b + "norm1.weight"], "bias": sd[b + "norm1.bias"]}
            q["norm2"] = {"scale": sd[b + "norm2.weight"], "bias": sd[b + "norm2.bias"]}
            q["attn"] = {
                "qkv": {"kernel": _t_linear(sd[b + "attn.qkv.weight"]), "bias": sd[b + "attn.qkv.bias"]},
                "proj": {"kernel": _t_linear(sd[b + "attn.proj.weight"]), "bias": sd[b + "attn.proj.bias"]},
                "relative_position_bias_table": sd[b + "attn.relative_position_bias_table"],
            }
            q["mlp_fc1"] = {"kernel": _t_linear(sd[b + "mlp.fc1.weight"]), "bias": sd[b + "mlp.fc1.bias"]}
            q["mlp_fc2"] = {"kernel": _t_linear(sd[b + "mlp.fc2.weight"]), "bias": sd[b + "mlp.fc2.bias"]}
            p[f"stage{stage}_block{blk}"] = q
        if stage < len(depths) - 1:
            d = f"layers.{stage}.downsample."
            p[f"merge{stage}"] = {
                "norm": {"scale": sd[d + "norm.weight"], "bias": sd[d + "norm.bias"]},
                "reduction": {"kernel": _t_linear(sd[d + "reduction.weight"])},
            }
    # out-feature norms: detectron2-style checkpoints carry norm0..norm3;
    # classification checkpoints only a final 'norm' — map what exists
    for stage in range(len(depths)):
        key = f"norm{stage}.weight"
        if key in sd:
            p[f"s{stage + 2}_norm"] = {"scale": sd[key], "bias": sd[f"norm{stage}.bias"]}
    return p


def _load_converted(module, tree: Dict, what: str):
    """Load a converted tree into ``module``: keys the module lacks and keys
    of another shape are skipped with a warning (DetectionCheckpointer
    semantics); the keys that were loaded and skipped are returned."""
    from .convert import params_from_jax

    target = module.state_dict()
    loaded, skipped = {}, []
    for key, value in params_from_jax(tree, module).items():
        if key not in target:
            skipped.append(f"{key} (unknown)")
        elif tuple(target[key].shape) != tuple(value.shape):
            skipped.append(f"{key} (shape {tuple(value.shape)} vs {tuple(target[key].shape)})")
        else:
            loaded[key] = value
    module.load_state_dict(loaded, strict=False)
    if skipped:
        logger.warning("%s: skipped %d mismatched keys: %s", what, len(skipped), skipped[:8])
    return sorted(loaded), skipped


def load_swin_into(model, path_or_sd, depths=(2, 2, 18, 2)):
    """Load a pretrained Swin (``swin_*_patch4_window*.pth``, or a state dict)
    into ``model.bottom_up`` of a ``CustomRCNN``, or into ``model`` itself
    when it is a ``SwinTransformer``. Returns (loaded keys, skipped keys)."""
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    sd = {k.replace("backbone.", "").replace("bottom_up.", ""): v for k, v in sd.items()}
    return _load_converted(getattr(model, "bottom_up", model), convert_swin(sd, depths),
                           "swin checkpoint")


def _fold_frozen_bn(sd, src, eps=1e-5):
    """detectron2 FrozenBatchNorm2d → our affine-only FrozenBatchNorm:
    scale = γ/√(var+ε), bias = β − mean·scale. Caffe2-origin .pkl
    checkpoints are already folded (no running stats) — pass through."""
    g, b = sd[f"{src}.weight"], sd[f"{src}.bias"]
    if f"{src}.running_var" in sd:
        scale = g / np.sqrt(sd[f"{src}.running_var"] + eps)
        return {"scale": scale, "bias": b - sd[f"{src}.running_mean"] * scale}
    return {"scale": g, "bias": b}


def _convert_d2_resnet(sd: Dict[str, np.ndarray], used_add=None) -> Dict:
    """detectron2 ResNet (BasicStem + bottleneck stages, FrozenBN) → our
    ResNet params (modeling/backbone/resnet.py: stem + res<s>_block<i> with
    conv1/conv2/conv3/shortcut ConvNorm children)."""
    used_add = used_add or (lambda k: None)

    def conv_bn(src):
        for k in (f"{src}.weight", f"{src}.norm.weight", f"{src}.norm.bias",
                  f"{src}.norm.running_mean", f"{src}.norm.running_var"):
            if k in sd:
                used_add(k)
        return {
            "conv": {"kernel": _t_conv(sd[f"{src}.weight"])},
            "FrozenBatchNorm_0": _fold_frozen_bn(sd, f"{src}.norm"),
        }

    p: Dict[str, Any] = {"stem": conv_bn("stem.conv1")}
    for s in (2, 3, 4, 5):
        i = 0
        while f"res{s}.{i}.conv1.weight" in sd:
            blk = {
                c: conv_bn(f"res{s}.{i}.{c}") for c in ("conv1", "conv2", "conv3")
            }
            if f"res{s}.{i}.shortcut.weight" in sd:
                blk["shortcut"] = conv_bn(f"res{s}.{i}.shortcut")
            p[f"res{s}_block{i}"] = blk
            i += 1
    return p


# ---------------- detectron2 GeneralizedRCNN detector checkpoint ----------------
def convert_d2_detector(
    sd: Dict[str, np.ndarray],
    *,
    swin_depths=(2, 2, 18, 2),
    fpn_in_features=("res3", "res4", "res5"),
    cascade_stages: int = 3,
    use_zeroshot: bool = False,
    box_pooler_resolution: int = 7,
) -> Dict:
    """Full detector checkpoint (DiverGen/Detic/BSGAL: Swin/ResNet + FPN +
    CenterNet2 proposals + Detic cascade heads) → our CustomRCNN param tree.

    Key layout follows the reference modules that produce these checkpoints:
    ``backbone.bottom_up.*`` + ``backbone.fpn_lateral<s>/fpn_output<s>`` +
    ``backbone.top_block.p6/p7`` (detectron2 fpn.py:84-99),
    ``proposal_generator.centernet_head.{share,bbox,cls}_tower.<j>`` with
    Sequential conv/GN/ReLU triples + ``agn_hm``/``bbox_pred``/``scales.<l>``
    (centernet_head.py:57-108), ``roi_heads.box_head.<k>.fc{1,2}`` +
    ``roi_heads.box_predictor.<k>.{cls_score,bbox_pred}``
    (detic_fast_rcnn.py:29-130, zero_shot_classifier.py:9-86) and
    ``roi_heads.mask_head.{mask_fcn*,deconv,predictor}`` (mask_head.py).

    Returns {"bottom_up":…, "fpn":…, "centernet_head":…, "roi_heads":…}
    plus "_stats" with mapped/unmapped key lists for coverage asserts.
    """
    used = set()

    def take(k):
        used.add(k)
        return sd[k]

    out: Dict[str, Any] = {}

    # --- backbone bottom-up ---
    swin_keys = {k for k in sd if k.startswith("backbone.bottom_up.")}
    if any(".patch_embed." in k for k in swin_keys):
        sub = {k[len("backbone.bottom_up."):]: sd[k] for k in swin_keys}
        out["bottom_up"] = convert_swin(sub, swin_depths)
        # convert_swin consumes the whole swin surface; rel-pos index buffers
        # and attn masks are recomputed, not loaded
        used |= {
            k for k in swin_keys
            if not k.endswith(("relative_position_index", "attn_mask"))
        }
    elif any(".stem." in k for k in swin_keys):
        sub = {k[len("backbone.bottom_up."):]: sd[k] for k in swin_keys}
        out["bottom_up"] = _convert_d2_resnet(sub, used_add=lambda k: used.add(
            "backbone.bottom_up." + k))

    # --- FPN ---
    fpn: Dict[str, Any] = {}
    stages = sorted(
        int(m.group(1))
        for m in (re.match(r"backbone\.fpn_lateral(\d+)\.weight$", k) for k in sd)
        if m
    )
    assert len(stages) == len(fpn_in_features), (stages, fpn_in_features)

    def conv_norm(dst, src):
        d = {"conv": {"kernel": _t_conv(take(f"{src}.weight"))}}
        if f"{src}.bias" in sd:
            d["conv"]["bias"] = take(f"{src}.bias")
        if f"{src}.norm.weight" in sd:
            d["GroupNorm_0"] = {
                "scale": take(f"{src}.norm.weight"),
                "bias": take(f"{src}.norm.bias"),
            }
        dst_node = fpn if dst[0] == "fpn" else out.setdefault(dst[0], {})
        dst_node[dst[1]] = d

    for s, f in zip(stages, fpn_in_features):
        conv_norm(("fpn", f"lateral_{f}"), f"backbone.fpn_lateral{s}")
        conv_norm(("fpn", f"output_{f}"), f"backbone.fpn_output{s}")
    for p in ("p6", "p7"):
        if f"backbone.top_block.{p}.weight" in sd:
            conv_norm(("fpn", f"top_{p}"), f"backbone.top_block.{p}")
    out["fpn"] = fpn

    # --- CenterNet head ---
    cn: Dict[str, Any] = {}
    pfx = "proposal_generator.centernet_head"
    for tower, ours in (("share_tower", "share"), ("bbox_tower", "bbox"),
                        ("cls_tower", "cls")):
        # Sequential indices skip the param-less ReLUs: conv at 3k, GN at
        # 3k+1 (or conv at 2k with norm=''); scan the indices present
        idxs = sorted(
            int(m.group(1))
            for m in (
                re.match(rf"{re.escape(pfx)}\.{tower}\.(\d+)\.weight$", k)
                for k in sd
            )
            if m
        )
        conv_i = 0
        for j in idxs:
            w = sd[f"{pfx}.{tower}.{j}.weight"]
            if w.ndim == 4:  # conv
                node = cn.setdefault(f"{ours}_{conv_i}", {})
                node["conv"] = {
                    "kernel": _t_conv(take(f"{pfx}.{tower}.{j}.weight")),
                    "bias": take(f"{pfx}.{tower}.{j}.bias"),
                }
                conv_i += 1
            else:  # GroupNorm
                cn[f"{ours}_{conv_i - 1}"]["GroupNorm_0"] = {
                    "scale": take(f"{pfx}.{tower}.{j}.weight"),
                    "bias": take(f"{pfx}.{tower}.{j}.bias"),
                }
    for head in ("agn_hm", "bbox_pred", "cls_logits"):
        if f"{pfx}.{head}.weight" in sd:
            cn[head] = {"conv": {
                "kernel": _t_conv(take(f"{pfx}.{head}.weight")),
                "bias": take(f"{pfx}.{head}.bias"),
            }}
    l = 0
    while f"{pfx}.scales.{l}.scale" in sd:
        cn[f"scale_{l}"] = {"scale": take(f"{pfx}.scales.{l}.scale").reshape(())}
        l += 1
    out["centernet_head"] = cn

    # --- cascade ROI heads ---
    rh: Dict[str, Any] = {}
    for k in range(cascade_stages):
        bh = {}
        for fc in ("fc1", "fc2"):
            if f"roi_heads.box_head.{k}.{fc}.weight" in sd:
                w = take(f"roi_heads.box_head.{k}.{fc}.weight")
                if fc == "fc1":
                    # torch flattens the pooled roi NCHW (c·H·W + y·W + x);
                    # our head flattens NHWC — permute the input axis or the
                    # loaded head silently computes on scrambled features
                    # (caught by tests/parity/test_full_graph_parity.py)
                    res = box_pooler_resolution
                    cin = w.shape[1] // (res * res)
                    assert cin * res * res == w.shape[1], (w.shape, res)
                    w = (
                        w.reshape(-1, cin, res, res)
                        .transpose(2, 3, 1, 0)
                        .reshape(res * res * cin, -1)
                    )
                else:
                    w = _t_linear(w)
                bh[fc] = {
                    "kernel": w,
                    "bias": take(f"roi_heads.box_head.{k}.{fc}.bias"),
                }
        if bh:
            rh[f"box_head{k}"] = bh
        if f"roi_heads.box_predictor.{k}.bbox_pred.weight" not in sd:
            continue
        bp = {}
        cs = f"roi_heads.box_predictor.{k}.cls_score"
        if use_zeroshot:
            bp["linear"] = {
                "kernel": _t_linear(take(f"{cs}.linear.weight")),
                "bias": take(f"{cs}.linear.bias"),
            }
            # reference zs_weight is D x (C+1) with an all-zero background
            # column appended at init (zero_shot_classifier.py:42-44); ours
            # keeps D x C and a separate bg_bias logit
            bp["zs_weight"] = take(f"{cs}.zs_weight")[:, :-1]
            if f"{cs}.cls_bias" in sd:
                bp["bg_bias"] = take(f"{cs}.cls_bias")
        else:
            bp["cls_score"] = {
                "kernel": _t_linear(take(f"{cs}.weight")),
                "bias": take(f"{cs}.bias"),
            }
        bp["bbox_pred"] = {
            "kernel": _t_linear(take(f"roi_heads.box_predictor.{k}.bbox_pred.weight")),
            "bias": take(f"roi_heads.box_predictor.{k}.bbox_pred.bias"),
        }
        rh[f"box_predictor{k}"] = bp
    mh = {}
    i = 1
    while f"roi_heads.mask_head.mask_fcn{i}.weight" in sd:
        mh[f"mask_fcn{i}"] = {
            "kernel": _t_conv(take(f"roi_heads.mask_head.mask_fcn{i}.weight")),
            "bias": take(f"roi_heads.mask_head.mask_fcn{i}.bias"),
        }
        i += 1
    if "roi_heads.mask_head.deconv.weight" in sd:
        # torch ConvTranspose2d (in, out, kh, kw) → flax (kh, kw, in, out);
        # torch scatters the kernel directly while lax.conv_transpose treats
        # it as a fractionally-strided conv — spatial flip converts between
        # the two (verified in tests/parity/test_detector_convert_parity.py)
        w = take("roi_heads.mask_head.deconv.weight").transpose(2, 3, 0, 1)
        mh["deconv"] = {
            "kernel": np.ascontiguousarray(w[::-1, ::-1]),
            "bias": take("roi_heads.mask_head.deconv.bias"),
        }
    if "roi_heads.mask_head.predictor.weight" in sd:
        mh["predictor"] = {
            "kernel": _t_conv(take("roi_heads.mask_head.predictor.weight")),
            "bias": take("roi_heads.mask_head.predictor.bias"),
        }
    if mh:
        rh["mask_head"] = mh
    out["roi_heads"] = rh

    ignorable = (
        "freq_weight", "pixel_mean", "pixel_std", "cls_weight",
        "relative_position_index", "attn_mask",
    )
    unmapped = [
        k for k in sd
        if k not in used and not k.endswith(ignorable)
    ]
    out["_stats"] = {"mapped": len(used), "unmapped": unmapped}
    return out


def load_d2_detector_into(model, path_or_sd, cfg=None, **kw):
    """Load a reference detector checkpoint into a ``CustomRCNN``; the
    converter's options default from ``cfg``. Returns (loaded keys, skipped
    keys); checkpoint keys the converter did not map are logged."""
    sd = load_state_dict(path_or_sd) if isinstance(path_or_sd, str) else path_or_sd
    if cfg is not None:
        kw.setdefault("use_zeroshot", cfg.MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS)
        kw.setdefault("cascade_stages", len(cfg.MODEL.ROI_BOX_CASCADE_HEAD.IOUS))
        kw.setdefault("box_pooler_resolution", cfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION)
    converted = convert_d2_detector(sd, **kw)
    stats = converted.pop("_stats")
    if stats["unmapped"]:
        logger.warning("detector checkpoint: %d keys unmapped: %s",
                       len(stats["unmapped"]), stats["unmapped"][:8])
    return _load_converted(model, converted, "detector checkpoint")


# ---------------- DeepFloyd-IF UNet (diffusers) ----------------
def convert_if_unet(sd: Dict[str, np.ndarray], unet) -> Dict:
    """diffusers IF ``UNet2DConditionModel`` state dict → ``IFUNet`` params.

    Reference loads these checkpoints via DiffusionPipeline
    (``DiverGen/generation/txt2img_diffusers_stages_from_txt.py:136-198``).
    Naming walked from the flax config (channels / layers_per_block /
    attn_start / noise_level_cond); diffusers up_blocks are indexed
    deepest→shallowest, ours ``up_{level}``, so up_blocks.k ↔
    up_{n-1-k}. Returns the flax param tree plus ``_stats`` with unmapped
    torch keys (empty on a complete checkpoint).
    """
    out: Dict[str, Any] = {}
    used = set()

    def lin(dst, src):
        if f"{src}.weight" not in sd:
            return
        out[dst] = {"kernel": _t_linear(sd[f"{src}.weight"]),
                    "bias": sd[f"{src}.bias"]}
        used.update((f"{src}.weight", f"{src}.bias"))

    def conv(dst, src):
        if f"{src}.weight" not in sd:
            return
        out[dst] = {"kernel": _t_conv(sd[f"{src}.weight"]),
                    "bias": sd[f"{src}.bias"]}
        used.update((f"{src}.weight", f"{src}.bias"))

    def norm(dst, src):
        if f"{src}.weight" not in sd:
            return
        out[dst] = {"scale": sd[f"{src}.weight"], "bias": sd[f"{src}.bias"]}
        used.update((f"{src}.weight", f"{src}.bias"))

    def resblock(dst, src):
        o = {}

        def sub(kind, name, s):
            if f"{s}.weight" not in sd:
                return
            w = sd[f"{s}.weight"]
            if kind == "norm":
                o[name] = {"scale": w, "bias": sd[f"{s}.bias"]}
            elif kind == "conv":
                o[name] = {"kernel": _t_conv(w), "bias": sd[f"{s}.bias"]}
            else:
                o[name] = {"kernel": _t_linear(w), "bias": sd[f"{s}.bias"]}
            used.update((f"{s}.weight", f"{s}.bias"))

        sub("norm", "norm1", f"{src}.norm1")
        sub("conv", "conv1", f"{src}.conv1")
        sub("lin", "time_emb_proj", f"{src}.time_emb_proj")
        sub("norm", "norm2", f"{src}.norm2")
        sub("conv", "conv2", f"{src}.conv2")
        sub("conv", "conv_shortcut", f"{src}.conv_shortcut")
        if o:
            out[dst] = o

    def attn(dst, src):
        o = {}

        def sub(kind, name, s):
            if f"{s}.weight" not in sd:
                return
            w = sd[f"{s}.weight"]
            if kind == "norm":
                o[name] = {"scale": w, "bias": sd[f"{s}.bias"]}
            else:
                o[name] = {"kernel": _t_linear(w), "bias": sd[f"{s}.bias"]}
            used.update((f"{s}.weight", f"{s}.bias"))

        sub("norm", "group_norm", f"{src}.group_norm")
        for k in ("to_q", "to_k", "to_v", "add_k_proj", "add_v_proj"):
            sub("lin", k, f"{src}.{k}")
        sub("lin", "to_out", f"{src}.to_out.0")
        if o:
            out[dst] = o

    lin("time_emb_1", "time_embedding.linear_1")
    lin("time_emb_2", "time_embedding.linear_2")
    if getattr(unet, "noise_level_cond", False):
        lin("class_emb_1", "class_embedding.linear_1")
        lin("class_emb_2", "class_embedding.linear_2")
    add = {}
    if "add_embedding.norm1.weight" in sd:
        add["norm1"] = {"scale": sd["add_embedding.norm1.weight"],
                        "bias": sd["add_embedding.norm1.bias"]}
        add["norm2"] = {"scale": sd["add_embedding.norm2.weight"],
                        "bias": sd["add_embedding.norm2.bias"]}
        pool = {"positional_embedding": sd["add_embedding.pool.positional_embedding"]}
        for k in ("q_proj", "k_proj", "v_proj"):
            pool[k] = {
                "kernel": _t_linear(sd[f"add_embedding.pool.{k}.weight"]),
                "bias": sd[f"add_embedding.pool.{k}.bias"],
            }
        add["pool"] = pool
        add["proj"] = {"kernel": _t_linear(sd["add_embedding.proj.weight"]),
                       "bias": sd["add_embedding.proj.bias"]}
        out["add_embedding"] = add
        used.update(k for k in sd if k.startswith("add_embedding."))
    lin("encoder_hid_proj", "encoder_hid_proj")
    conv("conv_in", "conv_in")

    n = len(unet.channels)
    lpb = unet.layers_per_block
    for i in range(n):
        for j in range(lpb):
            resblock(f"down_{i}_res_{j}", f"down_blocks.{i}.resnets.{j}")
            if i >= unet.attn_start:
                attn(f"down_{i}_attn_{j}", f"down_blocks.{i}.attentions.{j}")
        if i < n - 1:
            resblock(f"down_{i}_downsample", f"down_blocks.{i}.downsamplers.0")
    resblock("mid_res_0", "mid_block.resnets.0")
    attn("mid_attn", "mid_block.attentions.0")
    resblock("mid_res_1", "mid_block.resnets.1")
    for k in range(n):  # diffusers: deepest first
        lvl = n - 1 - k
        for j in range(lpb + 1):
            resblock(f"up_{lvl}_res_{j}", f"up_blocks.{k}.resnets.{j}")
            if lvl >= unet.attn_start:
                attn(f"up_{lvl}_attn_{j}", f"up_blocks.{k}.attentions.{j}")
        if lvl > 0:
            resblock(f"up_{lvl}_upsample", f"up_blocks.{k}.upsamplers.0")
    norm("conv_norm_out", "conv_norm_out")
    conv("conv_out", "conv_out")

    unmapped = sorted(k for k in sd if k not in used)
    logger.info("convert_if_unet: mapped %d/%d torch keys", len(used), len(sd))
    return {"params": out, "_stats": {"unmapped": unmapped}}


def load_if_unet_params(path: str, unet) -> Dict:
    """Load + convert a diffusers IF UNet checkpoint (safetensors/.pth)."""
    sd = load_state_dict(path)
    out = convert_if_unet(sd, unet)
    stats = out.pop("_stats")
    if stats["unmapped"]:
        logger.warning("IF checkpoint: %d keys unmapped: %s",
                       len(stats["unmapped"]), stats["unmapped"][:8])
    return out
