"""Torch-checkpoint → parameter-tree converters (numpy only).

The port's own copy of the converters it uses from
``divergen_tpu/utils/torch_weights.py``: each maps a torch ``state_dict``
(openai CLIP, segment-anything SAM, diffusers SDXL UNet / AutoencoderKL, HF
``CLIPTextModel``) into the nested tree that the JAX package's flax modules
hold — linear kernels (in, out), conv kernels (kh, kw, in, out) — which
``utils.convert.params_from_jax`` then turns into the port's ``state_dict``.
Pure name mapping: no module is constructed, ``torch.load`` only
deserializes tensors. The Swin, detectron2 detector and IF converters come
with their slices.
"""
from __future__ import annotations

import logging
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
