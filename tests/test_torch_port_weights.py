"""The port's own copies of the tokenizer and of the checkpoint converters
against their originals in the JAX package, and the converters composed with
``params_from_jax`` loading into the port's modules with ``strict=True``.

State dicts are synthetic: numpy from a seed, in the naming of the public
checkpoints (segment-anything, openai CLIP). Copies must agree exactly.
"""
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.text import tokenizer as jtok
from divergen_tpu.utils import torch_weights as jtw
from divergen_tpu_torch.modeling.text import clip as tclip
from divergen_tpu_torch.modeling.text import tokenizer as ttok
from divergen_tpu_torch.pipeline.segmentation import sam as tsam
from divergen_tpu_torch.utils import torch_weights as ttw
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

SAM_TINY = dict(dim=32, layers=2, heads=2, window=4, global_layers=(1,), grid=4)
CLIP_TINY = dict(embed=16, vision=(32, 2, 2, 16), text=(32, 2, 2), image_size=32, vocab=49408)


def _lin(sd, rng, name, out_f, in_f):
    sd[f"{name}.weight"] = (rng.randn(out_f, in_f) * in_f**-0.5).astype(np.float32)
    sd[f"{name}.bias"] = (rng.randn(out_f) * 0.1).astype(np.float32)


def _ln(sd, rng, name, c):
    sd[f"{name}.weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
    sd[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)


def synthetic_sam_state_dict(rng, dim, layers, heads, window, global_layers, grid, patch=16):
    """A segment-anything state dict with random values (non-zero relative
    positions, non-symmetric transposed-conv kernels)."""
    sd = {}
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    sd["image_encoder.patch_embed.proj.weight"] = f(dim, 3, patch, patch, scale=0.05)
    sd["image_encoder.patch_embed.proj.bias"] = f(dim, scale=0.1)
    sd["image_encoder.pos_embed"] = f(1, grid, grid, dim, scale=0.02)
    d = dim // heads
    for i in range(layers):
        b = f"image_encoder.blocks.{i}"
        _ln(sd, rng, f"{b}.norm1", dim)
        _ln(sd, rng, f"{b}.norm2", dim)
        _lin(sd, rng, f"{b}.attn.qkv", 3 * dim, dim)
        _lin(sd, rng, f"{b}.attn.proj", dim, dim)
        side = grid if i in global_layers else window
        sd[f"{b}.attn.rel_pos_h"] = f(2 * side - 1, d, scale=0.5)
        sd[f"{b}.attn.rel_pos_w"] = f(2 * side - 1, d, scale=0.5)
        _lin(sd, rng, f"{b}.mlp.lin1", 4 * dim, dim)
        _lin(sd, rng, f"{b}.mlp.lin2", dim, 4 * dim)
    sd["image_encoder.neck.0.weight"] = f(256, dim, 1, 1, scale=dim**-0.5)
    _ln(sd, rng, "image_encoder.neck.1", 256)
    sd["image_encoder.neck.2.weight"] = f(256, 256, 3, 3, scale=0.02)
    _ln(sd, rng, "image_encoder.neck.3", 256)
    sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"] = f(2, 128)
    for name in ("point_embeddings.0", "point_embeddings.1", "not_a_point_embed",
                 "no_mask_embed"):
        sd[f"prompt_encoder.{name}.weight"] = f(1, 256)
    tr = "mask_decoder.transformer"
    attn = lambda name, inner: [_lin(sd, rng, f"{name}.{p}_proj", inner, 256)
                                for p in "qkv"] + [_lin(sd, rng, f"{name}.out_proj", 256, inner)]
    for i in range(2):
        L = f"{tr}.layers.{i}"
        attn(f"{L}.self_attn", 256)
        attn(f"{L}.cross_attn_token_to_image", 128)
        attn(f"{L}.cross_attn_image_to_token", 128)
        for j in range(1, 5):
            _ln(sd, rng, f"{L}.norm{j}", 256)
        _lin(sd, rng, f"{L}.mlp.lin1", 2048, 256)
        _lin(sd, rng, f"{L}.mlp.lin2", 256, 2048)
    attn(f"{tr}.final_attn_token_to_image", 128)
    _ln(sd, rng, f"{tr}.norm_final_attn", 256)
    sd["mask_decoder.iou_token.weight"] = f(1, 256)
    sd["mask_decoder.mask_tokens.weight"] = f(4, 256)
    sd["mask_decoder.output_upscaling.0.weight"] = f(256, 64, 2, 2, scale=0.05)
    sd["mask_decoder.output_upscaling.0.bias"] = f(64, scale=0.1)
    _ln(sd, rng, "mask_decoder.output_upscaling.1", 64)
    sd["mask_decoder.output_upscaling.3.weight"] = f(64, 32, 2, 2, scale=0.1)
    sd["mask_decoder.output_upscaling.3.bias"] = f(32, scale=0.1)
    for m in range(4):
        for j, out_f in enumerate((256, 256, 32)):
            _lin(sd, rng, f"mask_decoder.output_hypernetworks_mlps.{m}.layers.{j}", out_f, 256)
    for j, out_f in enumerate((256, 256, 4)):
        _lin(sd, rng, f"mask_decoder.iou_prediction_head.layers.{j}", out_f, 256)
    return sd


def synthetic_clip_state_dict(rng, embed, vision, text, image_size, vocab):
    """An openai-CLIP state dict (both towers) with random values."""
    sd = {}
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)

    def resblocks(prefix, width, layers):
        for i in range(layers):
            rb = f"{prefix}transformer.resblocks.{i}"
            _ln(sd, rng, f"{rb}.ln_1", width)
            _ln(sd, rng, f"{rb}.ln_2", width)
            sd[f"{rb}.attn.in_proj_weight"] = f(3 * width, width, scale=width**-0.5)
            sd[f"{rb}.attn.in_proj_bias"] = f(3 * width, scale=0.1)
            _lin(sd, rng, f"{rb}.attn.out_proj", width, width)
            _lin(sd, rng, f"{rb}.mlp.c_fc", 4 * width, width)
            _lin(sd, rng, f"{rb}.mlp.c_proj", width, 4 * width)

    vw, vl, _, patch = vision
    sd["visual.conv1.weight"] = f(vw, 3, patch, patch, scale=0.05)
    sd["visual.class_embedding"] = f(vw, scale=0.02)
    sd["visual.positional_embedding"] = f((image_size // patch) ** 2 + 1, vw, scale=0.02)
    _ln(sd, rng, "visual.ln_pre", vw)
    _ln(sd, rng, "visual.ln_post", vw)
    sd["visual.proj"] = f(vw, embed, scale=vw**-0.5)
    resblocks("visual.", vw, vl)
    tw, tl, _ = text
    sd["token_embedding.weight"] = f(vocab, tw, scale=0.02)
    sd["positional_embedding"] = f(77, tw, scale=0.01)
    sd["text_projection"] = f(tw, embed, scale=tw**-0.5)
    _ln(sd, rng, "ln_final", tw)
    resblocks("", tw, tl)
    return sd


def assert_trees_equal(a, b, path=""):
    assert type(a) is type(b) or not isinstance(a, dict), path
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=path)


PROMPTS = ["a photo of a single red apple", "", "A  wooden\tchair, (vintage) & <b>bold</b>!",
           "naïve café — ünïcödé", "word " * 120]


@pytest.mark.parametrize("pad_id", [0, None])
def test_tokenizer_copy_equals_original(pad_id):
    kw = {} if pad_id is None else {"pad_id": pad_id}
    ours, theirs = ttok.SimpleTokenizer(merges=[]), jtok.SimpleTokenizer(merges=[])
    assert ours.eot == theirs.eot
    np.testing.assert_array_equal(ours.tokenize(PROMPTS, **kw), theirs.tokenize(PROMPTS, **kw))


def test_tokenizer_copy_equals_original_with_merges():
    merges = [("a", "p"), ("ap", "p"), ("l", "e</w>"), ("app", "le</w>"), ("r", "e"),
              ("re", "d</w>"), ("c", "h"), ("ch", "a"), ("i", "r</w>")]
    ours, theirs = ttok.SimpleTokenizer(merges=merges), jtok.SimpleTokenizer(merges=merges)
    np.testing.assert_array_equal(ours.tokenize(PROMPTS), theirs.tokenize(PROMPTS))


def test_convert_sam_copy_equals_original():
    sd = synthetic_sam_state_dict(np.random.RandomState(0), **SAM_TINY)
    assert_trees_equal(ttw.convert_sam(sd, 2), jtw.convert_sam(sd, 2))


def test_convert_clip_copies_equal_originals():
    sd = synthetic_clip_state_dict(np.random.RandomState(1), **CLIP_TINY)
    assert_trees_equal(ttw.convert_clip_vision(sd), jtw.convert_clip_vision(sd))
    assert_trees_equal(ttw.convert_clip_text(sd), jtw.convert_clip_text(sd))


def test_load_state_dict_copy_equals_original(tmp_path):
    sd = synthetic_clip_state_dict(np.random.RandomState(2), **CLIP_TINY)
    path = str(tmp_path / "clip.pt")
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    assert_trees_equal(ttw.load_clip_params(path), jtw.load_clip_params(path))


def test_sam_checkpoint_loads_strict():
    sd = synthetic_sam_state_dict(np.random.RandomState(3), **SAM_TINY)
    sam = tsam.SAM.tiny(img_size=64)
    state = params_from_jax(ttw.convert_sam(sd, 2), sam)
    sam.load_state_dict(state, strict=True)
    # the transposed convolutions hold the checkpoint's own (in, out, kh, kw) weights
    np.testing.assert_array_equal(sam.decoder.up1.weight.detach().numpy(),
                                  sd["mask_decoder.output_upscaling.0.weight"])
    np.testing.assert_array_equal(sam.decoder.up2.weight.detach().numpy(),
                                  sd["mask_decoder.output_upscaling.3.weight"])
    np.testing.assert_array_equal(sam.encoder.block1.attn.rel_pos_h.detach().numpy(),
                                  sd["image_encoder.blocks.1.attn.rel_pos_h"])


def test_clip_checkpoint_loads_strict():
    sd = synthetic_clip_state_dict(np.random.RandomState(4), **CLIP_TINY)
    vw, vl, vh, vp = CLIP_TINY["vision"]
    tw, tl, th = CLIP_TINY["text"]
    vision = tclip.CLIPVision(embed_dim=16, image_size=32, patch=vp, width=vw, heads=vh,
                              layers=vl)
    text = tclip.CLIPText(embed_dim=16, width=tw, heads=th, layers=tl)
    vision.load_state_dict(params_from_jax(ttw.convert_clip_vision(sd)), strict=True)
    text.load_state_dict(params_from_jax(ttw.convert_clip_text(sd)), strict=True)
    np.testing.assert_array_equal(vision.conv1.weight.detach().numpy(),
                                  sd["visual.conv1.weight"])


def test_conv_transpose_needs_the_module():
    """Without the target module a rank-4 kernel is taken for a convolution:
    the shapes then do not fit, so a wrong call cannot load silently."""
    sd = synthetic_sam_state_dict(np.random.RandomState(5), **SAM_TINY)
    sam = tsam.SAM.tiny(img_size=64)
    with pytest.raises(RuntimeError):
        sam.load_state_dict(params_from_jax(ttw.convert_sam(sd, 2)))


# -- the detector's converters ---------------------------------------------------

SWIN_TINY = (16, (1, 1, 2, 1), (1, 2, 4, 8), 4, 0.0)  # embed, depths, heads, window, drop path


def synthetic_swin_state_dict(rng, embed, depths, heads, window, out_norms=(1, 2, 3), prefix=""):
    """A Swin state dict in the naming of the published checkpoints, with the
    index and mask buffers a detectron2 checkpoint also carries."""
    sd = {}
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)
    sd["patch_embed.proj.weight"] = f(embed, 3, 4, 4, scale=0.1)
    sd["patch_embed.proj.bias"] = f(embed, scale=0.1)
    _ln(sd, rng, "patch_embed.norm", embed)
    dim = embed
    for stage, depth in enumerate(depths):
        for blk in range(depth):
            b = f"layers.{stage}.blocks.{blk}"
            _ln(sd, rng, f"{b}.norm1", dim)
            _ln(sd, rng, f"{b}.norm2", dim)
            _lin(sd, rng, f"{b}.attn.qkv", 3 * dim, dim)
            _lin(sd, rng, f"{b}.attn.proj", dim, dim)
            sd[f"{b}.attn.relative_position_bias_table"] = f((2 * window - 1) ** 2, heads[stage],
                                                             scale=0.5)
            sd[f"{b}.attn.relative_position_index"] = np.zeros((window**2, window**2), np.int64)
            _lin(sd, rng, f"{b}.mlp.fc1", 4 * dim, dim)
            _lin(sd, rng, f"{b}.mlp.fc2", dim, 4 * dim)
        if stage in out_norms:
            _ln(sd, rng, f"norm{stage}", dim)
        if stage < len(depths) - 1:
            _ln(sd, rng, f"layers.{stage}.downsample.norm", 4 * dim)
            sd[f"layers.{stage}.downsample.reduction.weight"] = f(2 * dim, 4 * dim, scale=0.1)
            dim *= 2
    return {prefix + k: v for k, v in sd.items()}


def synthetic_detector_state_dict(rng, bottom_up, in_channels, fpn=32, fc=64, mask_dim=16,
                                  classes=8, zeroshot=False, zs_dim=512):
    """A detectron2 CustomRCNN checkpoint around the given ``backbone.bottom_up``
    keys: FPN with P6/P7, CenterNet head (conv / GN / ReLU triples in a
    Sequential), three cascade stages, mask head."""
    sd = dict(bottom_up)
    f = lambda *s, scale=1.0: (rng.randn(*s) * scale).astype(np.float32)

    def conv(name, out_c, in_c, k, bias=True):
        sd[f"{name}.weight"] = f(out_c, in_c, k, k, scale=(in_c * k * k) ** -0.5)
        if bias:
            sd[f"{name}.bias"] = f(out_c, scale=0.1)

    for s, c in zip((3, 4, 5), in_channels):
        conv(f"backbone.fpn_lateral{s}", fpn, c, 1)
        conv(f"backbone.fpn_output{s}", fpn, fpn, 3)
    for p in ("p6", "p7"):
        conv(f"backbone.top_block.{p}", fpn, fpn, 3)
    head = "proposal_generator.centernet_head"
    for j in range(4):
        conv(f"{head}.bbox_tower.{3 * j}", fpn, fpn, 3)
        _ln(sd, rng, f"{head}.bbox_tower.{3 * j + 1}", fpn)
    conv(f"{head}.agn_hm", 1, fpn, 3)
    conv(f"{head}.bbox_pred", 4, fpn, 3)
    for l in range(5):
        sd[f"{head}.scales.{l}.scale"] = f(1) + 1.0
    for k in range(3):
        _lin(sd, rng, f"roi_heads.box_head.{k}.fc1", fc, fpn * 49)
        _lin(sd, rng, f"roi_heads.box_head.{k}.fc2", fc, fc)
        cs = f"roi_heads.box_predictor.{k}.cls_score"
        if zeroshot:
            _lin(sd, rng, f"{cs}.linear", zs_dim, fc)
            sd[f"{cs}.zs_weight"] = np.concatenate([f(zs_dim, classes), np.zeros((zs_dim, 1), np.float32)], 1)
            sd[f"{cs}.cls_bias"] = f(1)
        else:
            _lin(sd, rng, cs, classes + 1, fc)
        _lin(sd, rng, f"roi_heads.box_predictor.{k}.bbox_pred", 4, fc)
        sd[f"roi_heads.box_predictor.{k}.freq_weight"] = f(classes)
    for i in range(4):
        conv(f"roi_heads.mask_head.mask_fcn{i + 1}", mask_dim, fpn if i == 0 else mask_dim, 3)
    sd["roi_heads.mask_head.deconv.weight"] = f(mask_dim, mask_dim, 2, 2, scale=0.2)
    sd["roi_heads.mask_head.deconv.bias"] = f(mask_dim, scale=0.1)
    conv("roi_heads.mask_head.predictor", 1, mask_dim, 1)
    sd["pixel_mean"] = f(3, 1, 1)
    sd["some.unknown.key"] = f(2)
    return sd


def synthetic_resnet_keys(rng):
    """``backbone.bottom_up`` keys of a detectron2 ResNet: a stem and one
    bottleneck with a shortcut, with and without running statistics."""
    sd = {}
    f = lambda *s: (rng.randn(*s) * 0.1).astype(np.float32)

    def conv_bn(name, out_c, in_c, k, stats):
        sd[f"{name}.weight"] = f(out_c, in_c, k, k)
        sd[f"{name}.norm.weight"], sd[f"{name}.norm.bias"] = f(out_c) + 1.0, f(out_c)
        if stats:
            sd[f"{name}.norm.running_mean"] = f(out_c)
            sd[f"{name}.norm.running_var"] = np.abs(f(out_c)) + 0.5

    conv_bn("stem.conv1", 8, 3, 7, True)
    for c, (o, i, k) in dict(conv1=(4, 8, 1), conv2=(4, 4, 3), conv3=(16, 4, 1),
                             shortcut=(16, 8, 1)).items():
        conv_bn(f"res2.0.{c}", o, i, k, c != "conv3")
    return {"backbone.bottom_up." + k: v for k, v in sd.items()}


def test_convert_swin_copy_equals_original():
    embed, depths, heads, window, _ = SWIN_TINY
    sd = synthetic_swin_state_dict(np.random.RandomState(6), embed, depths, heads, window)
    got = ttw.convert_swin(sd, depths)
    assert_trees_equal(got, jtw.convert_swin(sd, depths))
    assert "s2_norm" not in got and set(got) >= {"s3_norm", "s4_norm", "s5_norm", "merge2"}


@pytest.mark.parametrize("zeroshot", [False, True], ids=["linear", "zeroshot"])
def test_convert_d2_detector_copy_equals_original(zeroshot):
    rng = np.random.RandomState(7)
    embed, depths, heads, window, _ = SWIN_TINY
    swin = synthetic_swin_state_dict(rng, embed, depths, heads, window,
                                     prefix="backbone.bottom_up.")
    sd = synthetic_detector_state_dict(rng, swin, (32, 64, 128), zeroshot=zeroshot)
    kw = dict(swin_depths=depths, fpn_in_features=("s3", "s4", "s5"), use_zeroshot=zeroshot)
    got, want = ttw.convert_d2_detector(sd, **kw), jtw.convert_d2_detector(sd, **kw)
    assert got.pop("_stats") == want.pop("_stats")
    assert_trees_equal(got, want)


def test_convert_d2_detector_resnet_branch_copy_equals_original():
    rng = np.random.RandomState(8)
    sd = synthetic_detector_state_dict(rng, synthetic_resnet_keys(rng), (16, 16, 16))
    got, want = ttw.convert_d2_detector(sd), jtw.convert_d2_detector(sd)
    assert got["_stats"] == want["_stats"] and got["_stats"]["unmapped"] == ["some.unknown.key"]
    got.pop("_stats"), want.pop("_stats")
    assert_trees_equal(got, want)
    assert set(got["bottom_up"]["res2_block0"]) == {"conv1", "conv2", "conv3", "shortcut"}


@pytest.fixture
def tiny_detector(monkeypatch):
    from divergen_tpu_torch import graft_entry
    from divergen_tpu_torch.modeling.backbone import swin as tswin
    from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model

    def make(zeroshot=False):
        monkeypatch.setitem(tswin.SIZE2CONFIG, "tiny", SWIN_TINY)
        cfg = graft_entry._small_cfg(swin_size="tiny")
        cfg.MODEL.FPN.OUT_CHANNELS = 32
        cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
        cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 16
        cfg.MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS = zeroshot
        return build_model(cfg), cfg

    return make


@pytest.mark.parametrize("zeroshot", [False, True], ids=["linear", "zeroshot"])
def test_detector_checkpoint_loads(tiny_detector, zeroshot):
    """Every parameter of the detector comes from the checkpoint, except the
    stride-4 output norm that a detectron2 Swin (OUT_FEATURES 1, 2, 3) lacks."""
    rng = np.random.RandomState(9)
    embed, depths, heads, window, _ = SWIN_TINY
    swin = synthetic_swin_state_dict(rng, embed, depths, heads, window,
                                     prefix="backbone.bottom_up.")
    sd = synthetic_detector_state_dict(rng, swin, (32, 64, 128), zeroshot=zeroshot)
    model, cfg = tiny_detector(zeroshot)
    loaded, skipped = ttw.load_d2_detector_into(model, sd, cfg, swin_depths=depths,
                                                fpn_in_features=("s3", "s4", "s5"))
    assert skipped == []
    assert set(model.state_dict()) - set(loaded) == {"bottom_up.s2_norm.weight",
                                                     "bottom_up.s2_norm.bias"}
    state = {k: v.numpy() for k, v in model.state_dict().items()}
    np.testing.assert_array_equal(state["bottom_up.stage2_block1.attn.qkv.weight"],
                                  sd["backbone.bottom_up.layers.2.blocks.1.attn.qkv.weight"])
    np.testing.assert_array_equal(state["fpn.top_p7.conv.weight"], sd["backbone.top_block.p7.weight"])
    np.testing.assert_array_equal(state["centernet_head.bbox_2.GroupNorm_0.weight"],
                                  sd["proposal_generator.centernet_head.bbox_tower.7.weight"])
    np.testing.assert_array_equal(state["centernet_head.scale_3.weight"],
                                  sd["proposal_generator.centernet_head.scales.3.scale"][0])
    # the transposed convolution holds the checkpoint's own (in, out, kh, kw) weight
    np.testing.assert_array_equal(state["roi_heads.mask_head.deconv.weight"],
                                  sd["roi_heads.mask_head.deconv.weight"])
    # fc1 takes the pooled roi flattened (y, x, c), the checkpoint (c, y, x)
    w = sd["roi_heads.box_head.1.fc1.weight"].reshape(64, 32, 7, 7).transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(state["roi_heads.box_head1.fc1.weight"], w.reshape(64, -1))
    if zeroshot:
        np.testing.assert_array_equal(state["roi_heads.box_predictor2.zs_weight"],
                                      sd["roi_heads.box_predictor.2.cls_score.zs_weight"][:, :-1])


def test_swin_checkpoint_loads_and_mismatches_are_skipped(tiny_detector, tmp_path):
    rng = np.random.RandomState(10)
    embed, depths, heads, window, _ = SWIN_TINY
    sd = synthetic_swin_state_dict(rng, embed, depths, heads, window, out_norms=())
    sd["layers.0.blocks.0.attn.relative_position_bias_table"] = np.zeros((9, 1), np.float32)
    path = str(tmp_path / "swin.pth")
    torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    model, _ = tiny_detector()
    loaded, skipped = ttw.load_swin_into(model, path, depths)
    assert len(skipped) == 1 and "relative_position_bias_table" in skipped[0]
    assert "stage3_block0.mlp_fc2.weight" in loaded and not any("_norm" in k and k[0] == "s"
                                                                for k in loaded)
    np.testing.assert_array_equal(model.bottom_up.merge1.reduction.weight.detach().numpy(),
                                  sd["layers.1.downsample.reduction.weight"])
