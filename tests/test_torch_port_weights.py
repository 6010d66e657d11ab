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
