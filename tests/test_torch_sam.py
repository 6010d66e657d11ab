"""The port's ViT blocks, SAM modules and corner-mask CLI against the JAX
package, same weights and inputs.

flax ``init`` makes the weights (the zero-initialised relative-position
tables and the biases are overwritten with seeded normal values, or a parity
test would pass with the bias path broken), ``params_from_jax`` carries them
into the port, numpy makes the inputs; both run in float32 on the CPU, the
JAX package's Pallas calls through their plain references. Tolerance:
max |Δ| ≤ 1e-4 · max |reference|.
"""
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import vit as jvit
from divergen_tpu.pipeline.segmentation import corner_masks as jcm
from divergen_tpu.pipeline.segmentation import sam as jsam
from divergen_tpu_torch.modeling.backbone import vit as tvit
from divergen_tpu_torch.pipeline.segmentation import corner_masks as tcm
from divergen_tpu_torch.pipeline.segmentation import sam as tsam
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_port_weights import SAM_TINY, synthetic_sam_state_dict

torch.set_num_threads(1)
TOL = 1e-4


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def randomized(params, rng):
    """A numpy copy of a flax tree with non-zero biases and relative positions."""
    def walk(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k.startswith("rel_pos"):
                out[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
            elif k == "bias":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(jax.tree.map(np.asarray, params))


def load(module, params):
    module.load_state_dict(params_from_jax(params, module), strict=True)
    return module.eval()


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "ln_gemm+flash"])
@pytest.mark.parametrize("side,window", [(8, 0), (8, 4), (9, 4)],
                         ids=["global", "window", "window-padded"])
def test_vit_block(side, window, fused):
    rng = np.random.RandomState(0)
    x = rng.randn(2, side, side, 32).astype(np.float32)
    jm = jvit.ViTBlock(32, 2, window, ln_gemm=fused, flash_attn=fused)
    params = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jm.apply(params, jnp.asarray(x))
    tm = load(tvit.ViTBlock(32, 2, window, ln_gemm=fused, flash_attn=fused,
                            input_hw=(side, side)), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert_rel_close(got.numpy(), want)


def test_vit_block_relpos_matters():
    """The parity above would be vacuous if the bias path had no effect."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy(rng.randn(1, 6, 6, 32).astype(np.float32))
    tm = tvit.ViTBlock(32, 2, 0, flash_attn=True, input_hw=(6, 6)).eval()
    with torch.inference_mode():
        base = tm(x)
        tm.attn.rel_pos_h.normal_(0, 0.5)
        assert (tm(x) - base).abs().max() > 1e-3


def test_window_partition_roundtrip():
    x = np.random.RandomState(2).randn(2, 9, 7, 3).astype(np.float32)
    jw, jpad = jvit.window_partition(jnp.asarray(x), 4)
    tw, tpad = tvit.window_partition(torch.from_numpy(x), 4)
    assert tuple(jpad) == tuple(tpad)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    back = tvit.window_unpartition(tw, 4, tpad, (9, 7))
    np.testing.assert_array_equal(back.numpy(), x)


def test_sam_image_encoder():
    rng = np.random.RandomState(3)
    kw = dict(img_size=64, dim=32, layers=2, heads=2, window=4, global_layers=(1,))
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    jm = jsam.SAMImageEncoder(**kw, ln_gemm=True, flash_attn=True)
    params = randomized(jm.init(jax.random.PRNGKey(0), jnp.asarray(x)), rng)
    want = jm.apply(params, jnp.asarray(x))
    tm = load(tsam.SAMImageEncoder(**kw, ln_gemm=True, flash_attn=True), params)
    with torch.inference_mode():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, 4, 4, 256)
    assert_rel_close(got.numpy(), want)


def test_prompt_encoder():
    rng = np.random.RandomState(4)
    pts = (rng.rand(2, 5, 2) * 64).astype(np.float32)
    lbl = np.array([[1, 0, -1, 1, 0], [-1, -1, 1, 1, 0]], np.int32)
    jm = jsam.PromptEncoder(embed_dim=32, img_size=64)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(pts),
                                              jnp.asarray(lbl)))
    want_emb, want_dense = jm.apply(params, jnp.asarray(pts), jnp.asarray(lbl))
    want_pe = jm.apply(params, (3, 5), method=jsam.PromptEncoder.dense_pe)
    tm = load(tsam.PromptEncoder(embed_dim=32, img_size=64), params)
    with torch.inference_mode():
        emb, dense = tm(torch.from_numpy(pts), torch.from_numpy(lbl))
        pe = tm.dense_pe((3, 5))
    assert_rel_close(emb.numpy(), want_emb)
    assert_rel_close(dense.detach().numpy(), want_dense)
    assert_rel_close(pe.numpy(), want_pe)


def test_mask_decoder():
    """Catches the ConvTranspose conversion: flax kernels are random and not
    symmetric, and the two frameworks store them flipped and transposed."""
    rng = np.random.RandomState(5)
    emb = rng.randn(2, 4, 4, 256).astype(np.float32)
    pe = rng.randn(4, 4, 256).astype(np.float32)
    sparse = rng.randn(2, 4, 256).astype(np.float32)
    dense = rng.randn(256).astype(np.float32)
    jm = jsam.MaskDecoder()
    jargs = [jnp.asarray(a) for a in (emb, pe, sparse, dense)]
    params = randomized(jm.init(jax.random.PRNGKey(0), *jargs), rng)
    want_masks, want_iou = jm.apply(params, *jargs)
    tm = load(tsam.MaskDecoder(), params)
    with torch.inference_mode():
        masks, iou = tm(*(torch.from_numpy(a) for a in (emb, pe, sparse, dense)))
    assert masks.shape == (2, 3, 16, 16) and iou.shape == (2, 3)
    assert_rel_close(masks.numpy(), want_masks)
    assert_rel_close(iou.numpy(), want_iou)


def test_sam_tiny_end_to_end_and_upscale():
    rng = np.random.RandomState(6)
    imgs = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    pts = np.tile(tcm.corner_points(64, 10), (2, 1, 1))
    lbl = np.array([[1, 1, 1, 1], [1, 0, -1, 1]], np.int32)
    jm = jsam.SAM.tiny(img_size=64)
    jargs = [jnp.asarray(a) for a in (imgs, pts, lbl)]
    params = randomized(jm.init(jax.random.PRNGKey(0), *jargs), rng)
    want_masks, want_iou = jm.apply(params, *jargs)
    tm = load(tsam.SAM.tiny(img_size=64), params)
    with torch.inference_mode():
        masks, iou = tm(*(torch.from_numpy(a) for a in (imgs, pts, lbl)))
        up = tsam.upscale_masks(masks, 64)
    assert_rel_close(masks.numpy(), want_masks)
    assert_rel_close(iou.numpy(), want_iou)
    assert_rel_close(up.numpy(), jsam.upscale_masks(want_masks, 64))


def test_corner_points():
    np.testing.assert_array_equal(tcm.corner_points(100, 7), jcm.corner_points(100, 7))


def test_sam_configs_mirror_the_jax_package():
    for name in ("vit_h", "vit_b"):
        with torch.device("meta"):
            tm = getattr(tsam.SAM, name)()
        jm = getattr(jsam.SAM, name)()
        for field in ("img_size", "patch", "dim", "layers", "heads", "window", "global_layers",
                      "out_channels"):
            assert getattr(tm.encoder, field) == getattr(jm.encoder, field), (name, field)
        assert tuple(i for i in range(tm.encoder.layers) if getattr(
            tm.encoder, f"block{i}").window == 0) == jm.encoder.global_layers


def test_corner_mask_cli_matches_jax_cli(tmp_path):
    """Both CLIs load the same synthetic segment-anything checkpoint and write
    masks for the same PNGs. Inputs of the model's own size pass through no
    resize, so the masks are equal but for logits within rounding of 0: at
    most 2 pixels per mask may differ. The 96-pixel inputs also go through
    OpenCV's 8-bit bilinear resize on the JAX side (the port's is float32):
    at most 1 % of a mask's pixels may differ there."""
    sd = synthetic_sam_state_dict(np.random.RandomState(7), **SAM_TINY)
    ckpt = str(tmp_path / "sam_tiny.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    in_dir = tmp_path / "gen"
    rng = np.random.RandomState(8)
    for cat, size in (("same", 64), ("resized", 96)):
        (in_dir / cat).mkdir(parents=True)
        for i in range(3):
            img = cv2.GaussianBlur(rng.randint(0, 255, (size, size, 3)).astype(np.uint8), (9, 9), 3)
            cv2.imwrite(str(in_dir / cat / f"7_{i:07d}.png"), img)
    common = ["--in_dir", str(in_dir), "--img_size", "64", "--batch", "2", "--tiny",
              "--sam_checkpoint", ckpt]
    assert jcm.main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert tcm.main(common + ["--out_dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    for cat, size, allowed in (("same", 64, 2), ("resized", 96, 96 * 96 // 100)):
        names = sorted(os.listdir(tmp_path / "jax" / cat))
        assert names == sorted(os.listdir(tmp_path / "torch" / cat)) == [
            f"7_{i:07d}.png" for i in range(3)]
        for name in names:
            want = cv2.imread(str(tmp_path / "jax" / cat / name), cv2.IMREAD_UNCHANGED)
            got = cv2.imread(str(tmp_path / "torch" / cat / name), cv2.IMREAD_UNCHANGED)
            assert got.shape == want.shape == (size, size)
            assert set(np.unique(got)) <= {0, 255}
            assert 0 < (want == 255).mean() < 1  # a mask with both values
            assert (got != want).sum() <= allowed, (cat, name, (got != want).sum())
    # resume: a second run rewrites nothing
    path = tmp_path / "torch" / "same" / "7_0000000.png"
    before = os.path.getmtime(path)
    tcm.main(common + ["--out_dir", str(tmp_path / "torch"), "--device", "cpu"])
    assert os.path.getmtime(path) == before


def test_corner_mask_cli_rejects_jpeg(tmp_path):
    """The corner-mask CLI reads baseline JPEGs as the JAX CLI does (the
    decoder gives ``cv2.imread``'s pixels, so the masks are the JPEG inputs'
    counterpart of test_corner_mask_cli_matches_jax_cli's, at most 2 pixels a
    mask apart) and rejects the JPEGs the port does not decode (progressive),
    naming the file."""
    sd = synthetic_sam_state_dict(np.random.RandomState(7), **SAM_TINY)
    ckpt = str(tmp_path / "sam_tiny.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    rng = np.random.RandomState(8)
    (tmp_path / "in" / "c").mkdir(parents=True)
    for i in range(3):
        img = cv2.GaussianBlur(rng.randint(0, 255, (64, 64, 3)).astype(np.uint8), (9, 9), 3)
        cv2.imwrite(str(tmp_path / "in" / "c" / f"7_{i:07d}.jpg"), img,
                    [cv2.IMWRITE_JPEG_QUALITY, 85])
    common = ["--in_dir", str(tmp_path / "in"), "--img_size", "64", "--batch", "2", "--tiny",
              "--sam_checkpoint", ckpt]
    assert jcm.main(common + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert tcm.main(common + ["--out_dir", str(tmp_path / "torch"), "--device", "cpu"]) == 0
    names = sorted(os.listdir(tmp_path / "jax" / "c"))
    assert names == sorted(os.listdir(tmp_path / "torch" / "c")) == [
        f"7_{i:07d}.png" for i in range(3)]
    for name in names:
        want = cv2.imread(str(tmp_path / "jax" / "c" / name), cv2.IMREAD_UNCHANGED)
        got = cv2.imread(str(tmp_path / "torch" / "c" / name), cv2.IMREAD_UNCHANGED)
        assert got.shape == want.shape == (64, 64)
        assert 0 < (want == 255).mean() < 1
        assert (got != want).sum() <= 2, (name, (got != want).sum())
    (tmp_path / "prog" / "c").mkdir(parents=True)
    bad = str(tmp_path / "prog" / "c" / "a.jpg")
    cv2.imwrite(bad, np.zeros((64, 64, 3), np.uint8), [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])
    with pytest.raises(ValueError, match="progressive") as err:
        tcm.main(["--in_dir", str(tmp_path / "prog"), "--out_dir", str(tmp_path / "out"),
                  "--img_size", "64", "--tiny", "--device", "cpu"])
    assert bad in str(err.value)
