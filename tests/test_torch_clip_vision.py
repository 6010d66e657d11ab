"""The port's CLIP vision tower, ``ClipEncoder`` and filtration CLIs against
the JAX package, same weights and inputs.

Weights come from flax ``init`` or from one synthetic openai-CLIP checkpoint
that both packages load; numpy makes the inputs; both run in float32 on the
CPU. Tolerance for towers and features: max |Δ| ≤ 1e-4 · max |reference|.
"""
import json
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.text import clip as jclip
from divergen_tpu.pipeline.filteration import cli as jcli
from divergen_tpu.pipeline.filteration import core as jcore
from divergen_tpu_torch.modeling.text import clip as tclip
from divergen_tpu_torch.pipeline.filteration import cli as tcli
from divergen_tpu_torch.pipeline.filteration import core as tcore
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_port_weights import CLIP_TINY, synthetic_clip_state_dict

torch.set_num_threads(1)
TOL = 1e-4
TINY = (CLIP_TINY["embed"], CLIP_TINY["vision"], CLIP_TINY["text"])


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture
def tiny_clip(monkeypatch):
    """Swap ViT-L/14 for a tiny tower in both packages."""
    monkeypatch.setitem(jclip.CLIP_CONFIGS, "ViT-L/14", TINY)
    monkeypatch.setitem(tclip.CLIP_CONFIGS, "ViT-L/14", TINY)


def save_ckpt(tmp_path, image_size):
    sd = synthetic_clip_state_dict(np.random.RandomState(0),
                                   **dict(CLIP_TINY, image_size=image_size))
    path = str(tmp_path / f"clip_tiny_{image_size}.pt")
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, path)
    return path


def test_clip_vision_tower():
    rng = np.random.RandomState(1)
    kw = dict(embed_dim=24, image_size=28, patch=14, width=32, heads=2, layers=2)
    x = rng.randn(3, 28, 28, 3).astype(np.float32)
    jm = jclip.CLIPVision(**kw)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    want = jm.apply(params, jnp.asarray(x))
    tm = tclip.CLIPVision(**kw)
    tm.load_state_dict(params_from_jax(params), strict=True)
    with torch.inference_mode():
        got = tm.eval()(torch.from_numpy(x))
    assert_rel_close(got.numpy(), want)


def test_preprocess_and_normalize():
    rng = np.random.RandomState(2)
    imgs = rng.randint(0, 256, (2, 5, 7, 3)).astype(np.uint8)
    assert_rel_close(tclip.preprocess_images(torch.from_numpy(imgs)).numpy(),
                     jclip.preprocess_images(jnp.asarray(imgs)), 1e-6)
    v = rng.randn(4, 9).astype(np.float32)
    v[1] = 0
    assert_rel_close(tclip.normalize(torch.from_numpy(v)).numpy(),
                     jclip.normalize(jnp.asarray(v)), 1e-6)
    assert tclip.CLIP_CONFIGS == jclip.CLIP_CONFIGS
    assert tclip.CLIP_PIXEL_MEAN == jclip.CLIP_PIXEL_MEAN
    assert tclip.CLIP_PIXEL_STD == jclip.CLIP_PIXEL_STD


def test_clip_encoder_ragged_last_batch(tmp_path, tiny_clip):
    from divergen_tpu.utils.torch_weights import load_clip_params as jload
    from divergen_tpu_torch.utils.torch_weights import load_clip_params as tload

    clip_ckpt = save_ckpt(tmp_path, 32)
    rng = np.random.RandomState(3)
    imgs = (rng.rand(5, 32, 32, 3) * 255).astype(np.float32)  # batches of 2, 2, 1
    toks = rng.randint(1, 49407, (3, 77)).astype(np.int32)
    jenc = jcore.ClipEncoder(batch=2, params=jload(clip_ckpt), image_size=32)
    tenc = tcore.ClipEncoder(batch=2, params=tload(clip_ckpt), image_size=32, device="cpu")
    got = tenc.encode_images(imgs)
    assert got.shape == (5, 16)
    assert_rel_close(got, jenc.encode_images(imgs))
    assert_rel_close(tenc.encode_texts(toks), jenc.encode_texts(toks))
    np.testing.assert_allclose(np.linalg.norm(got, axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("shape", [(48, 48), (60, 90), (300, 250), (224, 224)])
def test_clip_preprocess_np_against_opencv(shape):
    """``F.interpolate`` bicubic has OpenCV's a = −0.75 kernel; OpenCV works
    in 8-bit fixed point, so a pixel may land on the neighbouring gray level:
    max |Δ| ≤ 2 of 255, mean |Δ| ≤ 0.3. Smoothed noise, like a photograph."""
    rng = np.random.RandomState(4)
    img = cv2.GaussianBlur(rng.randint(0, 256, shape + (3,)).astype(np.uint8), (5, 5), 1.5)
    got = tcore.clip_preprocess_np(img, 224)
    want = jcore.clip_preprocess_np(img, 224)
    assert got.shape == want.shape == (224, 224, 3) and got.dtype == np.float32
    diff = np.abs(got - want)
    assert diff.max() <= 2 and diff.mean() <= 0.3, (diff.max(), diff.mean())


def test_load_masked_image(tmp_path):
    rng = np.random.RandomState(5)
    img = rng.randint(0, 256, (224, 224, 3)).astype(np.uint8)
    mask = np.zeros((112, 112), np.uint8)  # half size: the nearest resize runs
    mask[20:90, 30:100] = 255
    cv2.imwrite(str(tmp_path / "a.png"), img[..., ::-1])
    cv2.imwrite(str(tmp_path / "m.png"), mask)
    for bg in ("zero", "white"):
        got, gfrac = tcore.load_masked_image(str(tmp_path / "a.png"), str(tmp_path / "m.png"), bg)
        want, wfrac = jcore.load_masked_image(str(tmp_path / "a.png"), str(tmp_path / "m.png"), bg)
        np.testing.assert_array_equal(got, want)
        assert gfrac == wfrac
    got, frac = tcore.load_masked_image(str(tmp_path / "a.png"), str(tmp_path / "none.png"))
    np.testing.assert_array_equal(got, img.astype(np.float32))
    assert frac == 1.0


def test_artifact_helpers_equal_the_originals(tmp_path):
    total = {"l1.png": {"g1.png": 0.9, "g2.png": 0.1}, "l2.png": {"g1.png": 0.7, "g2.png": 0.2}}
    assert tcore.filename_pivot(total) == jcore.filename_pivot(total)
    fd = tcore.filename_pivot(total)
    assert tcore.threshold_filter(fd, 0.5) == jcore.threshold_filter(fd, 0.5)
    for name, tfn, jfn, arg in (("t", tcore.dict_to_csv, jcore.dict_to_csv, total),
                                ("f", tcore.filename_dict_to_csv, jcore.filename_dict_to_csv, fd)):
        tfn(arg, str(tmp_path / f"{name}_t.csv"))
        jfn(arg, str(tmp_path / f"{name}_j.csv"))
        assert (tmp_path / f"{name}_t.csv").read_text() == (tmp_path / f"{name}_j.csv").read_text()
    a = np.random.RandomState(6).randn(3, 4).astype(np.float32)
    np.testing.assert_array_equal(tcore.cosine_matrix(a, a), jcore.cosine_matrix(a, a))
    assert tcore.shard_indices(7, 1, 3) == jcore.shard_indices(7, 1, 3) == [1, 4]
    assert tcore.shard_indices(3) == [0, 1, 2]


def test_dino_encoder_is_not_ported():
    # DinoEncoder is ported (tests/test_torch_dinov2.py); as every entry point it
    # runs on the card unless the caller names another device, and nothing falls
    # back to the CPU
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tcore.DinoEncoder("vits14")
    enc = tcore.DinoEncoder("vits14", batch=2, image_size=28, device="cpu")
    assert enc.encode_images(np.zeros((3, 28, 28, 3), np.uint8)).shape == (3, 384)


def test_filtration_chain_matches_jax_cli(tmp_path, tiny_clip):
    """extract_features → compute_similarity → filter_by_similarity, and
    clip_score, through both packages' CLIs on the same files and the same
    checkpoint. Images are 224 px, so neither side resizes; features and
    scores then agree to 1e-4."""
    clip_ckpt = save_ckpt(tmp_path, 224)  # the CLIs build their towers for 224 px
    rng = np.random.RandomState(7)
    cats = ["17", "42"]
    for root, n in (("gen", 3), ("lvis", 2)):
        for c in cats:
            os.makedirs(tmp_path / root / c)
            for i in range(n):
                cv2.imwrite(str(tmp_path / root / c / f"{c}_{i:07d}.png"),
                            rng.randint(0, 255, (224, 224, 3), np.uint8))
    for c in cats:
        os.makedirs(tmp_path / "masks" / c)
        for i in range(3):
            m = np.zeros((224, 224), np.uint8)
            m[40:180, 30:200] = 255
            cv2.imwrite(str(tmp_path / "masks" / c / f"{c}_{i:07d}.png"), m)

    def chain(cli, out, extra):
        out = tmp_path / out
        common = ["--clip_ckpt", clip_ckpt, "--batch", "2"] + extra
        assert cli.extract_features(["--in_dir", str(tmp_path / "gen"), "--out_dir",
                                     str(out / "gen_feat"), "--mask_dir",
                                     str(tmp_path / "masks")] + common) == 0
        assert cli.extract_features(["--in_dir", str(tmp_path / "lvis"), "--out_dir",
                                     str(out / "lvis_feat")] + common) == 0
        assert cli.compute_similarity(["--lvis_feature_dir", str(out / "lvis_feat"),
                                       "--gen_feature_dir", str(out / "gen_feat"),
                                       "--out_dir", str(out / "sim")]) == 0
        assert cli.filter_by_similarity(["--sim_dir", str(out / "sim"), "--out_path",
                                         str(out / "filtered" / "filename.csv"),
                                         "--threshold", "-1.0", "--save_filtered_out"]) == 0
        assert cli.clip_score(["--in_dir", str(tmp_path / "gen"), "--mask_dir",
                               str(tmp_path / "masks"), "--out_dir", str(out / "scores")]
                              + common) == 0
        return out

    jout = chain(jcli, "jax", [])
    tout = chain(tcli, "torch", ["--device", "cpu"])

    assert len(os.listdir(tout / "gen_feat" / "17")) == 3
    for side in ("gen_feat", "lvis_feat"):
        for c in cats:
            for f in sorted(os.listdir(jout / side / c)):
                assert_rel_close(np.load(tout / side / c / f), np.load(jout / side / c / f))
    jtotal = json.load(open(jout / "sim" / "17" / "total.json"))
    ttotal = json.load(open(tout / "sim" / "17" / "total.json"))
    assert list(ttotal) == list(jtotal) and len(ttotal) == 2
    for k in jtotal:
        assert list(ttotal[k]) == list(jtotal[k]) and len(ttotal[k]) == 3
        np.testing.assert_allclose(list(ttotal[k].values()), list(jtotal[k].values()), atol=1e-4)
    for name in ("total.csv", "total_filename.csv", "total_filename.json"):
        assert os.path.exists(tout / "sim" / "17" / name)
    kept = json.load(open(tout / "filtered" / "filename_thres_-1.0.json"))
    assert set(kept) == {"17", "42"} and len(kept["17"]) == 3
    assert json.load(open(tout / "filtered" / "filename_thres_-1.0_filtered_out.json")) == {
        "17": {}, "42": {}}
    jres = json.load(open(jout / "scores" / "results.json"))
    tres = json.load(open(tout / "scores" / "results.json"))
    assert set(tres) == set(jres) and len(tres) == 6
    for k in jres:
        assert abs(tres[k]["clip_score"] - jres[k]["clip_score"]) <= 1e-4
        assert tres[k]["mask_area"] == jres[k]["mask_area"]
        assert 0.0 < tres[k]["mask_area"] < 1.0
