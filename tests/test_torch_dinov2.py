"""The port's DINOv2 tower and ``DinoEncoder`` against the JAX package's, on
the same flax weights (``params_from_jax``) and numpy images, on the CPU.

A narrow ViT (dim 64, depth 2, 4 heads) with the exact-GELU MLP and with the
SwiGLU one: the cls embedding in float32 within 1e-4 of max |reference|, in
bfloat16 within 2e-2 (the two packages round the bf16 products in another
order). The encoder's normalized embeddings within 1e-4, the last chunk
padded; ``extract_features --method dinov2`` writes unit-norm ``.npy``
files equal to the encoder's.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import dinov2 as jdino
from divergen_tpu.pipeline.filteration import core as jcore
from divergen_tpu_torch.modeling.backbone import dinov2 as tdino
from divergen_tpu_torch.pipeline.filteration import cli as tcli
from divergen_tpu_torch.pipeline.filteration import core as tcore
from divergen_tpu_torch.utils.convert import params_from_jax
from divergen_tpu_torch.utils.png import write_png
from test_torch_detector import assert_rel_close, t

torch.set_num_threads(1)

NARROW = dict(dim=64, depth=2, heads=4)


def narrow_params(swiglu, size, seed):
    """flax init of the narrow tower, LayerScale and the norms' affine moved
    off their initial values so that every branch counts."""
    jm = jdino.DinoV2(swiglu=swiglu, **NARROW)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                              jnp.zeros((1, size, size, 3))))
    rng = np.random.RandomState(seed)

    def walk(node):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ("ls1", "ls2"):
                node[k] = (rng.rand(*v.shape) * 0.5 + 0.25).astype(np.float32)
            elif k in ("scale", "bias") and v.ndim == 1:
                node[k] = (v + rng.randn(*v.shape) * 0.1).astype(np.float32)
    walk(params["params"])
    return jm, params


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("swiglu", [False, True], ids=["gelu", "swiglu"])
def test_dinov2_forward(swiglu, dtype):
    size = 42  # a 3 x 3 grid
    jm, params = narrow_params(swiglu, size, 1)
    images = (np.random.RandomState(2).rand(3, size, size, 3) * 255).astype(np.float32)
    x = jdino.dinov2_preprocess(jnp.asarray(images))
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    want = jax.jit(jdino.DinoV2(swiglu=swiglu, dtype=jdt, **NARROW).apply)(params, x)
    tm = tdino.DinoV2(swiglu=swiglu, image_size=size, dtype=tdt, **NARROW)
    tm.load_state_dict(params_from_jax(params))
    got_x = tdino.dinov2_preprocess(t(images))
    np.testing.assert_allclose(got_x.numpy(), np.asarray(x), rtol=1e-6, atol=1e-6)
    with torch.no_grad():
        got = tm(got_x)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    assert_rel_close(got.numpy(), want, 1e-4 if dtype == "float32" else 2e-2)
    if swiglu:
        assert tm.block0.w12.out_features == 2 * 176  # 2/3 · 4 · 64 = 170.7, rounded up to 8


def test_dinov2_sizes_and_grid():
    assert tdino.SIZES == jdino._SIZES
    tm = tdino.DinoV2.from_name("dinov2_vitg14", device="meta")
    assert (tm.dim, tm.depth, tm.block0.attn.heads, tm.block0.w3.in_features) == (1536, 40, 24, 4096)
    assert tm.pos_embed.shape == (1, 257, 1536)
    # the JAX parameter tree of every size has the port's names and shapes
    for name in tdino.SIZES:
        jm = jdino.DinoV2.from_name(name)
        tree = jax.eval_shape(lambda k: jm.init(k, jnp.zeros((1, 28, 28, 3))), jax.random.PRNGKey(0))
        port = tdino.DinoV2.from_name(name, image_size=28, device="meta")
        want = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(tree)))
        assert {k: tuple(v.shape) for k, v in port.state_dict().items()} == {
            k: tuple(v.shape) for k, v in want.items()}, name
    small = tdino.DinoV2(image_size=28, **NARROW)
    with pytest.raises(ValueError, match="not interpolated"):
        small(torch.zeros(1, 42, 42, 3))
    # flax "SAME": a 30² input is padded to three patches a side
    assert tdino.DinoV2(image_size=30, **NARROW).grid == 3


def test_dino_encoder_matches_jax(tmp_path):
    size = 28
    jm, params = narrow_params(True, size, 3)
    images = (np.random.RandomState(4).rand(5, size, size, 3) * 255).astype(np.float32)
    jenc = jcore.DinoEncoder.__new__(jcore.DinoEncoder)
    jenc.batch, jenc.model, jenc._jnp, jenc.params = 2, jm, jnp, params
    jenc._embed_images = jax.jit(lambda p, im: (lambda f: f / jnp.maximum(
        jnp.linalg.norm(f, axis=-1, keepdims=True), 1e-8))(jm.apply(p, jdino.dinov2_preprocess(im))))
    want = jenc.encode_images(images)

    tenc = tcore.DinoEncoder.__new__(tcore.DinoEncoder)
    tenc.device, tenc.batch = torch.device("cpu"), 2
    tenc.model = tdino.DinoV2(swiglu=True, image_size=size, **NARROW).eval()
    tenc.model.load_state_dict(params_from_jax(params))
    got = tenc.encode_images(images)
    assert got.shape == (5, 64)
    np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0, rtol=1e-5)
    assert_rel_close(got, want, 1e-4)
    assert tenc.encode_images(images[:0]).shape == (0, 1)


def test_extract_features_dinov2(tmp_path):
    rng = np.random.RandomState(5)
    for cat in ("apple", "chair"):
        os.makedirs(tmp_path / "in" / cat)
        for i in range(3):
            write_png(str(tmp_path / "in" / cat / f"{i}.png"),
                      rng.randint(0, 256, (40 + 8 * i, 50, 3), dtype=np.uint8))
    argv = ["--in_dir", str(tmp_path / "in"), "--out_dir", str(tmp_path / "out"),
            "--method", "dinov2", "--dino_model", "vits14", "--batch", "4", "--device", "cpu"]
    assert tcli.extract_features(argv) == 0
    feats = np.stack([np.load(tmp_path / "out" / "apple" / f"{i}.npy") for i in range(3)])
    assert feats.shape == (3, 384)
    np.testing.assert_allclose(np.linalg.norm(feats, axis=1), 1.0, rtol=1e-5)
    # the CLI's encoder: seed 0, 224² crops of the same files
    enc = tcore.DinoEncoder("vits14", batch=4, device="cpu")
    imgs = np.stack([tcore.load_masked_image(str(tmp_path / "in" / "apple" / f"{i}.png"))[0]
                     for i in range(3)])
    np.testing.assert_allclose(enc.encode_images(imgs), feats, rtol=1e-5, atol=1e-6)
