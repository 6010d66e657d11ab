"""The port's deployment export (``divergen_tpu_torch/export.py``) against
its eager forward and against the JAX package's StableHLO artifact.

The detector of ``tests/test_export.py`` (ResNet-18 + FPN, 8 classes, 128²
canvas, the same ``RandomState(3)`` image), built in both packages from one
flax tree (``test_torch_detector.shape_init`` + ``randomized``, so that
detections are decided by more than rounding) through ``params_from_jax``.
The port's artifact, exported, saved and loaded (weights-separate and baked),
matches the port's eager forward to 1e-5, and the JAX artifact run through
JAX's own ``load_exported`` to 1e-4 of max |reference| in every output key
(rows that are not valid zeroed on both sides: they hold score -inf in any
order). A canvas of another shape raises.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu import export as jexport
from divergen_tpu.config import get_cfg as jget_cfg
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu_torch import export as texport
from divergen_tpu_torch.config import get_cfg as tget_cfg
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from test_torch_detector import assert_rel_close, load, masked, randomized, shape_init, t

torch.set_num_threads(1)
IMG = 128


def small_cfg(get_cfg):
    """tests/test_export.py's config."""
    cfg = get_cfg()
    cfg.MODEL.CENTERNET.NUM_CLASSES = 8
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 8
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.CENTERNET.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.CENTERNET.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TEST.DETECTIONS_PER_IMAGE = 16
    cfg.FP16 = False
    return cfg


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    images = (np.random.RandomState(3).rand(1, IMG, IMG, 3).astype(np.float32) * 255)
    sizes = np.asarray([[IMG, IMG]], np.int32)
    jm = jrcnn.build_model(small_cfg(jget_cfg))
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes),
                                   training=False), np.random.RandomState(5))
    exp = jexport.export_inference(jm, params, batch=1, height=IMG, width=IMG)
    jloaded = jexport.load_exported(exp.serialize())
    jwant = jax.tree.map(np.asarray, jloaded(params, jnp.asarray(images), jnp.asarray(sizes)))
    tm = load(trcnn.build_model(small_cfg(tget_cfg), input_size=(IMG, IMG)), params)
    with torch.no_grad():
        eager = tm(t(images), t(sizes))
    tmp = tmp_path_factory.mktemp("export")
    loaded, paths = {}, {}
    for bake in (False, True):
        paths[bake] = texport.save_exported(
            texport.export_inference(tm, tm.state_dict(), batch=1, height=IMG, width=IMG,
                                     bake_params=bake),
            str(tmp / f"det_{bake}.pt2z"))
        loaded[bake] = texport.load_exported(paths[bake])
    return tm, images, sizes, eager, jwant, loaded, paths


def run(loaded, tm, images, sizes):
    args = (t(images), t(sizes))
    return loaded(*args) if loaded.baked else loaded(tm.state_dict(), *args)


@pytest.mark.parametrize("bake", [False, True], ids=["weights_separate", "baked"])
def test_artifact_matches_eager_forward(case, bake):
    tm, images, sizes, eager, _, loaded, _ = case
    art = loaded[bake]
    assert art.platforms == ("cpu",) and art.baked == bake
    assert art.in_avals[-2:] == (texport.Aval((1, IMG, IMG, 3), torch.float32),
                                 texport.Aval((1, 2), torch.int32))
    assert len(art.in_avals) == (2 if bake else 2 + len(tm.state_dict()))
    got = run(art, tm, images, sizes)
    assert set(got) == set(eager) and eager["valid"].any()
    for k in eager:
        np.testing.assert_allclose(got[k].numpy(), eager[k].numpy(), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("bake", [False, True], ids=["weights_separate", "baked"])
def test_artifact_matches_jax_artifact(case, bake):
    tm, images, sizes, _, jwant, loaded, _ = case
    got = {k: v.numpy() for k, v in run(loaded[bake], tm, images, sizes).items()}
    assert set(got) == set(jwant)
    valid = jwant["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.sum() > 2
    for k in jwant:
        assert_rel_close(masked(got[k], valid).astype(np.float64),
                         masked(jwant[k], valid).astype(np.float64), 1e-4)


@pytest.mark.parametrize("bake", [False, True], ids=["weights_separate", "baked"])
def test_artifact_rejects_wrong_shape(case, bake):
    tm, _, sizes, _, _, loaded, _ = case
    bad = np.zeros((1, IMG * 2, IMG * 2, 3), np.float32)
    with pytest.raises(Exception, match="shape"):
        run(loaded[bake], tm, bad, sizes)


def test_artifact_loads_from_bytes_without_model_code(case, tmp_path):
    """The artifact's bytes load in a process that imports only the export
    module and the ops (no modeling code), and give the same detections."""
    import subprocess
    import sys

    tm, images, sizes, eager, _, _, paths = case
    path = paths[True]
    np.save(tmp_path / "images.npy", images)
    np.save(tmp_path / "sizes.npy", sizes)
    code = f"""
import sys, numpy as np, torch
from divergen_tpu_torch.export import load_exported
art = load_exported(open({str(path)!r}, "rb").read())
out = art(torch.from_numpy(np.load({str(tmp_path / 'images.npy')!r})),
          torch.from_numpy(np.load({str(tmp_path / 'sizes.npy')!r})))
np.savez({str(tmp_path / 'out.npz')!r}, **{{k: v.numpy() for k, v in out.items()}})
bad = sorted(m for m in sys.modules if m.startswith("divergen_tpu_torch.modeling")
             or m.startswith("divergen_tpu_torch.config") or m.startswith("jax"))
assert not bad, bad
"""
    root = str(importlib.import_module("divergen_tpu_torch").__path__[0]).rsplit("/", 1)[0]
    subprocess.run([sys.executable, "-c", code], check=True, cwd=root, timeout=600,
                   env={"PATH": "/usr/bin:/bin", "PYTHONPATH": root, "OMP_NUM_THREADS": "1"})
    got = np.load(tmp_path / "out.npz")
    for k in eager:
        np.testing.assert_allclose(got[k], eager[k].numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
