"""The standalone CenterNet against the JAX package, float32 on the CPU: the
classwise ground truth, the classwise losses (``NOT_NORM_REG`` true and
false, with and without the agnostic heatmap) with their gradients, the
classwise detections, and ``CenterNetDetector`` through ``build_model``
(training losses and inference detections of the small ResNet-18 detector).

``NOT_NORM_REG: false`` weights the regression by the heatmap's maximum over
an image's locations: the JAX package takes the maximum over the last axis of
the (B, M) agnostic heatmap, which broadcasts against (B, M) only at B = 1,
so that case is compared at B = 1 (the port raises at other B). Tolerances: targets, counts and picks equal (heatmaps 1e-6); losses
1e-4 relative, their gradients 1e-4 of max |reference|; detections with the
same valid slots and classes, boxes within 1e-2 px and scores within 1e-4.
"""
import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.centernet import centernet as jcn
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling.centernet import centernet as tcn
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_detector import (LEVEL_SHAPES, assert_rel_close, compare_detections, randomized,
                                 shape_init, t)
from test_torch_train_losses import assert_losses_close, total_of

torch.set_num_threads(1)

C = 5
CN = dict(num_classes=C, only_proposal=False, pre_nms_topk_test=40, post_nms_topk_test=20,
          pre_nms_total=120, score_thresh=0.05)


def gt_case(seed, b=2, n=7):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, n, 2) * 90
    boxes = np.concatenate([xy, xy + rng.rand(b, n, 2) * 60 + 6], -1).astype(np.float32)
    classes = rng.randint(0, C, (b, n)).astype(np.int32)
    classes[:, 1] = classes[:, 0]  # two ground truths of one class in each image
    valid = np.arange(n)[None] < np.array([[n - 1], [n - 3]])[:b]
    return boxes, classes, valid


def configs(**kw):
    return jcn.CenterNetConfig(**CN, **kw), tcn.CenterNetConfig(**CN, **kw)


def geometries(jcfg, tcfg):
    return jcn.level_geometry(jcfg, LEVEL_SHAPES), tcn.level_geometry(tcfg, LEVEL_SHAPES)


def test_classwise_ground_truth():
    boxes, classes, valid = gt_case(1)
    jcfg, tcfg = configs()
    jgeom, tgeom = geometries(jcfg, tcfg)
    want = jax.jit(lambda *a: jcn.centernet_ground_truth_classwise(jcfg, jgeom, *a))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    got = tcn.centernet_ground_truth_classwise(tcfg, tgeom, t(boxes), t(classes), t(valid))
    reg, hm_agn, hm_cls, pos = (np.asarray(w) for w in want)
    np.testing.assert_array_equal(got[0].numpy(), reg)
    np.testing.assert_allclose(got[1].numpy(), hm_agn, atol=1e-6)
    np.testing.assert_allclose(got[2].numpy(), hm_cls, atol=1e-6)
    np.testing.assert_array_equal(got[3].numpy(), pos)
    assert pos.sum() > 3 and (hm_cls > 0).any(axis=(0, 1)).sum() >= 3
    # the agnostic heatmap is the maximum over the classes'
    np.testing.assert_allclose(got[2].amax(dim=-1).numpy(), hm_agn, atol=1e-6)


@pytest.mark.parametrize("not_norm_reg,agn,b", [(True, True, 2), (True, False, 2),
                                                (False, True, 1), (False, False, 1)])
def test_classwise_losses(not_norm_reg, agn, b):
    boxes, classes, valid = gt_case(2, b)
    jcfg, tcfg = configs(not_norm_reg=not_norm_reg, with_agn_hm=agn)
    jgeom, tgeom = geometries(jcfg, tcfg)
    targets = jax.jit(lambda *a: jcn.centernet_ground_truth_classwise(jcfg, jgeom, *a))(
        jnp.asarray(boxes), jnp.asarray(classes), jnp.asarray(valid))
    m = jgeom["grids"].shape[0]
    rng = np.random.RandomState(3)
    cls = (rng.randn(b, m, C) * 2 - 2).astype(np.float32)
    agn_hm = (rng.randn(b, m) * 2 - 2).astype(np.float32) if agn else None
    reg = (rng.rand(b, m, 4) * 4).astype(np.float32)

    def jloss(c, a, r):
        return jcn.centernet_losses_classwise(jcfg, c, a, r, *targets)

    args = [jnp.asarray(cls), None if agn_hm is None else jnp.asarray(agn_hm), jnp.asarray(reg)]
    argnums = (0, 1, 2) if agn else (0, 2)
    (_, want), want_g = jax.jit(jax.value_and_grad(lambda *a: (total_of(jloss(*a)), jloss(*a)),
                                                   argnums=argnums, has_aux=True))(*args)
    leaves = [t(cls), None if agn_hm is None else t(agn_hm), t(reg)]
    for x in leaves:
        if x is not None:
            x.requires_grad_(True)
    got = tcn.centernet_losses_classwise(tcfg, leaves[0], leaves[1], leaves[2],
                                         *(t(np.asarray(x)) for x in targets))
    assert ("loss_centernet_agn_pos" in got) == agn and "loss_centernet_pos" in got
    assert_losses_close(got, want)
    total_of(got).backward()
    for x, w in zip([x for x in leaves if x is not None], want_g):
        assert_rel_close(x.grad.numpy(), np.asarray(w), 1e-4)


def test_heatmap_weighted_regression_one_image():
    """The heatmap-weighted regression runs at one image, as the JAX loss
    does, and raises at two with the fault named. (The weight is the
    heatmap's maximum, 1 wherever an image has a valid ground truth, its
    centre's peak, so the loss equals ``NOT_NORM_REG: true``'s there.)"""
    boxes, classes, valid = gt_case(4)
    _, tcfg = configs(not_norm_reg=False)
    geom = tcn.level_geometry(tcfg, LEVEL_SHAPES)
    reg_t, hm, _, pos = tcn.centernet_ground_truth_classwise(tcfg, geom, t(boxes), t(classes),
                                                             t(valid))
    m = geom["grids"].shape[0]
    reg = t((np.random.RandomState(5).rand(2, m, 4) * 4).astype(np.float32))
    agn = torch.zeros(2, m)
    with pytest.raises(ValueError, match="NOT_NORM_REG false at a batch of 2 images"):
        tcn.centernet_losses(tcfg, agn, reg, reg_t, hm, pos.sum(-1))
    for i in range(2):
        one = tcn.centernet_losses(tcfg, agn[i:i + 1], reg[i:i + 1], reg_t[i:i + 1],
                                   hm[i:i + 1], pos[i:i + 1].sum(-1))
        unweighted = tcn.centernet_losses(dataclasses.replace(tcfg, not_norm_reg=True),
                                          agn[i:i + 1], reg[i:i + 1], reg_t[i:i + 1],
                                          hm[i:i + 1], pos[i:i + 1].sum(-1))
        assert hm[i].amax().item() == 1.0
        np.testing.assert_allclose(one["loss_centernet_loc"].item(),
                                   unweighted["loss_centernet_loc"].item(), rtol=1e-6)


def test_classwise_detections():
    jcfg, tcfg = configs()
    jgeom, tgeom = geometries(jcfg, tcfg)
    m = jgeom["grids"].shape[0]
    rng = np.random.RandomState(6)
    cls = (rng.randn(2, m, C) * 2 - 2.5).astype(np.float32)
    agn = (rng.randn(2, m) * 1.5).astype(np.float32)
    reg = (rng.rand(2, m, 4) * 3 + 0.5).astype(np.float32)
    sizes = np.array([[96, 128], [80, 100]], np.int32)
    for a in (agn, None):
        jc, tc = (jcfg, tcfg) if a is not None else (
            dataclasses.replace(jcfg, with_agn_hm=False), dataclasses.replace(tcfg, with_agn_hm=False))
        want = jax.jit(lambda *x: jcn.centernet_detections(jc, jgeom, *x, training=False))(
            jnp.asarray(cls), None if a is None else jnp.asarray(a), jnp.asarray(reg),
            jnp.asarray(sizes))
        got = tcn.centernet_detections(tc, tgeom, t(cls), None if a is None else t(a), t(reg),
                                       t(sizes), training=False)
        assert got["boxes"].shape == (2, 20, 4)
        compare_detections(got, want)
        assert len(np.unique(np.asarray(want["classes"])[np.asarray(want["valid"])])) >= 3


# -- CenterNetDetector through build_model ------------------------------------------------

@pytest.fixture(scope="module")
def detector():
    jentry = importlib.import_module("__graft_entry__")
    jcfg, tcfg = jentry._small_cfg(), tge._small_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(["MODEL.META_ARCHITECTURE", "CenterNetDetector",
                             "MODEL.CENTERNET.NUM_CLASSES", C, "MODEL.FPN.OUT_CHANNELS", 32,
                             "MODEL.CENTERNET.POST_NMS_TOPK_TEST", 16])
    rng = np.random.RandomState(7)
    images = (rng.rand(2, 64, 64, 3) * 255).astype(np.float32)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    boxes, classes, valid = gt_case(8)
    gt = {"boxes": boxes * 0.6, "classes": classes, "valid": valid}
    jm = jrcnn.build_model(jcfg)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes),
                                   gt=jax.tree.map(jnp.asarray, gt), rng=jax.random.PRNGKey(0),
                                   training=True), rng)
    assert "roi_heads" not in params["params"]
    tm = trcnn.build_model(tcfg, input_size=(64, 64))
    assert isinstance(tm, trcnn.CenterNetDetector) and not hasattr(tm, "roi_heads")
    assert tm.centernet_cfg.only_proposal is False
    tm.load_state_dict(params_from_jax(params, tm), strict=True)
    return jm, params, tm, images, sizes, gt


def test_centernet_detector_training_losses(detector):
    jm, params, tm, images, sizes, gt = detector
    want = jax.jit(lambda p: jm.apply(p, jnp.asarray(images), jnp.asarray(sizes),
                                      gt=jax.tree.map(jnp.asarray, gt), training=True))(params)
    got = tm(t(images), t(sizes), gt={k: t(v) for k, v in gt.items()}, training=True,
             rng=torch.Generator().manual_seed(0), fed_weight=None)
    assert sorted(got) == sorted(["loss_centernet_loc", "loss_centernet_agn_pos",
                                  "loss_centernet_agn_neg", "loss_centernet_pos",
                                  "loss_centernet_neg"])
    assert all(v.requires_grad for v in got.values())
    assert_losses_close(got, want)


def test_centernet_detector_inference(detector):
    jm, params, tm, images, sizes, _ = detector
    want = jax.jit(lambda p: jm.apply(p, jnp.asarray(images), jnp.asarray(sizes),
                                      training=False))(params)
    got = tm(t(images), t(sizes))
    assert got["boxes"].shape == (2, 16, 4) and got["classes"].shape == (2, 16)
    assert not any(v.requires_grad for v in got.values())
    compare_detections(got, want)
