"""The port's weak supervision against the JAX package's, float32 on the CPU:
``_weak_image_loss`` for every strategy, ``CascadeROIHeads`` and
``Res5ROIHeads.image_label_losses`` with weights (image labels, WSDDN,
captions, the dynamic classifier's columns), and ``CustomRCNN`` trained on an
image-labelled or captioned batch (``ann_type``, ``cap_emb``, the dynamic
classifier over image labels with the JAX ``"dyn"`` draw,
``DATASET_LOSS_WEIGHT``).

Weights as ``test_torch_detector.py`` makes them; each JAX tree comes from
the box branch's ``init``, which makes every parameter (the weak branch
leaves the mask head untouched). Tolerances as in
``test_torch_train_losses.py``: a loss within 1e-4 relative, each
parameter's gradient within 2e-4 of its leaf's largest |reference gradient|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.modeling.roi_heads import cascade_heads as jch
from divergen_tpu.modeling.roi_heads import res5_roi_heads as jr5
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.modeling.roi_heads import cascade_heads as tch
from divergen_tpu_torch.modeling.roi_heads import res5_roi_heads as tr5
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_detector import ROI, load, randomized, roi_inputs, shape_init, t
from test_torch_train_losses import (CANVAS, assert_feature_grads_close, assert_grads_close,
                                     assert_losses_close, detector_batch, jax_draws, jx,
                                     roi_gt, tiny_swin, torch_gt, total_of, train_cfg, tt)

torch.set_num_threads(1)

__all__ = ["tiny_swin"]  # the fixture, imported for the detector cases


def grads_close(got, want, tol=1e-4):
    scale = np.abs(np.asarray(want)).max()
    assert scale > 0
    assert np.abs(got.numpy() - np.asarray(want)).max() <= tol * scale


# -- the loss of one stage --------------------------------------------------------------

def weak_case(seed, b=2, p=10, c1=9, labels=4):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(b, p, c1) * 2).astype(np.float32)
    prop = (rng.randn(b, p, c1) * 2).astype(np.float32)
    xy = rng.rand(b, p, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(b, p, 2) * 40 + 2], -1).astype(np.float32)
    valid = rng.rand(b, p) > 0.25
    valid[:, -1] = True  # the image box
    lab = rng.randint(0, c1 - 1, (b, labels)).astype(np.int32)
    lv = np.array([[True, True, False, True], [True, False, False, False]])
    lab[1, 2] = -1  # a padded label
    return scores, prop, boxes, valid, lab, lv


STRATEGIES = [("max_size", {}), ("max_score", {}), ("first", {}), ("image", {}),
              ("min_loss", {}), ("wsddn", {}), ("wsod", {}),
              ("max_score", {"softmax_weak_loss": True}), ("min_loss", {"softmax_weak_loss": True})]


@pytest.mark.parametrize("kind,extra", STRATEGIES,
                         ids=[k + ("+softmax" if e else "") for k, e in STRATEGIES])
@pytest.mark.parametrize("with_prop", [False, True], ids=["class scores", "proposal scores"])
def test_weak_image_loss(kind, extra, with_prop):
    scores, prop, boxes, valid, lab, lv = weak_case(40)
    kw = dict(image_label_loss=kind, **extra)
    jc, tc = jch.ROIHeadsConfig(**kw), tch.ROIHeadsConfig(**kw)

    def jloss(s, ps):
        return jch._weak_image_loss(jc, s, ps if with_prop else None, jnp.asarray(boxes),
                                    jnp.asarray(valid), jnp.asarray(lab), jnp.asarray(lv))

    want, want_g = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(scores), jnp.asarray(prop))
    ts, tp = t(scores).requires_grad_(True), t(prop).requires_grad_(True)
    got = tch._weak_image_loss(tc, ts, tp if with_prop else None, t(boxes), t(valid),
                               t(lab), t(lv))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    assert float(want) > 0
    got.backward()
    grads_close(ts.grad, want_g[0])
    if with_prop and kind in ("wsddn", "wsod"):
        grads_close(tp.grad, want_g[1])
    else:  # the proposal scores are read by WSDDN alone
        assert tp.grad is None or not tp.grad.any()


def test_max_size_leaves_out_the_last_proposal():
    # the largest box sits last and no image box is appended: the JAX module
    # (and so the port) still supervises the second largest
    _, _, boxes, valid, lab, lv = weak_case(41)
    scores = np.zeros((2, 10, 9), np.float32)
    boxes[:, -1] = [0, 0, 500, 500]
    boxes[:, 3] = [0, 0, 400, 400]
    valid[:] = True
    scores[:, 3] = 5.0
    tc = tch.ROIHeadsConfig(image_label_loss="max_size")
    got = tch._weak_image_loss(tc, t(scores), None, t(boxes), t(valid), t(lab), t(lv))
    want = jch._weak_image_loss(jch.ROIHeadsConfig(image_label_loss="max_size"),
                                jnp.asarray(scores), None, jnp.asarray(boxes),
                                jnp.asarray(valid), jnp.asarray(lab), jnp.asarray(lv))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    row3 = tch._weak_image_loss(tch.ROIHeadsConfig(image_label_loss="first"),
                                t(scores[:, 3:]), None, t(boxes[:, 3:]), t(valid[:, 3:]),
                                t(lab), t(lv))
    np.testing.assert_allclose(got.item(), row3.item(), rtol=1e-6)
    with pytest.raises(ValueError, match="unknown image_label_loss"):
        tch._weak_image_loss(tch.ROIHeadsConfig(image_label_loss="best"), t(scores), None,
                             t(boxes), t(valid), t(lab), t(lv))


def test_weak_proposals():
    _, props, sizes = roi_inputs(42)
    for f in (1.0, 0.5):
        kw = dict(ws_num_props=16, add_image_box=True, image_box_size=f)
        boxes, valid = tch.weak_proposals(tch.ROIHeadsConfig(**kw), tt(props), t(sizes))
        assert boxes.shape == (2, 17, 4) and valid[:, -1].all()
        np.testing.assert_array_equal(valid[:, :16].numpy(), props["valid"][:, :16])
        h, w = sizes[1]
        np.testing.assert_allclose(boxes[1, -1].numpy(),
                                   [w * (1 - f) / 2, h * (1 - f) / 2, w * (1 + f) / 2,
                                    h * (1 + f) / 2], rtol=1e-6)
        assert (boxes[..., 2] <= t(sizes)[:, None, 1]).all()


# -- the heads with weights --------------------------------------------------------------

WEAK = dict(ROI, fed_loss_num_cat=4, batch_size_per_image=16, mask_fg_capacity=8,
            ws_num_props=16, add_image_box=True, norm_temp=5.0)
CASCADE_CASES = {
    "max_size": (dict(image_label_loss="max_size"), "image", False, False),
    "max_score, no image box": (dict(image_label_loss="max_score", add_image_box=False),
                                "image", False, False),
    "min_loss": (dict(image_label_loss="min_loss"), "image", False, False),
    "wsddn": (dict(image_label_loss="wsddn", with_softmax_prop=True), "image", False, False),
    "caption": (dict(use_zeroshot_cls=True), "caption", True, False),
    "captiontag, sync_caption_batch": (dict(use_zeroshot_cls=True, sync_caption_batch=True,
                                            neg_cap_weight=0.25), "captiontag", True, False),
    "image, dynamic classifier columns": (dict(use_zeroshot_cls=True), "image", False, True),
}


def weak_labels(seed, b=2, classes=8):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, classes, (b, 3)).astype(np.int32)
    return labels, np.array([[True, True, False], [True, False, True]])


@pytest.mark.parametrize("case", list(CASCADE_CASES))
def test_cascade_image_label_losses(case):
    cfg_kw, ann_type, caption, dyn = CASCADE_CASES[case]
    rng = np.random.RandomState(43)
    feats, props, sizes = roi_inputs(44)
    gt = roi_gt(45, props)
    labels, lv = weak_labels(46)
    kw = dict(WEAK, **cfg_kw)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**kw))
    key = jax.random.PRNGKey(47)
    params = randomized(shape_init(jm, key, jx(feats), jx(props), jx(gt), method=jm.losses), rng)
    cap = (rng.randn(2, 512) * 0.1).astype(np.float32) if caption else None
    inds = np.array([6, 1, 3, 0, 5], np.int64) if dyn else None
    if dyn:  # the labels as the dynamic classifier remaps them into its 5 columns
        labels = np.array([[2, 0, 5], [4, 1, 3]], np.int32)
    extra = dict(ann_type=ann_type)

    def jloss(p, f):
        losses = jm.apply(p, f, jx(props), jnp.asarray(sizes), jnp.asarray(labels),
                          jnp.asarray(lv), cap_emb=None if cap is None else jnp.asarray(cap),
                          cap_idx=None if cap is None else jnp.arange(2),
                          cls_inds=None if inds is None else jnp.asarray(inds),
                          method=jm.image_label_losses, **extra)
        return total_of(losses), losses

    (_, want), (want_g, want_gf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(params, jx(feats))
    tm = load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**kw), 16), params).train()
    tf = {k: t(v).requires_grad_(True) for k, v in feats.items()}
    got = tm.image_label_losses(tf, tt(props), t(sizes), t(labels), t(lv),
                                cap_emb=None if cap is None else t(cap),
                                cap_idx=None if cap is None else torch.arange(2),
                                cls_inds=None if inds is None else t(inds), **extra)
    assert list(got) == [f"{k}_stage{s}" for s in range(3)
                         for k in ("image_loss", "loss_cls", "loss_box_reg")] + ["loss_mask"]
    assert_losses_close(got, want)
    assert all(float(got[f"image_loss_stage{s}"]) > 0 for s in range(3))
    assert all(float(v) == 0 for k, v in got.items() if not k.startswith("image_loss"))
    total_of(got).backward()
    assert_grads_close(tm, params, want_g)
    assert_feature_grads_close(tf, want_gf)
    assert all(p.grad is None or not p.grad.any() for p in tm.mask_head.parameters())


def test_caption_needs_the_zero_shot_classifier():
    feats, props, sizes = roi_inputs(48)
    tm = tch.CascadeROIHeads(tch.ROIHeadsConfig(**WEAK), 16)
    labels, lv = weak_labels(49)
    with pytest.raises(ValueError, match="USE_ZEROSHOT_CLS"):
        tm.image_label_losses(tt(feats), tt(props), t(sizes), t(labels), t(lv),
                              ann_type="caption", cap_emb=torch.randn(2, 512),
                              cap_idx=torch.arange(2))


RES5_WEAK = dict(WEAK, in_features=("p4",), strides=(16,))


@pytest.mark.parametrize("kind,softmax_prop", [("wsddn", True), ("max_size", False),
                                                ("wsddn", False)],
                         ids=["wsddn, proposal scores", "max_size", "wsddn, class scores"])
def test_res5_image_label_losses(kind, softmax_prop):
    rng = np.random.RandomState(50)
    feats, props, sizes = roi_inputs(51)
    gt = roi_gt(52, props)
    labels, lv = weak_labels(53)
    kw = dict(RES5_WEAK, image_label_loss=kind, with_softmax_prop=softmax_prop)
    jm = jr5.Res5ROIHeads(jch.ROIHeadsConfig(**kw), res5_channels=64)
    key = jax.random.PRNGKey(54)
    params = randomized(shape_init(jm, key, jx(feats), jx(props), jx(gt), method=jm.losses), rng)
    if softmax_prop:  # the proposal scores spread like the class scores
        pred = params["params"]["box_predictor"]
        pred["prop_score_out"]["kernel"] = (rng.randn(*pred["prop_score_out"]["kernel"].shape)
                                            * 0.1).astype(np.float32)

    def jloss(p, f):
        losses = jm.apply(p, f, jx(props), jnp.asarray(sizes), jnp.asarray(labels),
                          jnp.asarray(lv), method=jm.image_label_losses)
        return total_of(losses), losses

    (_, want), (want_g, want_gf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                              has_aux=True))(params, jx(feats))
    tm = load(tr5.Res5ROIHeads(tch.ROIHeadsConfig(**kw), 16, res5_channels=64), params).train()
    assert hasattr(tm.box_predictor, "prop_score_out") == softmax_prop
    tf = {k: t(v).requires_grad_(True) for k, v in feats.items()}
    got = tm.image_label_losses(tf, tt(props), t(sizes), t(labels), t(lv))
    assert sorted(got) == ["image_loss", "loss_box_reg", "loss_cls", "loss_mask"]
    assert_losses_close(got, want)
    assert float(got["image_loss"]) > 0
    total_of(got).backward()
    assert_grads_close(tm, params, want_g)
    assert_feature_grads_close(tf, {"p4": want_gf["p4"]})


# -- the detector's weak training forward -----------------------------------------------

DETECTOR_CASES = {
    "image, max_size, dataset loss weight": (
        {"MODEL.ROI_BOX_HEAD.ADD_IMAGE_BOX": True, "MODEL.ROI_BOX_HEAD.WS_NUM_PROPS": 8,
         "MODEL.DATASET_LOSS_WEIGHT": [1.0, 0.5]}, "image", False, dict(dataset_source=1)),
    "captiontag, zero-shot, sync_caption_batch": (
        {"MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS": True, "MODEL.ROI_BOX_HEAD.NORM_TEMP": 5.0,
         "MODEL.ROI_BOX_HEAD.IMAGE_LABEL_LOSS": "max_score", "MODEL.WITH_CAPTION": True,
         "MODEL.SYNC_CAPTION_BATCH": True, "MODEL.ROI_BOX_HEAD.ADD_IMAGE_BOX": True,
         "MODEL.ROI_BOX_HEAD.WS_NUM_PROPS": 8}, "captiontag", True, {}),
    "image, dynamic classifier": (
        {"MODEL.DYNAMIC_CLASSIFIER": True, "MODEL.NUM_SAMPLE_CATS": 5,
         "MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS": True, "MODEL.ROI_BOX_HEAD.NORM_TEMP": 5.0,
         "MODEL.ROI_BOX_HEAD.IMAGE_LABEL_LOSS": "wsddn",
         "MODEL.ROI_BOX_HEAD.WITH_SOFTMAX_PROP": True}, "image", False, {}),
}


@pytest.mark.parametrize("variant", list(DETECTOR_CASES))
def test_custom_rcnn_weak_losses_and_gradients(tiny_swin, variant):
    keys, ann_type, caption, call_kw = DETECTOR_CASES[variant]
    keys = dict(keys, WITH_IMAGE_LABELS=True)
    images, sizes, gt, fed = detector_batch(55)
    rng = np.random.RandomState(56)
    gt["image_labels"] = np.array([[3, 5, 0], [6, 6, 1]], np.int32)
    gt["image_labels_valid"] = np.array([[True, True, False], [True, False, True]])
    cap = (rng.randn(2, 512) * 0.1).astype(np.float32) if caption else None
    key = jax.random.PRNGKey(57)
    jm = jrcnn.build_model(train_cfg(lambda: tiny_swin._small_cfg(backbone="swin"), **keys))
    box_kw = dict(gt=jx(gt), rng=key, fed_weight=jnp.asarray(fed), training=True)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), **box_kw), rng)
    jkw = dict(box_kw, ann_type=ann_type, **call_kw)
    if cap is not None:
        jkw["cap_emb"] = jnp.asarray(cap)

    def jloss(p):
        losses = jm.apply(p, jnp.asarray(images), jnp.asarray(sizes), **jkw)
        return total_of(losses), losses

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    tm = trcnn.build_model(train_cfg(lambda: tge._small_cfg(backbone="swin"), **keys),
                           input_size=CANVAS)
    tm.load_state_dict(params_from_jax(params, tm))
    tm.train()
    draws = jax_draws(key, 2, 24, 8, dyn_classes=8)
    tgt = torch_gt(gt)
    tgt["image_labels"] = t(gt["image_labels"]).long()
    tgt["image_labels_valid"] = t(gt["image_labels_valid"])
    got = tm(t(images), t(sizes), gt=tgt, rng=draws, fed_weight=t(fed), training=True,
             ann_type=ann_type, cap_emb=None if cap is None else t(cap), **call_kw)
    assert_losses_close(got, want)
    # the CenterNet losses stay in the dict at zero; every ROI loss but the image loss is zero
    assert {k for k, v in got.items() if float(v) != 0} == {f"image_loss_stage{s}"
                                                             for s in range(3)}
    total_of(got).backward()
    assert_grads_close(tm, params, want_g)
    # no gradient reaches the CenterNet head or the mask head; the backbone's moves
    for part in (tm.centernet_head, tm.roi_heads.mask_head):
        assert all(p.grad is None or not p.grad.any() for p in part.parameters())
    assert any(p.grad is not None and p.grad.any() for p in tm.bottom_up.parameters())


def test_weak_forward_refuses_ranks(tiny_swin):
    images, sizes, gt, fed = detector_batch(58)
    tm = trcnn.build_model(train_cfg(lambda: tge._small_cfg(backbone="swin")), input_size=CANVAS)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        tm(t(images), t(sizes), gt=torch_gt(gt), rng=torch.Generator().manual_seed(0),
           training=True, ann_type="caption", cap_emb=torch.zeros(2, 512), axis_name="data")
