"""The port's training forward against the JAX package's: targets, losses and
gradients on the same weights, inputs and random draws, float32 on the CPU.

The pieces first (``centernet_ground_truth``, ``centernet_losses``,
``match_proposals``, ``subsample_proposals``, ``_fast_rcnn_losses``), then the
modules with weights (``CascadeROIHeads._mask_loss`` and ``.losses``, and
``CustomRCNN(training=True)`` plain, with ``gt_as_proposals`` and with the
dynamic classifier). PyTorch cannot reproduce the bits of a ``jax.random``
key, so ``jax_draws`` evaluates the uniform arrays of the keys the JAX
functions derive and hands them to the port by name; everything after a draw
is deterministic.

Tolerances. Targets and picks (indices, masks, counts) are equal. A loss
agrees to 1e-4 relative. The gradient of the summed loss agrees, for every
parameter, to 2e-4 of the largest |reference gradient| of its leaf, with a
floor of 1e-6 of the largest |gradient| of the whole tree for leaves whose
own gradients are all rounding-sized. (All leaves but one meet 1e-4. The mask
head's transposed convolution differs by 1.5e-4 from the jitted JAX program,
while it agrees to 1e-6 with the same JAX function evaluated op by op and
with the port in float64: the spread is the jitted program's own, and
``test_mask_loss`` holds the port against the op-by-op evaluation.)
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.centernet import centernet as jcn
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.modeling.roi_heads import cascade_heads as jch
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.centernet import centernet as tcn
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.modeling.roi_heads import cascade_heads as tch
from divergen_tpu_torch.utils.convert import params_from_jax, tree_from_module
from test_torch_detector import LEVEL_SHAPES, ROI, TINY_SWIN, load, randomized, roi_inputs, shape_init, t, tiny_cfg

torch.set_num_threads(1)

CANVAS = (64, 64)


def jx(tree):
    return jax.tree.map(jnp.asarray, tree)


def tt(tree):
    return {k: t(np.asarray(v)) for k, v in tree.items()}


def jax_draws(key, batch, rows, fed_classes, dyn_classes=None, stages=3):
    """The uniform arrays that ``CascadeROIHeads.losses`` (and, with
    ``dyn_classes``, the dynamic classifier) draw from ``key``, under the
    names the port looks them up by. ``rows`` is the proposal count with the
    appended ground truth, ``fed_classes`` the classifier's column count."""
    uniform = lambda k, shape: np.asarray(jax.random.uniform(k, shape))
    k_match, k_fed = jax.random.split(jax.random.fold_in(key, 0))
    draws = {
        "match": np.stack([uniform(k, (rows,)) for k in jax.random.split(k_match, batch)]),
        "mask": np.stack([uniform(k, (rows,))
                          for k in jax.random.split(jax.random.fold_in(key, 17), batch)]),
    }
    for stage in range(stages):
        draws[f"fed{stage}"] = uniform(jax.random.fold_in(k_fed, stage), (fed_classes + 1,))
    if dyn_classes is not None:
        draws["dyn"] = uniform(jax.random.fold_in(key, 777), (dyn_classes,))
    return draws


def assert_losses_close(got, want, rtol=1e-4):
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(w), rtol=rtol, atol=1e-6,
                                   err_msg=k)


def assert_grads_close(module, params, want_grads, tol=2e-4):
    """Every parameter's gradient (module docstring for the bound); returns
    the number of leaves whose reference gradient is not all zero."""
    got = tree_from_module(module, params, grad=True)
    flat_want = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want_grads))
    flat_got = jax.tree_util.tree_leaves(got)
    assert len(flat_got) == len(flat_want) == len(list(module.parameters()))
    floor = 1e-6 * max(np.abs(w).max() for _, w in flat_want)
    live = 0
    for (path, w), g in zip(flat_want, flat_got):
        name = "/".join(str(p.key) for p in path)
        assert g.shape == w.shape, name
        err = np.abs(g - w).max()
        assert err <= max(tol * np.abs(w).max(), floor), (name, err, np.abs(w).max())
        live += bool(np.abs(w).max() > 0)
    return live


def assert_feature_grads_close(feats, want, tol=2e-4):
    """Gradients into the pyramid levels, to ``tol`` of the largest over the levels."""
    scale = max(np.abs(np.asarray(w)).max() for w in want.values())
    assert scale > 0
    for k, w in want.items():
        assert np.abs(feats[k].grad.numpy() - np.asarray(w)).max() <= tol * scale, k


def total_of(losses):
    return sum(v for k, v in losses.items() if not k.startswith("aux_"))


# -- CenterNet targets and losses ------------------------------------------------

def gt_boxes_case(case):
    rng = np.random.RandomState(3)
    n = 12
    xy = rng.rand(2, n, 2) * np.array([90.0, 60.0])
    wh = rng.rand(2, n, 2) * np.array([60.0, 50.0]) + 4
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    valid = rng.rand(2, n) > 0.3
    if case == "empty image":
        valid[1] = False
    elif case == "cell borders":
        # centres exactly on the borders of the stride-8, -16 and -32 cells, a box
        # that reaches outside the canvas, a zero-area box and two boxes in one cell
        boxes[0, :6] = [[8, 8, 24, 24], [0, 0, 32, 32], [32, 16, 96, 80], [-10, -6, 10, 6],
                        [40, 40, 40, 40], [9, 9, 23, 23]]
        valid[0, :6] = True
    return boxes, valid


@pytest.mark.parametrize("case", ["random", "empty image", "cell borders"])
def test_centernet_ground_truth(case):
    boxes, valid = gt_boxes_case(case)
    jcfg, tcfg = jcn.CenterNetConfig(), tcn.CenterNetConfig()
    want = jcn.centernet_ground_truth(jcfg, jcn.level_geometry(jcfg, LEVEL_SHAPES),
                                      jnp.asarray(boxes), jnp.asarray(valid))
    got = tcn.centernet_ground_truth(tcfg, tcn.level_geometry(tcfg, LEVEL_SHAPES), t(boxes),
                                     t(valid))
    m = sum(h * w for h, w in LEVEL_SHAPES)
    assert [tuple(g.shape) for g in got] == [(2, m, 4), (2, m), (2, m)]
    assert got[2].dtype == torch.int32
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    if case == "empty image":
        assert got[2][1].sum() == 0 and got[1][1].max() == 0 and (got[0][1] < 0).all()
    if case == "cell borders":
        assert got[2][0].max() >= 2  # two centres in one cell count twice
    assert got[2].sum() > 0 and (got[0].amax(dim=-1) >= 0).any()


@pytest.mark.parametrize("loc_loss_type", ["giou", "iou"])
def test_centernet_losses(loc_loss_type):
    boxes, valid = gt_boxes_case("cell borders")
    kw = dict(loc_loss_type=loc_loss_type)
    jcfg, tcfg = jcn.CenterNetConfig(**kw), tcn.CenterNetConfig(**kw)
    targets = jcn.centernet_ground_truth(jcfg, jcn.level_geometry(jcfg, LEVEL_SHAPES),
                                         jnp.asarray(boxes), jnp.asarray(valid))
    rng = np.random.RandomState(4)
    m = targets[1].shape[1]
    agn = (rng.randn(2, m) * 2 - 2).astype(np.float32)
    reg = (rng.rand(2, m, 4) * 4).astype(np.float32)
    jloss = lambda a, r: jcn.centernet_losses(jcfg, a, r, *targets)
    want = jloss(jnp.asarray(agn), jnp.asarray(reg))
    want_g = jax.grad(lambda a, r: total_of(jloss(a, r)), argnums=(0, 1))(jnp.asarray(agn),
                                                                         jnp.asarray(reg))
    ta, tr = t(agn).requires_grad_(True), t(reg).requires_grad_(True)
    got = tcn.centernet_losses(tcfg, ta, tr, *(t(np.asarray(x)) for x in targets))
    assert list(got) == ["loss_centernet_loc", "loss_centernet_agn_pos", "loss_centernet_agn_neg"]
    assert_losses_close(got, want)
    total_of(got).backward()
    for g, w in zip((ta.grad, tr.grad), want_g):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4 * np.abs(np.asarray(w)).max()
    # NOT_NORM_REG false (the heatmap-weighted regression) is ported; the JAX
    # function's max over the last axis of the (B, M) heatmap runs at B = 1,
    # and the port raises at other B
    kw["not_norm_reg"] = False
    one = [np.asarray(x)[:1] for x in targets]
    want = jcn.centernet_losses(jcn.CenterNetConfig(**kw), jnp.asarray(agn[:1]),
                                jnp.asarray(reg[:1]), *(jnp.asarray(x) for x in one))
    got = tcn.centernet_losses(tcn.CenterNetConfig(**kw), t(agn[:1]), t(reg[:1]),
                               *(t(x) for x in one))
    assert_losses_close(got, want)
    with pytest.raises(ValueError, match="only at B = 1"):
        tcn.centernet_losses(tcn.CenterNetConfig(**kw), ta, tr,
                             *(t(np.asarray(x)) for x in targets))


# -- matching and sampling ---------------------------------------------------------

def proposal_case(seed, p=40, n=6):
    rng = np.random.RandomState(seed)
    xy = rng.rand(n, 2) * 80
    gt = np.concatenate([xy, xy + rng.rand(n, 2) * 40 + 8], -1).astype(np.float32)
    gt_valid = np.arange(n) < n - 2
    jitter = rng.randn(p, 4) * np.where(rng.rand(p, 1) < 0.5, 3.0, 30.0)
    props = (gt[rng.randint(0, n, p)] + jitter).astype(np.float32)
    props[:, 2:] = np.maximum(props[:, 2:], props[:, :2] + 1)
    return props, gt, gt_valid, rng.rand(p) > 0.15


@pytest.mark.parametrize("thresh", [0.5, 0.7])
def test_match_proposals(thresh):
    props, gt, gt_valid, _ = proposal_case(5)
    want = jch.match_proposals(jnp.asarray(props), jnp.asarray(gt), jnp.asarray(gt_valid), thresh)
    got = tch.match_proposals(t(props), t(gt), t(gt_valid), thresh)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    assert got[1].any() and not got[1].all() and got[0].max() < 4  # invalid rows never match
    none = tch.match_proposals(t(props), t(gt), torch.zeros(6, dtype=torch.bool), thresh)
    assert not none[1].any()


@pytest.mark.parametrize("num_samples,fraction", [(16, 0.25), (32, 0.5), (64, 0.25)],
                         ids=["budget16", "budget32", "more than candidates"])
def test_subsample_proposals_with_the_jax_draw(num_samples, fraction):
    props, gt, gt_valid, valid = proposal_case(6)
    _, fg = jch.match_proposals(jnp.asarray(props), jnp.asarray(gt), jnp.asarray(gt_valid), 0.5)
    fg = np.asarray(fg) & valid
    key = jax.random.PRNGKey(9)
    want_idx, want_ok = jch.subsample_proposals(key, jnp.asarray(fg), jnp.asarray(valid),
                                                num_samples, fraction)
    r = np.asarray(jax.random.uniform(key, (40,)))
    got_idx, got_ok = tch.subsample_proposals(t(r), t(fg), t(valid), num_samples, fraction)
    ok = np.asarray(want_ok)
    np.testing.assert_array_equal(got_ok.numpy(), ok)
    # rows that are not ok hold priority -inf and may come back in any order
    np.testing.assert_array_equal(got_idx.numpy()[ok], np.asarray(want_idx)[ok])
    picked_fg = fg[got_idx.numpy()[ok]].sum()
    assert picked_fg == min(fg.sum(), int(min(num_samples, 40) * fraction)) and picked_fg > 0
    assert valid[got_idx.numpy()[ok]].all()


# -- the box head's losses -----------------------------------------------------------

def fast_rcnn_case(seed, b=2, p=24, c=8):
    rng = np.random.RandomState(seed)
    scores = (rng.randn(b, p, c + 1) * 2).astype(np.float32)
    deltas = (rng.randn(b, p, 4) * 0.3).astype(np.float32)
    xy = rng.rand(b, p, 2) * 80
    pb = np.concatenate([xy, xy + rng.rand(b, p, 2) * 40 + 6], -1).astype(np.float32)
    gb = (pb + rng.randn(b, p, 4) * 4).astype(np.float32)
    classes = np.where(rng.rand(b, p) < 0.4, rng.randint(0, c, (b, p)), c).astype(np.int32)
    valid = rng.rand(b, p) > 0.2
    src = np.where((classes < c) & (rng.rand(b, p) < 0.5), rng.randint(1, 5, (b, p)), 0).astype(np.int32)
    fed = (rng.rand(c) * 20 + 1).astype(np.float32) ** 0.5
    return scores, deltas, pb, gb, classes, valid, src, fed


@pytest.mark.parametrize("name,cfg_kw,with_fed,with_src", [
    ("fed loss", dict(), True, True),
    ("no fed weight", dict(), False, True),
    ("fed loss off", dict(use_fed_loss=False), True, False),
    ("paste split and rows", dict(split_paste_loss=True, per_paste_loss=True), True, True),
    ("giou, pasted boxes left out", dict(box_reg_loss_type="giou", divergen_box_loss=False), True,
     True),
], ids=lambda v: v if isinstance(v, str) else None)
def test_fast_rcnn_losses(name, cfg_kw, with_fed, with_src):
    scores, deltas, pb, gb, classes, valid, src, fed = fast_rcnn_case(7)
    kw = dict(ROI, fed_loss_num_cat=4, **cfg_kw)
    jc, tc = jch.ROIHeadsConfig(**kw), tch.ROIHeadsConfig(**kw)
    key = jax.random.PRNGKey(3)
    weights = (10.0, 10.0, 5.0, 5.0)
    jfed = jnp.asarray(fed) if with_fed else None
    jsrc = jnp.asarray(src) if with_src else None

    def jloss(s, d):
        return jch._fast_rcnn_losses(jc, key, s, d, jnp.asarray(pb), jnp.asarray(classes),
                                     jnp.asarray(gb), jnp.asarray(valid), jsrc, weights, jfed)

    want = jloss(jnp.asarray(scores), jnp.asarray(deltas))
    want_g = jax.grad(lambda s, d: total_of(jloss(s, d)), argnums=(0, 1))(
        jnp.asarray(scores), jnp.asarray(deltas))
    draws = {"fedX": np.asarray(jax.random.uniform(key, (9,)))}
    ts, td = t(scores).requires_grad_(True), t(deltas).requires_grad_(True)
    got = tch._fast_rcnn_losses(tc, draws, "fedX", ts, td, t(pb), t(classes).long(), t(gb),
                                t(valid), t(src).long() if with_src else None, weights,
                                t(fed) if with_fed else None)
    assert list(got) == list(want)
    for k in want:
        if "max_class" in k or "row_id" in k:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
        else:
            np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]), rtol=1e-4,
                                       atol=1e-6, err_msg=k)
    total_of(got).backward()
    for g, w in zip((ts.grad, td.grad), want_g):
        assert np.abs(g.numpy() - np.asarray(w)).max() <= 1e-4 * np.abs(np.asarray(w)).max()
    if name == "paste split and rows":
        assert got["aux_paste_row_id"].max() > 0 and got["loss_paste_ins"] > 0
        np.testing.assert_allclose(
            (got["loss_paste_ins"] + got["loss_nopaste_ins"]).item(), got["loss_cls"].item(), rtol=1e-5)


# -- the cascade heads with weights ----------------------------------------------------

def roi_gt(seed, props, n=6, c=8):
    """Ground truth of which half sits on proposals, so that every stage has
    foreground rows; two instances per image are pasted ones."""
    rng = np.random.RandomState(seed)
    boxes = props["boxes"][:, :n] + rng.randn(2, n, 4).astype(np.float32) * 2
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 4)
    src = np.zeros((2, n), np.int32)
    src[:, :2] = [[1, 2], [3, 4]]
    return {"boxes": boxes.astype(np.float32), "classes": rng.randint(0, c, (2, n)).astype(np.int32),
            "valid": np.arange(n)[None] < np.array([[n - 1], [n - 3]]),
            "masks": (rng.rand(2, n, 28, 28) > 0.4).astype(np.float32), "instance_source": src}


def torch_gt(gt):
    out = tt(gt)
    out["classes"], out["instance_source"] = out["classes"].long(), out["instance_source"].long()
    return out


@pytest.fixture(scope="module")
def roi_case():
    rng = np.random.RandomState(12)
    feats, props, sizes = roi_inputs(13)
    gt = roi_gt(14, props)
    kw = dict(ROI, fed_loss_num_cat=4, batch_size_per_image=16, mask_fg_capacity=8)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**kw))
    fed = (rng.rand(8) * 20 + 1).astype(np.float32) ** 0.5
    key = jax.random.PRNGKey(21)
    jargs = (key, jx(feats), jx(props), jx(gt))
    params = randomized(shape_init(jm, *jargs, fed_weight=jnp.asarray(fed),
                                   image_sizes=jnp.asarray(sizes), method=jm.losses), rng)
    tm = load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**kw), 16), params).train()
    return jm, params, tm, feats, props, sizes, gt, fed, key


def test_mask_loss(roi_case):
    jm, params, tm, feats, props, _, gt, _, key = roi_case
    # evaluated op by op: the jitted program's own gradients differ from this by 8e-4
    jfn = jax.value_and_grad(
        lambda p, f: jm.apply(p, key, f, jx(gt), jx(props), method=jm._mask_loss), argnums=(0, 1))
    want, (want_g, want_gf) = jfn(params, jx(feats))
    draws = {"mask": np.stack([np.asarray(jax.random.uniform(k, (30,)))
                               for k in jax.random.split(key, 2)])}
    tf = {k: t(v).requires_grad_(True) for k, v in feats.items()}
    tm.zero_grad()
    got = tm._mask_loss(draws, tf, torch_gt(gt), tt(props))
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    got.backward()
    only_mask = {"params": {"mask_head": want_g["params"]["mask_head"]}}
    assert assert_grads_close(tm.mask_head, only_mask["params"]["mask_head"],
                              only_mask["params"]["mask_head"]) == 12
    assert_feature_grads_close(tf, want_gf)  # the gradient into the pyramid, through ROIAlign


@pytest.mark.parametrize("variant", ["fed loss", "no fed weight, proposals only"])
def test_cascade_losses(roi_case, variant):
    jm, params, tm, feats, props, sizes, gt, fed, key = roi_case
    kw = {}
    if variant != "fed loss":
        fed = None
        kw = dict(add_gt_to_proposals=False)
        cfg = dict(ROI, fed_loss_num_cat=4, batch_size_per_image=16, mask_fg_capacity=8, **kw)
        jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**cfg))
        tm = load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**cfg), 16), params).train()
    jfed = None if fed is None else jnp.asarray(fed)

    def jloss(p, f):
        losses = jm.apply(p, key, f, jx(props), jx(gt), fed_weight=jfed,
                          image_sizes=jnp.asarray(sizes), method=jm.losses)
        return total_of(losses), losses

    (_, want), (want_g, want_gf) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))(
        params, jx(feats))
    draws = jax_draws(key, 2, 30, 8)
    if kw:  # without the appended ground truth the sampler draws for the 24 proposals only
        draws["match"] = jax_draws(key, 2, 24, 8)["match"]
    tf = {k: t(v).requires_grad_(True) for k, v in feats.items()}
    tm.zero_grad()
    got = tm.losses(draws, tf, tt(props), torch_gt(gt), fed_weight=None if fed is None else t(fed),
                    image_sizes=t(sizes))
    assert list(got) == [f"loss_{kind}_stage{s}" for s in range(3) for kind in ("cls", "box_reg")] + [
        "loss_mask"]
    assert_losses_close(got, want)
    assert all(float(v) > 0 for v in got.values()) or kw  # proposals alone may miss stage 2's IoU
    total_of(got).backward()
    # with the appended ground truth every stage has foreground rows and every leaf moves
    moved = sum(bool(p.grad is not None and p.grad.abs().max() > 0) for p in tm.parameters())
    assert assert_grads_close(tm, params, want_g) == moved >= len(list(tm.parameters())) - (2 if kw else 0)
    assert_feature_grads_close(tf, want_gf)  # scaled by 1 / 3 per stage on its way in


def test_scale_gradient_and_what_is_not_yet_ported(roi_case):
    x = torch.arange(6.0).reshape(2, 3).requires_grad_(True)
    y = tch._scale_gradient(x, 0.25)
    assert torch.equal(y, x)
    (y * torch.arange(6.0).reshape(2, 3)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.arange(6.0).reshape(2, 3) * 0.25)
    # image_label_losses is ported (tests/test_torch_weak_supervision.py)
    _, _, tm, feats, props, sizes, _, _, _ = roi_case
    weak = tm.image_label_losses(tt(feats), tt(props), t(sizes), torch.tensor([[0, 3]] * 2),
                                 torch.ones(2, 2, dtype=torch.bool))
    assert all(torch.isfinite(v) for v in weak.values()) and weak["image_loss_stage0"] > 0


# -- the detector's training forward ---------------------------------------------------

def train_cfg(get_small, **keys):
    cfg = tiny_cfg(get_small)
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.CENTERNET.PRE_NMS_TOPK_TRAIN = 32
    cfg.MODEL.CENTERNET.POST_NMS_TOPK_TRAIN = 16
    cfg.MODEL.ROI_BOX_HEAD.FED_LOSS_NUM_CAT = 4
    cfg.merge_from_list([x for kv in keys.items() for x in kv])
    return cfg


def detector_batch(seed):
    rng = np.random.RandomState(seed)
    images = (rng.rand(2, *CANVAS, 3) * 255).astype(np.float32)
    sizes = np.array([[64, 64], [56, 48]], np.int32)
    images[1, 56:] = 0.0
    images[1, :, 48:] = 0.0
    jentry = importlib.import_module("__graft_entry__")
    gt = jax.tree.map(np.array, jentry._synth_gt(rng, 2, 8, 8, img=64))
    gt["instance_source"][:, 1] = [1, 2]
    fed = (rng.rand(8) * 20 + 1).astype(np.float32) ** 0.5
    return images, sizes, gt, fed


@pytest.fixture(scope="module")
def tiny_swin():
    mp = pytest.MonkeyPatch()
    mp.setitem(jswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    yield importlib.import_module("__graft_entry__")
    mp.undo()


VARIANTS = {
    "box branch": (dict(), dict()),
    "gt as proposals": (dict(), dict(gt_as_proposals=True)),
    "dynamic classifier": ({"MODEL.DYNAMIC_CLASSIFIER": True, "MODEL.NUM_SAMPLE_CATS": 5,
                            "MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS": True,
                            "MODEL.ROI_BOX_HEAD.NORM_TEMP": 5.0,
                            "MODEL.DATASET_LOSS_WEIGHT": [1.0, 0.5]}, dict(dataset_source=1)),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_custom_rcnn_training_losses_and_gradients(tiny_swin, variant):
    keys, call_kw = VARIANTS[variant]
    images, sizes, gt, fed = detector_batch(31)
    rng = np.random.RandomState(32)
    key = jax.random.PRNGKey(5)
    jm = jrcnn.build_model(train_cfg(lambda: tiny_swin._small_cfg(backbone="swin"), **keys))
    jkw = dict(gt=jx(gt), rng=key, fed_weight=jnp.asarray(fed), training=True, **call_kw)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), **jkw), rng)

    def jloss(p):
        losses = jm.apply(p, jnp.asarray(images), jnp.asarray(sizes), **jkw)
        return total_of(losses), losses

    (_, want), want_g = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)

    tm = trcnn.build_model(train_cfg(lambda: tge._small_cfg(backbone="swin"), **keys), input_size=CANVAS)
    tm.load_state_dict(params_from_jax(params, tm), strict=variant != "gt as proposals")
    tm.train()
    classes = 5 if variant == "dynamic classifier" else 8
    rows = 16 if variant == "gt as proposals" else 24
    draws = jax_draws(key, 2, rows, classes, dyn_classes=8)
    got = tm(t(images), t(sizes), gt=torch_gt(gt), rng=draws, fed_weight=t(fed), training=True,
             **call_kw)
    assert ("loss_centernet_loc" in got) == (variant != "gt as proposals")
    assert_losses_close(got, want)
    total_of(got).backward()
    live = assert_grads_close(tm, params, want_g) if variant != "gt as proposals" else None
    if variant == "gt as proposals":
        # flax makes no CenterNet head on this path; the port's gets no gradient
        assert all(p.grad is None for p in tm.centernet_head.parameters())
        named = dict(tm.named_parameters())
        for name in [n for n in named if n.startswith("centernet_head.")]:
            del named[name]
        got_g = tree_from_module(tm, params, grad=True)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want_g)),
                                jax.tree_util.tree_leaves(got_g)):
            assert np.abs(g - w).max() <= max(1e-4 * np.abs(w).max(), 1e-9), path
    else:
        # the same leaves are left without a gradient on both sides: the unused s2
        # norm, and p6 / p7 with their scales, where this small canvas has no target
        moved = sum(bool(p.grad is not None and p.grad.abs().max() > 0) for p in tm.parameters())
        assert live == moved >= len(list(tm.parameters())) - 13


def test_training_forward_refuses_what_is_not_ported(tiny_swin):
    images, sizes, gt, fed = detector_batch(33)
    tm = trcnn.build_model(train_cfg(lambda: tge._small_cfg(backbone="swin")), input_size=CANVAS)
    gen = torch.Generator().manual_seed(0)
    # weak supervision is ported; a reduction over ranks is not
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        tm(t(images), t(sizes), gt=torch_gt(gt), rng=gen, training=True, axis_name="data")
    with pytest.raises(ValueError, match="gt and rng"):
        tm(t(images), t(sizes), training=True)
    with pytest.raises(ValueError, match="training=False"):
        tm(t(images), t(sizes), gt=torch_gt(gt))
    # a generator instead of named draws: finite losses, and the same again from the same seed
    a = tm(t(images), t(sizes), gt=torch_gt(gt), rng=gen, fed_weight=t(fed), training=True)
    b = tm(t(images), t(sizes), gt=torch_gt(gt), rng=torch.Generator().manual_seed(0),
           fed_weight=t(fed), training=True)
    assert all(torch.isfinite(v) for v in a.values())
    assert all(torch.equal(a[k], b[k]) for k in a)
