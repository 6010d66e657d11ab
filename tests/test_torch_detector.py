"""The port's detector modules and its whole inference forward against the
JAX package, same weights and inputs.

flax ``init`` makes the weights; the heads' output layers and the biases are
then re-drawn from a seeded numpy generator with larger spreads, because at
their initial values every location scores alike and top-k, NMS and the class
choice would be decided by rounding. ``params_from_jax`` carries the tree into
the port with ``strict=True``; numpy makes the inputs; both run in float32 on
the CPU. ``valid``, ``classes`` and ``prop_idx`` must be equal; boxes agree to
1e-2 px, scores to 1e-4, mask logits and feature maps to 1e-3 / 1e-4 of
max |reference|. Rows that are not valid are zeroed on both sides before they
are compared: they hold score -inf and may come back in any order. The seeds
were checked to put no pair of boxes on an NMS threshold.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import fpn as jfpn
from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.centernet import centernet as jcn
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.modeling.roi_heads import cascade_heads as jch
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling.backbone import fpn as tfpn
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.centernet import centernet as tcn
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.modeling.roi_heads import cascade_heads as tch
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# output layers whose kernels are re-drawn, with the std of the new values
SPREAD = {"agn_hm": 0.05, "bbox_pred": 0.02, "cls_score": 0.1, "predictor": 0.1,
          "zs_weight": 0.5}
KEPT_BIASES = ("agn_hm", "bbox_pred", "cls_score")  # the heads' prior biases stay


def assert_rel_close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1e-12), (err, np.abs(ref).max())


def randomized(params, rng):
    def walk(node, scope):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = walk(v, k)
            elif k == "relative_position_bias_table":
                out[k] = (rng.randn(*v.shape) * 0.5).astype(np.float32)
            elif k == "kernel" and scope in SPREAD or k in SPREAD:
                out[k] = (rng.randn(*v.shape) * SPREAD[scope if k == "kernel" else k]).astype(np.float32)
            elif k == "bias" and scope not in KEPT_BIASES and np.ndim(v) == 1:
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    return walk(jax.tree.map(np.asarray, params), "")


def shape_init(module, *args, **kwargs):
    """The tree flax ``init`` would make, traced for its shapes only (an eager
    init of the whole detector compiles hundreds of single operations), with
    norm scales at 1, the heads' prior biases, and fan-in scaled normal
    kernels; ``randomized`` re-draws the rest."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, **kwargs), jax.random.PRNGKey(0))
    rng = np.random.RandomState(11)
    prior = {"agn_hm": -4.59512, "cls_score": -4.59512, "bbox_pred": 8.0}

    def mk(path, s):
        names = [str(p.key) for p in path]
        leaf, scope = names[-1], names[-2] if len(names) > 1 else ""
        if leaf == "scale":
            return np.ones(s.shape, np.float32)
        if leaf == "bias":
            value = prior.get(scope, 0.0) if "centernet_head" in names or scope == "cls_score" else 0.0
            return np.full(s.shape, value, np.float32)
        if leaf == "bg_bias":
            return np.full(s.shape, -4.59512, np.float32)
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 1
        return (rng.randn(*s.shape) * (1.0 / max(fan_in, 1)) ** 0.5).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, shapes)


def load(module, params):
    module.load_state_dict(params_from_jax(params, module), strict=True)
    return module.eval()


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def masked(arr, valid):
    arr = np.asarray(arr)
    v = np.asarray(valid).reshape(valid.shape + (1,) * (arr.ndim - valid.ndim))
    return np.where(v, arr, np.zeros_like(arr))


def compare_detections(got, want, mask_tol=1e-3):
    got = {k: v.numpy() for k, v in got.items()}
    want = {k: np.asarray(v) for k, v in want.items()}
    assert set(got) == set(want)
    valid = want["valid"]
    np.testing.assert_array_equal(got["valid"], valid)
    assert valid.any()
    for k in ("classes", "prop_idx"):
        if k in want:
            np.testing.assert_array_equal(masked(got[k], valid), masked(want[k], valid))
    np.testing.assert_allclose(masked(got["boxes"], valid), masked(want["boxes"], valid), atol=1e-2)
    np.testing.assert_allclose(masked(got["scores"], valid), masked(want["scores"], valid), atol=1e-4)
    if "logits" in want:
        np.testing.assert_allclose(masked(got["logits"], valid), masked(want["logits"], valid),
                                   atol=1e-4)
    if "mask_logits" in want:
        assert_rel_close(masked(got["mask_logits"], valid), masked(want["mask_logits"], valid),
                         mask_tol)


def assert_same_parameters(jcfg, tcfg, size, training=False):
    """The port's ``state_dict`` has exactly the names and shapes that
    ``params_from_jax`` makes of the JAX detector's variable tree."""
    jm = jrcnn.build_model(jcfg)
    images = jnp.zeros((1, size, size, 3), jnp.float32)
    sizes = jnp.asarray([[size, size]])
    kw = dict(training=training)
    if training:
        jentry = importlib.import_module("__graft_entry__")
        kw.update(gt=jentry._synth_gt(np.random.RandomState(0), 1, 8, 8, img=size),
                  rng=jax.random.PRNGKey(0))
    tree = jax.eval_shape(lambda k: jm.init(k, images, sizes, **kw), jax.random.PRNGKey(0))
    tm = trcnn.build_model(tcfg, input_size=(size, size), device="meta")
    want = params_from_jax(jax.tree.map(lambda s: np.zeros(s.shape, np.float32), dict(tree)), tm)
    got = tm.state_dict()
    assert sorted(got) == sorted(want)
    assert all(tuple(got[k].shape) == tuple(want[k].shape) for k in want)
    return tm


# -- FPN -----------------------------------------------------------------------

def test_fpn():
    rng = np.random.RandomState(0)
    shapes = {"s3": (9, 12, 8), "s4": (5, 6, 16), "s5": (3, 3, 32)}  # odd: the top-down crop
    feats = {k: rng.randn(2, *s).astype(np.float32) for k, s in shapes.items()}
    jm = jfpn.FPN(in_features=("s3", "s4", "s5"), out_channels=16)
    params = randomized(jm.init(jax.random.PRNGKey(0), {k: jnp.asarray(v) for k, v in feats.items()}), rng)
    want = jm.apply(params, {k: jnp.asarray(v) for k, v in feats.items()})
    tm = load(tfpn.FPN(("s3", "s4", "s5"), (8, 16, 32), 16), params)
    with torch.no_grad():
        got = tm({k: t(v) for k, v in feats.items()})
    assert list(got) == list(want) == ["p3", "p4", "p5", "p6", "p7"]
    for k in want:
        assert_rel_close(got[k].numpy(), want[k], 1e-4)


# -- CenterNet head and proposals ---------------------------------------------

CN = dict(pre_nms_topk_test=48, post_nms_topk_test=24, nms_thresh_test=0.6, score_thresh=0.0001,
          pre_nms_total=150)
LEVEL_SHAPES = ((12, 16), (6, 8), (3, 4), (2, 2), (1, 1))


@pytest.fixture(scope="module")
def centernet_case():
    rng = np.random.RandomState(1)
    feats = [rng.randn(2, h, w, 32).astype(np.float32) for h, w in LEVEL_SHAPES]
    jcfg = jcn.CenterNetConfig(**CN)
    jm = jcn.CenterNetHead(jcfg)
    params = randomized(jm.init(jax.random.PRNGKey(0), [jnp.asarray(f) for f in feats]), rng)
    want = jm.apply(params, [jnp.asarray(f) for f in feats])
    tm = load(tcn.CenterNetHead(tcn.CenterNetConfig(**CN), 32), params)
    with torch.no_grad():
        got = tm([t(f) for f in feats])
    return jcfg, want, got


def test_centernet_head(centernet_case):
    _, want, got = centernet_case
    for l in range(len(LEVEL_SHAPES)):
        assert_rel_close(got[0][l].numpy(), want[0][l], 1e-4)
        assert_rel_close(got[1][l].numpy(), want[1][l], 1e-4)
        assert got[2][l] is None and want[2][l] is None
        assert (got[1][l] >= 0).all()


def test_centernet_config_and_geometry():
    from divergen_tpu.config import get_cfg as jget
    from divergen_tpu_torch.config import get_cfg as tget

    assert tcn.CenterNetConfig.from_cfg(tget()).__dict__ == jcn.CenterNetConfig.from_cfg(jget()).__dict__
    jgeom = jcn.level_geometry(jcn.CenterNetConfig(), LEVEL_SHAPES)
    tgeom = tcn.level_geometry(tcn.CenterNetConfig(), LEVEL_SHAPES)
    for k in ("grids", "strides", "size_ranges", "level_ids"):
        np.testing.assert_array_equal(tgeom[k].numpy(), np.asarray(jgeom[k]))
    assert tgeom["shapes"] == jgeom["shapes"]
    assert tgeom["grids"][0].tolist() == [4.0, 4.0]  # centres at s // 2


def test_centernet_proposals(centernet_case):
    jcfg, want_head, _ = centernet_case
    # the same head outputs go to both sides, so that this test holds the decoding alone
    agn = np.concatenate([np.asarray(a).reshape(2, -1) for a in want_head[0]], axis=1)
    reg = np.concatenate([np.asarray(r).reshape(2, -1, 4) for r in want_head[1]], axis=1)
    sizes = np.array([[96, 128], [80, 100]], np.int32)
    jgeom = jcn.level_geometry(jcfg, LEVEL_SHAPES)
    want = jcn.centernet_proposals(jcfg, jgeom, jnp.asarray(agn), jnp.asarray(reg),
                                   jnp.asarray(sizes), training=False)
    tcfg = tcn.CenterNetConfig(**CN)
    got = tcn.centernet_proposals(tcfg, tcn.level_geometry(tcfg, LEVEL_SHAPES), t(agn), t(reg),
                                  t(sizes), training=False)
    valid = np.asarray(want["valid"])
    assert got["boxes"].shape == (2, 24, 4)
    np.testing.assert_array_equal(got["valid"].numpy(), valid)
    assert valid.sum() >= 8
    np.testing.assert_allclose(masked(got["boxes"].numpy(), valid), masked(want["boxes"], valid),
                               atol=1e-3)
    np.testing.assert_allclose(masked(got["scores"].numpy(), valid), masked(want["scores"], valid),
                               atol=1e-5)


# -- cascade heads -------------------------------------------------------------

ROI = dict(num_classes=8, fc_dim=32, mask_conv_dim=16, detections_per_image=16,
           score_thresh_test=0.02)


def roi_inputs(seed):
    rng = np.random.RandomState(seed)
    feats = {f"p{3 + i}": rng.randn(2, 16 // 2 ** i, 20 // 2 ** i, 16).astype(np.float32)
             for i in range(3)}
    xy = rng.rand(2, 24, 2) * np.array([110.0, 90.0])
    wh = rng.rand(2, 24, 2) * 70 + 6
    props = {"boxes": np.concatenate([xy, xy + wh], -1).astype(np.float32),
             "scores": (rng.rand(2, 24) * 0.8 + 0.1).astype(np.float32),
             "valid": rng.rand(2, 24) > 0.2}
    sizes = np.array([[128, 160], [100, 150]], np.int32)
    return feats, props, sizes


@pytest.mark.parametrize("zeroshot", [False, True], ids=["linear", "zeroshot"])
def test_cascade_inference(zeroshot):
    rng = np.random.RandomState(2)
    feats, props, sizes = roi_inputs(3)
    kw = dict(ROI, use_zeroshot_cls=zeroshot, norm_temp=5.0)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**kw))
    jargs = ({k: jnp.asarray(v) for k, v in feats.items()},
             {k: jnp.asarray(v) for k, v in props.items()}, jnp.asarray(sizes))
    params = randomized(shape_init(jm, *jargs, method=jm.inference), rng)
    want = jax.jit(lambda p, *a: jm.apply(p, *a, return_logits=True, method=jm.inference))(
        params, *jargs)
    tm = load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**kw), 16), params)
    with torch.no_grad():
        got = tm.inference({k: t(v) for k, v in feats.items()},
                           {k: t(v) for k, v in props.items()}, t(sizes), return_logits=True)
    assert got["mask_logits"].shape == (2, 16, 28, 28) and got["logits"].shape == (2, 16, 8)
    compare_detections(got, want)
    assert len(np.unique(masked(want["classes"], np.asarray(want["valid"])))) > 2


def test_run_stage():
    rng = np.random.RandomState(4)
    feats, props, _ = roi_inputs(5)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**ROI))
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    run = lambda m, f, b: m._run_stage(f, b, 1)
    params = randomized(jm.init(jax.random.PRNGKey(0), jf, jnp.asarray(props["boxes"]), method=run), rng)
    ws, wd, _ = jm.apply(params, jf, jnp.asarray(props["boxes"]), method=run)
    tm = tch.CascadeROIHeads(tch.ROIHeadsConfig(**ROI), 16)
    sd = params_from_jax(params, None)
    missing = tm.load_state_dict(sd, strict=False)
    assert not missing.unexpected_keys and all(k.split(".")[0] not in ("box_head1", "box_predictor1")
                                               for k in missing.missing_keys)
    with torch.no_grad():
        gs, gd = tm._run_stage({k: t(v) for k, v in feats.items()}, t(props["boxes"]), 1)
    assert gs.shape == (2, 24, 9) and gd.shape == (2, 24, 4)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), atol=1e-4)
    np.testing.assert_allclose(gd.numpy(), np.asarray(wd), atol=1e-4)


def test_roi_heads_config_and_not_yet_ported():
    from divergen_tpu.config import get_cfg as jget
    from divergen_tpu_torch.config import get_cfg as tget

    assert tch.ROIHeadsConfig.from_cfg(tget()).__dict__ == jch.ROIHeadsConfig.from_cfg(jget()).__dict__
    # RefineMaskHead is ported: the heads' parameters are the JAX tree's
    feats, props, sizes = roi_inputs(3)
    kw = dict(ROI, mask_head_name="RefineMaskHead", mask_conv_dim=32)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**kw))
    tree = jax.eval_shape(lambda k: jm.init(k, *(jax.tree.map(jnp.asarray, a) for a in (
        feats, props, sizes)), method=jm.inference), jax.random.PRNGKey(0))
    refine = tch.CascadeROIHeads(tch.ROIHeadsConfig(**kw), 16, device="meta")
    want = params_from_jax(jax.tree.map(lambda x: np.zeros(x.shape, np.float32), dict(tree)),
                           refine)
    assert sorted(refine.state_dict()) == sorted(want)
    assert {k.split(".")[0] for k in want} >= {"mask_head", "semantic_branch"}
    heads = tch.CascadeROIHeads(tch.ROIHeadsConfig(**ROI), 16)
    # ``image_label_losses`` is ported (tests/test_torch_weak_supervision.py): the JAX
    # package's key set, finite
    weak = heads.image_label_losses({k: t(v) for k, v in feats.items()},
                                    {k: t(v) for k, v in props.items()}, t(sizes),
                                    torch.tensor([[1, 2]] * 2), torch.ones(2, 2, dtype=torch.bool))
    assert list(weak) == [f"{k}_stage{s}" for s in range(3)
                          for k in ("image_loss", "loss_cls", "loss_box_reg")] + ["loss_mask"]
    assert all(torch.isfinite(v) for v in weak.values())
    # ``losses`` is ported: the loss dict of the JAX package, finite
    gt = {"boxes": t(props["boxes"][:, :4]), "classes": torch.tensor([[0, 1, 2, 3]] * 2),
          "valid": torch.ones(2, 4, dtype=torch.bool), "masks": torch.ones(2, 4, 28, 28)}
    losses = heads.losses(torch.Generator().manual_seed(0), {k: t(v) for k, v in feats.items()},
                          {k: t(v) for k, v in props.items()}, gt, image_sizes=t(sizes))
    assert list(losses) == [f"loss_{kind}_stage{s}" for s in range(3)
                            for kind in ("cls", "box_reg")] + ["loss_mask"]
    assert all(torch.isfinite(v) and v.requires_grad for v in losses.values())


# -- the slice as a whole ---------------------------------------------------------

TINY_SWIN = (16, (1, 1, 2, 1), (1, 2, 4, 8), 4, 0.0)
CANVAS = (96, 128)


def tiny_cfg(get_small):
    cfg = get_small()
    cfg.MODEL.SWIN.SIZE = "tiny"
    cfg.MODEL.FPN.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 16
    return cfg


@pytest.fixture(scope="module")
def detector_case():
    mp = pytest.MonkeyPatch()
    mp.setitem(jswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    try:
        jentry = importlib.import_module("__graft_entry__")
        rng = np.random.RandomState(7)
        images = (rng.rand(2, *CANVAS, 3) * 255).astype(np.float32)
        sizes = np.array([[96, 128], [80, 100]], np.int32)
        images[1, 80:] = 0.0
        images[1, :, 100:] = 0.0
        jm = jrcnn.build_model(tiny_cfg(lambda: jentry._small_cfg(backbone="swin")))
        params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes),
                                       training=False), rng)
        want = jax.jit(lambda p, a, s: jm.apply(p, a, s, training=False, return_logits=True))(
            params, jnp.asarray(images), jnp.asarray(sizes))
        tm = load(trcnn.build_model(tiny_cfg(lambda: tge._small_cfg(backbone="swin")), input_size=CANVAS), params)
        yield jm, params, jax.tree.map(np.asarray, want), tm, images, sizes
    finally:
        mp.undo()


def test_custom_rcnn_inference(detector_case):
    _, _, want, tm, images, sizes = detector_case
    got = tm(t(images), t(sizes), return_logits=True)
    assert got["boxes"].shape == (2, 16, 4) and got["mask_logits"].shape == (2, 16, 28, 28)
    compare_detections(got, want)
    assert all(not v.requires_grad for v in got.values())


def test_custom_rcnn_pyramid(detector_case):
    jm, params, _, tm, images, _ = detector_case
    want = jm.apply(params, jnp.asarray(images), method=jm._features)
    with torch.no_grad():
        got = tm.backbone_features(t(images))
    assert list(got) == ["p3", "p4", "p5", "p6", "p7"]
    for k in got:
        assert_rel_close(got[k].numpy(), want[k], 1e-4)


def test_custom_rcnn_not_yet_ported(detector_case):
    _, _, _, tm, images, sizes = detector_case
    # the training forward is ported for box and weak supervision; reductions over
    # ranks (axis_name) wait for torch.distributed
    gt = tge._synth_gt(np.random.RandomState(0), 2, 8, 8, img=96)
    with pytest.raises(NotImplementedError, match="torch.distributed"):
        tm(t(images), t(sizes), gt=gt, rng=torch.Generator().manual_seed(0), training=True,
           ann_type="image", axis_name="data")
    losses = tm(t(images), t(sizes), gt=gt, rng=torch.Generator().manual_seed(0), training=True)
    assert len(losses) == 10 and all(torch.isfinite(v) for v in losses.values())
    # every other architecture builds, with the JAX detector's parameter names
    jentry = importlib.import_module("__graft_entry__")
    for key, value, size in (("MODEL.BACKBONE.NAME", "build_p67_timm_fpn_backbone", 64),
                             ("MODEL.BACKBONE.NAME", "build_p37_swin_bifpn_backbone", 128),
                             ("MODEL.META_ARCHITECTURE", "CenterNetDetector", 64),
                             ("MODEL.ROI_HEADS.NAME", "CustomRes5ROIHeads", 64)):
        jcfg, tcfg = jentry._small_cfg(), tge._small_cfg()
        for cfg in (jcfg, tcfg):
            cfg.merge_from_list([key, value])
        built = assert_same_parameters(jcfg, tcfg, size, training=value == "CustomRes5ROIHeads")
        assert hasattr(built, "roi_heads") == (value != "CenterNetDetector")


def test_reset_cls_test_and_zero_shot_classifier(tmp_path):
    """A zero-shot detector gets another vocabulary (5 → 7 classes): the
    port's in-place swap against the JAX package's new parameter tree."""
    rng = np.random.RandomState(8)
    feats, props, sizes = roi_inputs(9)
    kw = dict(ROI, num_classes=5, use_zeroshot_cls=True, norm_temp=5.0, mask_on=False)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**kw))
    jargs = ({k: jnp.asarray(v) for k, v in feats.items()},
             {k: jnp.asarray(v) for k, v in props.items()}, jnp.asarray(sizes))
    params = randomized(jm.init(jax.random.PRNGKey(0), *jargs, method=jm.inference), rng)
    stored = rng.randn(7, 512).astype(np.float32)  # on disk as (C, zs_dim)
    np.save(tmp_path / "zs.npy", stored)
    zs = trcnn.load_zs_weight(tmp_path / "zs.npy", zs_dim=512)
    np.testing.assert_array_equal(zs, jrcnn.load_zs_weight(tmp_path / "zs.npy", zs_dim=512))
    assert zs.shape == (512, 7)

    class Holder(torch.nn.Module):  # reset_cls_test takes the detector: roi_heads + roi_cfg
        def __init__(self, heads):
            super().__init__()
            self.roi_heads, self.roi_cfg = heads, heads.cfg

    holder = Holder(load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**kw), 16), params))
    trcnn.reset_cls_test(holder, zs)
    assert holder.roi_cfg.num_classes == 7
    jparams = jrcnn.reset_cls_test(params, zs)
    jm7 = jch.CascadeROIHeads(jch.ROIHeadsConfig(**dict(kw, num_classes=7)))
    want = jm7.apply(jparams, *jargs, method=jm7.inference)
    with torch.no_grad():
        got = holder.roi_heads.inference({k: t(v) for k, v in feats.items()},
                                         {k: t(v) for k, v in props.items()}, t(sizes))
    compare_detections(got, want)
    assert got["classes"].max() <= 6


def test_entry_runs_on_the_cpu_when_asked_and_raises_otherwise():
    model, (images, image_sizes) = tge.entry(device="cpu")
    dets = model(images, image_sizes)
    assert dets["boxes"].shape == (1, 16, 4) and dets["mask_logits"].shape == (1, 16, 28, 28)
    assert dets["valid"].any()
    for v in dets.values():
        assert torch.isfinite(v.float()).all()
    again, _ = tge.entry(device="cpu")
    for a, b in zip(model.state_dict().values(), again.state_dict().values()):
        assert torch.equal(a, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tge.entry()
