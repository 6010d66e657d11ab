"""The port's ``Res5ROIHeads`` and RefineMask against the JAX modules, float32
on the CPU: the resampling and boundary helpers, the head's stages, the
staged loss and the inference composition, and both through the ROI heads'
``losses`` (with and without the semantic target that ``SEM_SEG_ON`` makes
the mapper write) and ``inference``.

Weights as ``test_torch_detector.py`` makes them (``shape_init`` +
``randomized``); the draws of a loss are the uniform arrays the JAX keys
give (``jax_draws``). The ground-truth masks of the loss cases hold values
spread over [0, 1] (``soft_masks``): bilinear samples of a binary mask land
exactly on the target's 0.5 threshold, where the jitted JAX program's fused
arithmetic rounds otherwise than the same function evaluated op by op, which
the port matches to 1e-7 (checked once: RefineMask's ``loss_mask`` 1.4274457
op by op, 1.4274457 in the port, 1.4279063 jitted). Tolerances: modules and losses within 1e-4 of max
|reference| (a loss 1e-4 relative); detections with the same valid slots,
classes and proposal indices, boxes and scores within 1e-4 (boxes 1e-2 px);
block targets and weight maps equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.roi_heads import cascade_heads as jch
from divergen_tpu.modeling.roi_heads import refine_mask_head as jrm
from divergen_tpu.modeling.roi_heads import res5_roi_heads as jr5
from divergen_tpu.ops.roi_align import roi_align as jroi_align
from divergen_tpu_torch.modeling.roi_heads import cascade_heads as tch
from divergen_tpu_torch.modeling.roi_heads import refine_mask_head as trm
from divergen_tpu_torch.modeling.roi_heads import res5_roi_heads as tr5
from divergen_tpu_torch.ops.roi_align import roi_align as troi_align
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_detector import (ROI, assert_rel_close, compare_detections, load, randomized,
                                 roi_inputs, shape_init, t)
from test_torch_resnet import perturbed
from test_torch_train_losses import (assert_losses_close, jax_draws, jx, roi_gt, torch_gt, tt)

torch.set_num_threads(1)


# -- resampling and boundary helpers ------------------------------------------------

@pytest.mark.parametrize("shape,out", [((3, 7, 9), (14, 5)), ((2, 14, 14), (28, 28)),
                                       ((4, 13, 13), (6, 6)), ((2, 1, 5), (3, 8))])
def test_resize_align_corners(shape, out):
    x = np.random.RandomState(sum(shape)).randn(*shape).astype(np.float32)
    want = jrm.resize_align_corners(jnp.asarray(x), *out)
    got = trm.resize_align_corners(t(x), *out)
    assert tuple(got.shape) == tuple(want.shape)
    assert_rel_close(got.numpy(), want, 1e-6)


def binary_masks(seed, n=4, s=28):
    rng = np.random.RandomState(seed)
    m = np.zeros((n, s, s), np.float32)
    for i in range(n):  # blobs with ragged edges, one touching the border
        y0, x0 = rng.randint(0, s // 2, 2)
        m[i, y0:y0 + rng.randint(4, s // 2 + 4), x0:x0 + rng.randint(4, s // 2 + 4)] = 1
    return np.where(rng.rand(n, s, s) < 0.05, 1 - m, m)


@pytest.mark.parametrize("width", [1, 2, 3])
def test_generate_block_target(width):
    m = binary_masks(width)
    want = np.asarray(jrm.generate_block_target(jnp.asarray(m), width))
    got = trm.generate_block_target(t(m), width).numpy()
    assert got.dtype == np.int32 and set(np.unique(want)) == {0, 1, 2}
    np.testing.assert_array_equal(got, want)


def test_boundary_weight_map():
    m = binary_masks(7)
    np.testing.assert_array_equal(trm.boundary_weight_map(t(m), 1, 2.0).numpy(),
                                  np.asarray(jrm.boundary_weight_map(jnp.asarray(m), 1, 2.0)))


# -- the head's stages, the staged loss, the composition --------------------------------

SUP = (7, 14, 28)


@pytest.fixture(scope="module")
def refine_case():
    """RefineMaskHead(conv_dim 16) over 2 × 2 rows of 7 × 7 features, the
    semantic maps of a 12 × 16 level at stride 8."""
    rng = np.random.RandomState(21)
    inst = rng.randn(4, 7, 7, 16).astype(np.float32)
    sem_feat = rng.randn(2, 12, 16, 24).astype(np.float32)
    sem_pred = (rng.randn(2, 12, 16) * 2).astype(np.float32)
    xy = rng.rand(2, 2, 2) * 60
    boxes = np.concatenate([xy, xy + rng.rand(2, 2, 2) * 50 + 10], -1).astype(np.float32)

    def jcrop(full, res):
        return jax.vmap(lambda f, b: jroi_align(f, b, res, 1 / 8))(
            full, jnp.asarray(boxes)).reshape(4, res, res, -1)

    def tcrop(full, res):
        return torch.cat([troi_align(full[i], t(boxes[i]), res, 1 / 8) for i in range(2)])

    jm = jrm.RefineMaskHead(conv_dim=16, stage_sup_size=SUP)
    args = (jnp.asarray(inst), jnp.asarray(sem_feat), jnp.asarray(sem_pred))
    variables = perturbed(jax.eval_shape(lambda k: jm.init(k, *args, jcrop),
                                         jax.random.PRNGKey(0)), 5)
    want = jax.jit(lambda v, *a: jm.apply(v, *a, jcrop))(variables, *args)
    tm = trm.RefineMaskHead(16, 24, conv_dim=16, stage_sup_size=SUP)
    tm.load_state_dict(params_from_jax(variables, tm), strict=True)
    with torch.no_grad():
        got = tm(t(inst), t(sem_feat), t(sem_pred), tcrop)
    return [np.asarray(w) for w in want], got


def test_refine_mask_head_stages(refine_case):
    want, got = refine_case
    assert [tuple(g.shape) for g in got] == [(4, s, s) for s in SUP]
    for g, w in zip(got, want):
        assert_rel_close(g.numpy(), w, 1e-4)


def test_compose_stage_preds(refine_case):
    want, _ = refine_case  # the same stage logits on both sides: the composition alone
    ref = np.asarray(jrm.compose_stage_preds([jnp.asarray(w) for w in want]))
    got = trm.compose_stage_preds([t(w) for w in want]).numpy()
    assert got.shape == (4, 28, 28)
    assert_rel_close(got, ref, 1e-6)
    assert not np.allclose(got, want[-1])  # the coarser stages' logits stay off the band


def test_refine_cross_entropy(refine_case):
    want, _ = refine_case
    targets = [np.asarray(jrm.resize_align_corners(jnp.asarray(binary_masks(3, 4, 28)), s, s)
                          >= 0.5).astype(np.float32) for s in SUP]
    valid = np.array([True, True, False, True])
    ref, ref_g = jax.jit(jax.value_and_grad(lambda lg: jrm.refine_cross_entropy(
        lg, [jnp.asarray(x) for x in targets], jnp.asarray(valid), stage_weights=(0.5, 0.75, 1.0)
    )))([jnp.asarray(w) for w in want])
    logits = [t(w).requires_grad_(True) for w in want]
    got = trm.refine_cross_entropy(logits, [t(x) for x in targets], t(valid),
                                   stage_weights=(0.5, 0.75, 1.0))
    np.testing.assert_allclose(got.item(), float(ref), rtol=1e-4)
    got.backward()
    for g, w in zip(logits, ref_g):
        assert_rel_close(g.grad.numpy(), w, 1e-4)


# -- the ROI heads with RefineMask: losses (with and without sem_seg), inference ----------

REFINE = dict(ROI, mask_head_name="RefineMaskHead", stage_sup_size=(14, 28, 56),
              fed_loss_num_cat=4, batch_size_per_image=16, mask_fg_capacity=8)


def soft_masks(gt, seed):
    gt = dict(gt)
    gt["masks"] = np.random.RandomState(seed).rand(*gt["masks"].shape).astype(np.float32)
    return gt


@pytest.fixture(scope="module")
def refine_heads():
    rng = np.random.RandomState(23)
    feats, props, sizes = roi_inputs(24)
    gt = soft_masks(roi_gt(25, props), 28)
    gt["sem_seg"] = (rng.rand(2, 10, 13) > 0.6).astype(np.float32)  # resized to 16 × 20
    fed = (rng.rand(8) * 20 + 1).astype(np.float32) ** 0.5
    key = jax.random.PRNGKey(26)
    jm = jch.CascadeROIHeads(jch.ROIHeadsConfig(**REFINE))
    params = randomized(shape_init(jm, key, jx(feats), jx(props), jx(gt),
                                   fed_weight=jnp.asarray(fed), image_sizes=jnp.asarray(sizes),
                                   method=jm.losses), rng)
    tm = load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**REFINE), 16), params).train()
    return jm, params, tm, feats, props, sizes, gt, fed, key


@pytest.fixture(scope="module")
def refine_losses(refine_heads):
    """The JAX loss dict with the semantic target, jitted once."""
    jm, params, _, feats, props, sizes, gt, fed, key = refine_heads
    return jax.jit(lambda p: jm.apply(p, key, jx(feats), jx(props), jx(gt),
                                      fed_weight=jnp.asarray(fed), image_sizes=jnp.asarray(sizes),
                                      method=jm.losses))(params)


@pytest.mark.parametrize("sem_seg", [True, False], ids=["SEM_SEG_ON", "no sem_seg"])
def test_refine_mask_losses(refine_heads, refine_losses, sem_seg):
    """Without ``gt["sem_seg"]`` the same losses but ``loss_semantic``."""
    _, _, tm, feats, props, sizes, gt, fed, key = refine_heads
    want = dict(refine_losses)
    if not sem_seg:
        gt = {k: v for k, v in gt.items() if k != "sem_seg"}
        del want["loss_semantic"]
    got = tm.losses(jax_draws(key, 2, 30, 8), tt(feats), tt(props), torch_gt(gt),
                    fed_weight=t(fed), image_sizes=t(sizes))
    assert ("loss_semantic" in got) == sem_seg
    assert_losses_close(got, want)


def test_refine_mask_inference(refine_heads):
    jm, params, tm, feats, props, sizes, _, _, _ = refine_heads
    rng = np.random.RandomState(27)
    params = randomized(params, rng)  # spread the class scores over the classes
    want = jax.jit(lambda p: jm.apply(p, jx(feats), jx(props), jnp.asarray(sizes),
                                      method=jm.inference))(params)
    tm = load(tch.CascadeROIHeads(tch.ROIHeadsConfig(**REFINE), 16), params)
    with torch.no_grad():
        got = tm.inference(tt(feats), tt(props), t(sizes))
    assert got["mask_logits"].shape == (2, 16, 56, 56)
    compare_detections(got, want, mask_tol=1e-4)


# -- Res5ROIHeads ------------------------------------------------------------------------

RES5 = dict(ROI, in_features=("p4",), strides=(16,), fed_loss_num_cat=4,
            batch_size_per_image=16)


def res5_draws(key, rows, classes):
    """The cascade's names for Res5's draws: its one stage takes the
    federated draw from ``k_fed`` itself, not ``fold_in(k_fed, 0)``."""
    draws = jax_draws(key, 2, rows, classes, stages=1)
    _, k_fed = jax.random.split(jax.random.fold_in(key, 0))
    draws["fed0"] = np.asarray(jax.random.uniform(k_fed, (classes + 1,)))
    return draws


@pytest.fixture(scope="module")
def res5_case():
    rng = np.random.RandomState(31)
    feats, props, sizes = roi_inputs(32)
    gt = soft_masks(roi_gt(33, props), 36)
    fed = (rng.rand(8) * 20 + 1).astype(np.float32) ** 0.5
    key = jax.random.PRNGKey(34)
    jm = jr5.Res5ROIHeads(jch.ROIHeadsConfig(**RES5), res5_channels=64)
    params = randomized(shape_init(jm, key, jx(feats), jx(props), jx(gt),
                                   fed_weight=jnp.asarray(fed), method=jm.losses), rng)
    params = jax.tree.map(np.asarray, params)
    for blk in ("res5_block0", "res5_block1", "res5_block2"):  # FrozenBN off the identity
        params["params"][blk] = perturbed(params["params"][blk], 35)
    tm = load(tr5.Res5ROIHeads(tch.ROIHeadsConfig(**RES5), 16, res5_channels=64), params)
    return jm, params, tm, feats, props, sizes, gt, fed, key


def test_res5_losses(res5_case):
    jm, params, tm, feats, props, sizes, gt, fed, key = res5_case
    want = jax.jit(lambda p: jm.apply(p, key, jx(feats), jx(props), jx(gt),
                                      fed_weight=jnp.asarray(fed), method=jm.losses))(params)
    tm.train()
    got = tm.losses(res5_draws(key, 30, 8), tt(feats), tt(props), torch_gt(gt), fed_weight=t(fed))
    assert sorted(got) == ["loss_box_reg", "loss_cls", "loss_mask"]
    assert_losses_close(got, want)
    # image_label_losses is ported (tests/test_torch_weak_supervision.py)
    weak = tm.image_label_losses(tt(feats), tt(props), t(sizes), torch.tensor([[2, 5]] * 2),
                                 torch.ones(2, 2, dtype=torch.bool))
    assert sorted(weak) == ["image_loss", "loss_box_reg", "loss_cls", "loss_mask"]
    assert torch.isfinite(weak["image_loss"]) and weak["image_loss"] > 0


def test_res5_inference(res5_case):
    jm, params, tm, feats, props, sizes, _, _, _ = res5_case
    want = jax.jit(lambda p: jm.apply(p, jx(feats), jx(props), jnp.asarray(sizes),
                                      method=jm.inference))(params)
    got = tm.inference(tt(feats), tt(props), t(sizes))
    assert got["mask_logits"].shape == (2, 16, 14, 14)
    compare_detections(got, want, mask_tol=1e-4)
