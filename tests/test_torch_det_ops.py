"""The port's detection ops against the JAX package, same inputs.

numpy makes the inputs from a seed; both sides run in float32 on the CPU.
Keep masks, indices and other integer outputs must be equal; floats agree to
1e-5. ``jax.lax.top_k`` is stable, and so is the port's top-k, so indices
compare one for one under the ``valid`` mask (rows that are not valid hold
score -inf on both sides and may come back in any order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.roi_heads import box_regression as jbr
from divergen_tpu.ops import nms as jnms
from divergen_tpu.structures import boxes as jbox
from divergen_tpu_torch.modeling.roi_heads import box_regression as tbr
from divergen_tpu_torch.ops import mask_paste as tmp
from divergen_tpu_torch.ops import nms as tnms
from divergen_tpu_torch.ops import roi_align as tra
from divergen_tpu_torch.structures import boxes as tbox

# divergen_tpu.ops re-exports functions under these two module names
jmp = importlib.import_module("divergen_tpu.ops.mask_paste")
jra = importlib.import_module("divergen_tpu.ops.roi_align")

torch.set_num_threads(1)
ATOL = 1e-5


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def rand_boxes(rng, n, extent=100.0, min_side=2.0, max_side=40.0):
    xy = rng.rand(n, 2) * extent
    wh = rng.rand(n, 2) * (max_side - min_side) + min_side
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def close(got, ref, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=atol, rtol=1e-5)


# -- boxes -------------------------------------------------------------------

@pytest.mark.parametrize("name", ["area", "nonempty", "centers", "xywh_to_xyxy", "xyxy_to_xywh"])
def test_boxes_unary(name):
    rng = np.random.RandomState(0)
    b = rand_boxes(rng, 12)
    b[3] = [5, 5, 5, 9]  # degenerate
    b[4] = [9, 9, 3, 3]  # inverted
    got = getattr(tbox, name)(t(b)).numpy()
    ref = np.asarray(getattr(jbox, name)(jnp.asarray(b)))
    if got.dtype == bool:
        np.testing.assert_array_equal(got, ref)
    else:
        close(got, ref)


@pytest.mark.parametrize("name", ["pairwise_iou", "pairwise_ioa", "matched_pairwise_iou"])
def test_boxes_pairwise(name):
    rng = np.random.RandomState(1)
    a, b = rand_boxes(rng, 9), rand_boxes(rng, 9)
    a[0] = b[0]
    b[2] = [0, 0, 0, 0]
    close(getattr(tbox, name)(t(a), t(b)).numpy(), getattr(jbox, name)(jnp.asarray(a), jnp.asarray(b)))


def test_boxes_clip_and_scale():
    rng = np.random.RandomState(2)
    b = rand_boxes(rng, 10, extent=120.0) - 10.0
    close(tbox.clip(t(b), (64, 96)).numpy(), jbox.clip(jnp.asarray(b), (64, 96)))
    close(tbox.clip(t(b), torch.tensor([64, 96])).numpy(), jbox.clip(jnp.asarray(b), (64, 96)))
    sizes = np.array([[64, 96], [50, 40]], np.int32)
    batched = np.stack([b, b + 3.0])
    ref = np.stack([np.asarray(jbox.clip(jnp.asarray(batched[i]), sizes[i])) for i in range(2)])
    close(tbox.clip(t(batched), t(sizes)).numpy(), ref)
    close(tbox.scale(t(b), 0.5, 2.0).numpy(), jbox.scale(jnp.asarray(b), 0.5, 2.0))


# -- nms ---------------------------------------------------------------------

def nms_inputs(seed, n, clustered=True):
    rng = np.random.RandomState(seed)
    if clustered:  # a few centres with jitter, so that suppression chains occur
        centres = rng.rand(max(n // 12, 1), 2) * 200
        xy = centres[rng.randint(0, len(centres), n)] + rng.randn(n, 2) * 6
        wh = 30 + rng.rand(n, 2) * 20
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    else:
        boxes = rand_boxes(rng, n, extent=300.0)
    scores = rng.permutation(n).astype(np.float32) / n  # all distinct: no ties
    valid = rng.rand(n) > 0.15
    return boxes, scores, valid


@pytest.mark.parametrize("n,thresh", [(1, 0.5), (40, 0.5), (256, 0.6), (300, 0.5), (700, 0.9)],
                         ids=["one", "small", "one-tile", "two-tiles", "three-tiles"])
def test_nms_mask(n, thresh):
    boxes, scores, valid = nms_inputs(n, n)
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                   jnp.asarray(valid)))
    got = tnms.nms_mask(t(boxes), t(scores), thresh, t(valid)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert not got[~valid].any()
    if n >= 40:
        assert 0 < got.sum() < valid.sum()  # something was suppressed, something kept


def test_nms_mask_without_valid_and_empty():
    boxes, scores, _ = nms_inputs(5, 60)
    ref = np.asarray(jnms.nms_mask(jnp.asarray(boxes), jnp.asarray(scores), 0.5))
    np.testing.assert_array_equal(tnms.nms_mask(t(boxes), t(scores), 0.5).numpy(), ref)
    assert tnms.nms_mask(torch.zeros(0, 4), torch.zeros(0), 0.5).shape == (0,)


def test_nms_mask_is_greedy():
    """Against a sequential greedy loop written out in numpy."""
    boxes, scores, valid = nms_inputs(7, 120)
    iou = np.asarray(jbox.pairwise_iou(jnp.asarray(boxes), jnp.asarray(boxes)))
    keep = np.zeros(len(boxes), bool)
    for i in np.argsort(-scores, kind="stable"):
        if valid[i] and not (keep & (iou[i] > 0.5)).any():
            keep[i] = True
    np.testing.assert_array_equal(tnms.nms_mask(t(boxes), t(scores), 0.5, t(valid)).numpy(), keep)


@pytest.mark.parametrize("with_valid", [True, False])
def test_batched_nms_mask(with_valid):
    boxes, scores, valid = nms_inputs(11, 300)
    classes = np.random.RandomState(3).randint(0, 4, 300).astype(np.int32)
    boxes[~valid] += 5000.0  # invalid rows must not set the class offset
    v = valid if with_valid else None
    ref = np.asarray(jnms.batched_nms_mask(jnp.asarray(boxes), jnp.asarray(scores),
                                           jnp.asarray(classes), 0.5,
                                           None if v is None else jnp.asarray(v)))
    got = tnms.batched_nms_mask(t(boxes), t(scores), t(classes), 0.5,
                                None if v is None else t(v)).numpy()
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("n,k", [(50, 16), (10, 16)], ids=["n>k", "n<k"])
def test_top_scoring(n, k):
    rng = np.random.RandomState(n)
    boxes = rand_boxes(rng, n)
    scores = rng.permutation(n).astype(np.float32) / n
    keep = rng.rand(n) > 0.4
    cls = rng.randint(0, 9, n).astype(np.int32)
    feat = rng.randn(n, 3).astype(np.float32)
    rb, rs, rv, ri, (rc, rf) = jnms.top_scoring(jnp.asarray(boxes), jnp.asarray(scores),
                                                jnp.asarray(keep), k,
                                                extras=(jnp.asarray(cls), jnp.asarray(feat)))
    gb, gs, gv, gi, (gc, gf) = tnms.top_scoring(t(boxes), t(scores), t(keep), k,
                                                extras=(t(cls), t(feat)))
    rv = np.asarray(rv)
    np.testing.assert_array_equal(gv.numpy(), rv)
    assert gb.shape == (k, 4) and gc.shape == (k,) and gf.shape == (k, 3)
    np.testing.assert_array_equal(gi.numpy()[rv], np.asarray(ri)[rv])
    np.testing.assert_array_equal(gc.numpy()[rv], np.asarray(rc)[rv])
    close(gs.numpy(), rs)
    close(gb.numpy()[rv], np.asarray(rb)[rv])
    close(gf.numpy()[rv], np.asarray(rf)[rv])


def test_stable_topk_breaks_ties_by_index():
    v = torch.tensor([1.0, 3.0, 3.0, 2.0, 3.0, float("-inf")])
    vals, idx = tnms.stable_topk(v, 4)
    assert idx.tolist() == [1, 2, 4, 3] and vals.tolist() == [3.0, 3.0, 3.0, 2.0]


# -- roi_align ---------------------------------------------------------------

def roi_inputs(seed, h=20, w=28, c=6, n=14, stride=8):
    rng = np.random.RandomState(seed)
    feat = rng.randn(h, w, c).astype(np.float32)
    boxes = rand_boxes(rng, n, extent=w * stride * 0.8, min_side=4.0, max_side=120.0)
    boxes[0] = [-30.0, -20.0, 40.0, 50.0]  # crosses the top-left border
    boxes[1] = [w * stride - 20.0, h * stride - 30.0, w * stride + 60.0, h * stride + 45.0]
    boxes[2] = [-6.0, 10.0, 2.0, 14.0]  # samples within 1 px outside: clamped
    boxes[3] = [10.0, 10.0, 10.0, 10.0]  # empty
    boxes[4] = [0.0, 0.0, w * stride * 1.5, h * stride * 1.5]  # counts above the cap of 12
    return feat, boxes


@pytest.mark.parametrize("ratio", [2, 0], ids=["fixed", "adaptive"])
@pytest.mark.parametrize("out", [7, 14])
def test_roi_align(out, ratio):
    feat, boxes = roi_inputs(out + ratio)
    ref = jra.roi_align(jnp.asarray(feat), jnp.asarray(boxes), out, 1 / 8, sampling_ratio=ratio)
    got = tra.roi_align(t(feat), t(boxes), out, 1 / 8, sampling_ratio=ratio)
    assert got.shape == (len(boxes), out, out, feat.shape[-1])
    close(got.numpy(), ref)


def test_roi_align_given_counts():
    feat, boxes = roi_inputs(3)
    cy = np.array([1, 2, 3, 15, 12, 4, 1, 2, 5, 7, 1, 1, 2, 3], np.int32)
    cx = cy[::-1].copy()
    ref = jra.roi_align(jnp.asarray(feat), jnp.asarray(boxes), 7, 1 / 8,
                        sample_counts=(jnp.asarray(cy), jnp.asarray(cx)))
    got = tra.roi_align(t(feat), t(boxes), 7, 1 / 8, sample_counts=(t(cy), t(cx)))
    close(got.numpy(), ref)


def test_assign_boxes_to_levels():
    rng = np.random.RandomState(4)
    boxes = rand_boxes(rng, 40, extent=500.0, min_side=4.0, max_side=900.0)
    boxes[0] = [3, 3, 3, 3]
    ref = np.asarray(jra.assign_boxes_to_levels(jnp.asarray(boxes), 3, 5))
    got = tra.assign_boxes_to_levels(t(boxes), 3, 5).numpy()
    np.testing.assert_array_equal(got, ref)
    assert set(got.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("out", [7, 14])
def test_multilevel_roi_align(out):
    rng = np.random.RandomState(out)
    fmaps = [rng.randn(32 // 2 ** i, 40 // 2 ** i, 5).astype(np.float32) for i in range(3)]
    boxes = rand_boxes(rng, 24, extent=250.0, min_side=6.0, max_side=400.0)
    boxes[0] = [-40.0, -40.0, 500.0, 400.0]
    ref = jra.multilevel_roi_align([jnp.asarray(f) for f in fmaps], [8, 16, 32],
                                   jnp.asarray(boxes), out)
    got = tra.multilevel_roi_align([t(f) for f in fmaps], [8, 16, 32], t(boxes), out)
    close(got.numpy(), ref)


# -- box regression and mask pasting ------------------------------------------

@pytest.mark.parametrize("weights", [(10.0, 10.0, 5.0, 5.0), (30.0, 30.0, 15.0, 15.0)])
def test_box_regression(weights):
    rng = np.random.RandomState(5)
    src, tgt = rand_boxes(rng, 30), rand_boxes(rng, 30)
    src[0] = [4, 4, 4, 4]
    deltas = np.asarray(jbr.get_deltas(jnp.asarray(src), jnp.asarray(tgt), weights))
    close(tbr.get_deltas(t(src), t(tgt), weights).numpy(), deltas, atol=1e-4)
    d = (rng.randn(2, 30, 4) * 3).astype(np.float32)
    d[0, 1, 2:] = 100.0  # clamped at log(1000 / 16)
    ref = jbr.apply_deltas(jnp.asarray(d), jnp.asarray(np.stack([src, tgt])), weights)
    close(tbr.apply_deltas(t(d), t(np.stack([src, tgt])), weights).numpy(), ref, atol=1e-3)


@pytest.mark.parametrize("threshold", [0.5, -1.0], ids=["binary", "soft"])
def test_paste_masks(threshold):
    rng = np.random.RandomState(6)
    masks = rng.rand(6, 28, 28).astype(np.float32)
    boxes = rand_boxes(rng, 6, extent=40.0, min_side=5.0, max_side=30.0)
    boxes[0] = [-8.0, -5.0, 20.0, 30.0]
    boxes[1] = [50.0, 30.0, 90.0, 70.0]  # crosses the bottom-right corner
    ref = np.asarray(jmp.paste_masks(jnp.asarray(masks), jnp.asarray(boxes), (48, 64), threshold))
    got = tmp.paste_masks(t(masks), t(boxes), (48, 64), threshold).numpy()
    assert got.shape == (6, 48, 64)
    if threshold >= 0:
        # a pixel whose soft value sits on the threshold may round either way
        soft = np.asarray(jmp.paste_masks(jnp.asarray(masks), jnp.asarray(boxes), (48, 64), -1.0))
        decided = np.abs(soft - threshold) > 1e-5
        np.testing.assert_array_equal(got[decided], ref[decided])
        assert decided.mean() > 0.999
    else:
        close(got, ref)
