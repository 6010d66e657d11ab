"""The port's rotated-box ops (``ops/rotated.py``) and ``RotatedBoxes``
helpers (``structures/rotated_boxes.py``) against the JAX package's, on the
same numpy boxes and maps, float32 on the CPU: rotated IoU within 1e-5, NMS
keep masks equal, ROIAlignRotated within 1e-5 of max |reference|."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops import rotated as jrot
from divergen_tpu.structures import rotated_boxes as jrb
from divergen_tpu_torch.ops import nms as tnms
from divergen_tpu_torch.ops import rotated as trot
from divergen_tpu_torch.structures import boxes as tbox
from divergen_tpu_torch.structures import rotated_boxes as trb

torch.set_num_threads(1)


def t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def random_boxes(seed, n, spread=40.0, angles=180.0):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.rand(n, 2) * spread, rng.rand(n, 2) * 12 + 1,
                           (rng.rand(n, 1) * 2 - 1) * angles], 1).astype(np.float32)


CASES = [
    ([0, 0, 4, 4, 0], [0, 0, 4, 4, 0]),        # identical
    ([0, 0, 4, 4, 0], [2, 0, 4, 4, 0]),        # half overlap
    ([0, 0, 4, 4, 0], [0, 0, 4, 4, 45]),       # rotated 45°
    ([0, 0, 6, 2, 30], [1, 1, 3, 5, -20]),     # generic
    ([0, 0, 4, 4, 0], [10, 10, 4, 4, 0]),      # disjoint
    ([0, 0, 8, 8, 15], [0, 0, 2, 2, 60]),      # containment
    ([0, 0, 4, 4, 0], [4, 0, 4, 4, 0]),        # touching edges
    ([0, 0, 4, 0, 0], [0, 0, 4, 4, 10]),       # a degenerate box
    ([5, 5, 10, 1, 90], [5, 5, 1, 10, 0]),     # the same box, 90° apart
]


@pytest.mark.parametrize("b1,b2", CASES)
def test_pairwise_iou_rotated_cases(b1, b2):
    a, b = np.asarray([b1, b2], np.float32), np.asarray([b2, b1], np.float32)
    want = np.asarray(jrot.pairwise_iou_rotated(jnp.asarray(a), jnp.asarray(b)))
    got = trot.pairwise_iou_rotated(t(a), t(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pairwise_iou_rotated_random(seed, monkeypatch):
    a, b = random_boxes(seed, 40), random_boxes(seed + 10, 30)
    want = np.asarray(jrot.pairwise_iou_rotated(jnp.asarray(a), jnp.asarray(b)))
    got = trot.pairwise_iou_rotated(t(a), t(b)).numpy()
    assert (want > 0.05).sum() > 20
    np.testing.assert_allclose(got, want, atol=1e-5)
    monkeypatch.setattr(trot, "_PAIRS", 64)  # rows in chunks: the same numbers
    np.testing.assert_array_equal(trot.pairwise_iou_rotated(t(a), t(b)).numpy(), got)


def test_pairwise_iou_rotated_axis_aligned():
    a, b = random_boxes(3, 12, angles=0.0), random_boxes(4, 9, angles=0.0)
    xyxy = lambda r: np.concatenate([r[:, :2] - r[:, 2:4] / 2, r[:, :2] + r[:, 2:4] / 2], 1)
    np.testing.assert_allclose(trot.pairwise_iou_rotated(t(a), t(b)).numpy(),
                               tbox.pairwise_iou(t(xyxy(a)), t(xyxy(b))).numpy(), atol=1e-5)


@pytest.mark.parametrize("thresh", [0.1, 0.3, 0.5, 0.7])
def test_nms_rotated_keeps_equal(thresh):
    rng = np.random.RandomState(5)
    centres = random_boxes(6, 12)
    boxes = centres[rng.randint(0, 12, 300)] + np.concatenate(
        [rng.randn(300, 2) * 1.5, rng.randn(300, 2) * 0.8, rng.randn(300, 1) * 8], 1)
    boxes[:, 2:4] = np.abs(boxes[:, 2:4]) + 0.5
    boxes = boxes.astype(np.float32)
    scores = rng.rand(300).astype(np.float32)
    scores[10:14] = scores[3]  # ties go in input order
    valid = rng.rand(300) > 0.1
    want = np.asarray(jrot.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), thresh,
                                       jnp.asarray(valid)))
    syncs = tnms.nms_mask.host_syncs
    got = trot.nms_rotated(t(boxes), t(scores), thresh, t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < valid.sum() and not got[~valid].any()
    assert tnms.nms_mask.host_syncs > syncs
    np.testing.assert_array_equal(
        trot.nms_rotated(t(boxes), t(scores), thresh).numpy(),
        np.asarray(jrot.nms_rotated(jnp.asarray(boxes), jnp.asarray(scores), thresh)))


def test_nms_rotated_greedy_chain():
    """A suppressed box does not suppress (the JAX test's chain)."""
    boxes = np.asarray([[0, 0, 4, 4, 0], [1.5, 0, 4, 4, 0], [3.0, 0, 4, 4, 0]], np.float32)
    keep = trot.nms_rotated(t(boxes), t(np.asarray([0.9, 0.8, 0.7], np.float32)), 0.3)
    assert keep.tolist() == [True, False, True]
    assert trot.nms_rotated(t(boxes[:0]), t(np.zeros(0, np.float32)), 0.3).shape == (0,)


@pytest.mark.parametrize("res,scale,ratio", [(4, 1.0, 2), (7, 0.5, 2), (3, 0.25, 1)])
def test_roi_align_rotated(res, scale, ratio):
    rng = np.random.RandomState(7)
    fmap = rng.randn(20, 24, 5).astype(np.float32)
    rois = random_boxes(8, 9, spread=60.0) * np.array([1, 1, 2, 2, 1], np.float32)
    rois[0] = [-8, 10, 12, 6, 30]  # partly outside the map
    want = np.asarray(jrot.roi_align_rotated(jnp.asarray(fmap), jnp.asarray(rois), res, scale,
                                             ratio))
    got = trot.roi_align_rotated(t(fmap), t(rois), res, scale, ratio).numpy()
    assert got.shape == (9, res, res, 5)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_rotated_boxes_helpers():
    b = np.asarray([[5, 5, 4, 2, 190.0], [100, 5, 4, 2, 0.0], [3, 4, 8, 8, 0.5],
                    [-2, 3, 0, 2, -540.0]], np.float32)
    for name in ("area", "normalize_angles", "nonempty"):
        np.testing.assert_allclose(getattr(trb, name)(t(b)).numpy(),
                                   np.asarray(getattr(jrb, name)(jnp.asarray(b))), atol=1e-6)
    for size in ((10, 10), (6, 120)):
        np.testing.assert_allclose(trb.clip(t(b), size).numpy(),
                                   np.asarray(jrb.clip(jnp.asarray(b), size)), atol=1e-6)
        np.testing.assert_array_equal(trb.inside_box(t(b), size, 1.0).numpy(),
                                      np.asarray(jrb.inside_box(jnp.asarray(b), size, 1.0)))
    xyxy = np.asarray([[0.0, 0, 4, 2], [3, 1, 9, 7]], np.float32)
    np.testing.assert_allclose(trb.xyxy_to_rotated(t(xyxy)).numpy(),
                               np.asarray(jrb.xyxy_to_rotated(jnp.asarray(xyxy))))
    assert trb.nms_rotated is trot.nms_rotated and trb.pairwise_iou_rotated is trot.pairwise_iou_rotated
