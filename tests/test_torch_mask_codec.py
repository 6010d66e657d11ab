"""The port's mask codec (``divergen_tpu_torch/utils/mask_codec.py``) against
the JAX package's, on seeded numpy inputs.

The RLE functions are copies and must agree exactly. ``polygons_to_bitmask``
is the port's own: the native scanline fill of ``native/polygon_fill.cpp``
against the JAX function's ``cv2.fillPoly``, bit for bit, on 240 seeded
polygons (convex and concave, self-touching, vertices off the frame, one-
and two-point, zero-area) and on multi-polygon segmentations.
"""
import numpy as np
import pytest
import torch

from divergen_tpu.utils import mask_codec as jmc
from divergen_tpu_torch.utils import mask_codec as tmc

torch.set_num_threads(1)


def random_masks(rng, n=12):
    out = [np.zeros((7, 5), bool), np.ones((6, 9), bool)]
    for _ in range(n):
        h, w = rng.randint(1, 40, 2)
        out.append(rng.rand(h, w) < rng.choice([0.05, 0.5, 0.95]))
    return out


def test_rle_functions_equal():
    rng = np.random.RandomState(0)
    for m in random_masks(rng):
        got, want = tmc.rle_encode(m), jmc.rle_encode(m)
        assert got == want
        np.testing.assert_array_equal(tmc.rle_decode(got), m)
        np.testing.assert_array_equal(tmc.rle_decode(got), jmc.rle_decode(want))
        assert tmc.rle_area(got) == jmc.rle_area(want) == int(m.sum())
        np.testing.assert_array_equal(tmc.mask_to_box(m), jmc.mask_to_box(m))
        runs = tmc._string_to_counts(got["counts"])
        assert runs == jmc._string_to_counts(want["counts"])
        assert tmc._counts_to_string(runs) == jmc._counts_to_string(runs)
        # uncompressed counts and str counts decode the same
        np.testing.assert_array_equal(tmc.rle_decode({"size": list(m.shape), "counts": runs}), m)
        np.testing.assert_array_equal(
            tmc.rle_decode({"size": list(m.shape), "counts": got["counts"].decode()}), m)


def seeded_polygons():
    """240 (height, width, [polygon]) cases, 40 of each kind."""
    rng = np.random.RandomState(1)
    cases = []
    for i in range(240):
        kind = i % 6
        h, w = int(rng.randint(4, 90)), int(rng.randint(4, 90))
        n = int(rng.randint(3, 14))
        if kind == 0:  # concave: a star around a centre
            ang = np.sort(rng.rand(n) * 2 * np.pi)
            r = rng.rand(n) * 0.5 * max(h, w) + 1
            pts = np.stack([w / 2 + r * np.cos(ang), h / 2 + r * np.sin(ang)], 1)
        elif kind == 1:  # self-touching: a vertex visited twice
            pts = rng.rand(n, 2) * [w, h]
            pts = np.concatenate([pts, pts[:1], rng.rand(3, 2) * [w, h]])
        elif kind == 2:  # vertices off the frame, sub-pixel coordinates
            pts = rng.rand(n, 2) * [3 * w, 3 * h] - [w, h]
        elif kind == 3:  # one or two points: a dot or a segment
            pts = rng.rand(int(rng.randint(1, 3)), 2) * [w * 1.2, h * 1.2] - 2
        elif kind == 4:  # zero area: collinear points
            a, b = rng.rand(2) * [w, h], rng.rand(2) * [w, h]
            pts = a + rng.rand(n, 1) * (b - a)
        else:  # random order: self-intersecting
            pts = rng.rand(n, 2) * [w + 10, h + 10] - 5
        cases.append((h, w, [pts.reshape(-1).tolist()]))
    return cases


@pytest.mark.parametrize("chunk", range(4))
def test_polygons_to_bitmask_bit_equal(chunk):
    cases = seeded_polygons()[chunk::4]
    filled = 0
    for h, w, polys in cases:
        got = tmc.polygons_to_bitmask(polys, h, w)
        want = jmc.polygons_to_bitmask(polys, h, w)
        assert got.dtype == want.dtype == bool and got.shape == (h, w)
        np.testing.assert_array_equal(got, want, err_msg=str((h, w, polys)))
        filled += int(want.any())
    assert filled > len(cases) // 2  # most cases draw pixels


def test_multi_polygon_union_and_empty():
    rng = np.random.RandomState(2)
    for _ in range(20):
        h, w = rng.randint(10, 60, 2)
        polys = [(rng.rand(rng.randint(3, 8), 2) * [w, h]).reshape(-1).tolist()
                 for _ in range(rng.randint(1, 4))]
        np.testing.assert_array_equal(tmc.polygons_to_bitmask(polys, h, w),
                                      jmc.polygons_to_bitmask(polys, h, w))
    assert not tmc.polygons_to_bitmask([], 5, 6).any()
    with pytest.raises(ValueError, match="without vertices"):  # cv2 asserts on it too
        tmc.polygons_to_bitmask([[]], 5, 6)
