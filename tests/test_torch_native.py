"""The port's native evaluation library (``divergen_tpu_torch/native``)
against the JAX package's and against the port's numpy twins, on seeded
inputs: ``greedy_match``, ``rle_iou_matrix``, ``paste_mask_rle`` and the RLE
string codec. The port builds its own copy of the C++ sources into
``build/native/``; a failed build raises instead of falling back to numpy.
"""
import ctypes

import numpy as np
import pytest
import torch

from divergen_tpu import native as jnative
from divergen_tpu.utils.mask_codec import _counts_to_string as j_counts_to_string
from divergen_tpu_torch import native as tnative
from divergen_tpu_torch.evaluation import coco_eval_np as tce
from divergen_tpu_torch.evaluation.lvis_evaluator import paste_mask_np
from divergen_tpu_torch.utils.mask_codec import _string_to_counts, rle_decode, rle_encode

torch.set_num_threads(1)


def test_library_builds_into_the_checkout():
    so = tnative.build()
    assert so.parent == tnative.BUILD_DIR and so.exists()
    assert tnative.BUILD_DIR.parts[-2:] == ("build", "native")
    assert so == tnative.library_path()


def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path / "native")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        tnative.build()
    monkeypatch.setenv("CXX", "false")  # a compiler that fails
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tnative.build()


@pytest.mark.parametrize("trial", range(6))
def test_greedy_match(trial):
    rng = np.random.RandomState(trial)
    D, G = rng.randint(1, 14), rng.randint(1, 9)
    ious = rng.rand(D, G)
    ious[rng.rand(D, G) < 0.2] = 0.75  # ties at a threshold
    g_ignore = np.sort(rng.rand(G) > 0.7)  # ignored last (protocol order)
    iscrowd = (rng.rand(G) > 0.6) & g_ignore
    thrs = np.linspace(0.5, 0.95, 10)
    got = tnative.greedy_match(ious, g_ignore, iscrowd, thrs)
    want = jnative.greedy_match(ious, g_ignore, iscrowd, thrs)
    twin = tce.greedy_match_np(ious, g_ignore, iscrowd, thrs)
    for g, w, p in zip(got, want, twin):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, p)


def rles(rng, n, h, w):
    masks = [rng.rand(h, w) > rng.choice([0.3, 0.6, 0.95]) for _ in range(n)]
    masks[0][:] = False  # an empty mask
    return masks, [rle_encode(m) for m in masks]


@pytest.mark.parametrize("as_str", [False, True], ids=["bytes", "str"])
def test_rle_iou_matrix(as_str):
    rng = np.random.RandomState(3)
    _, dets = rles(rng, 5, 37, 29)
    _, gts = rles(rng, 4, 37, 29)
    if as_str:
        dets = [dict(r, counts=r["counts"].decode()) for r in dets]
        gts[1] = dict(gts[1], counts=_string_to_counts(gts[1]["counts"]))  # uncompressed
    iscrowd = np.array([False, True, False, True])
    got = tnative.rle_iou_matrix(dets, gts, iscrowd)
    np.testing.assert_array_equal(got, jnative.rle_iou_matrix(dets, gts, iscrowd))
    np.testing.assert_allclose(got, tce.mask_iou_np(dets, gts, iscrowd), rtol=1e-12, atol=0)
    np.testing.assert_array_equal(tce.mask_iou(dets, gts, iscrowd), got)
    assert tnative.rle_iou_matrix([], gts, iscrowd).shape == (0, 4)


def test_paste_mask_rle():
    rng = np.random.RandomState(4)
    cases = 0
    for h, w in [(64, 80), (128, 96), (50, 50), (17, 200)]:
        for _ in range(6):
            prob = rng.rand(28, 28).astype(np.float32)
            x1, y1 = rng.rand() * w * 1.2 - 0.2 * w, rng.rand() * h * 1.2 - 0.2 * h
            box = np.array([x1, y1, x1 + rng.rand() * w * 0.8 + 0.5,
                            y1 + rng.rand() * h * 0.8 + 0.5], np.float32)
            got = tnative.paste_mask_rle(prob, box, h, w)
            assert got == jnative.paste_mask_rle(prob, box, h, w)
            twin = paste_mask_np(prob, box, h, w)
            np.testing.assert_array_equal(rle_decode(got), twin)
            assert got["counts"] == rle_encode(twin)["counts"].decode()
            cases += int(twin.any())
    assert cases > 12
    # a box off the frame: an empty mask
    out = tnative.paste_mask_rle(np.ones((28, 28), np.float32),
                                 np.array([90.0, 90.0, 91.0, 91.0]), 64, 64)
    assert not rle_decode(out).any()


def test_rle_string_codec():
    lib = tnative.get_lib()
    runs = [0, 5, 100, 3, 77, 1, 100000, 2]
    arr = np.asarray(runs, np.int64)
    buf = ctypes.create_string_buffer(256)
    n = lib.rle_counts_to_string(tnative._ptr(arr), len(runs), buf, 256)
    assert buf.raw[:n] == j_counts_to_string(runs)
    out = np.zeros(32, np.int64)
    m = lib.rle_string_to_counts(buf.raw[:n], n, tnative._ptr(out), 32)
    assert out[:m].tolist() == runs
    rng = np.random.RandomState(5)
    rle = rle_encode(rng.rand(33, 47) > 0.5)
    np.testing.assert_array_equal(tnative._runs_of(rle), jnative._runs_of(rle))



def test_contours_in_the_library():
    """``contours.cpp`` is one of the library's sources and its entry point is
    bound: the outer borders of a ring with a speck in its hole and a line
    beside it, in ``cv2.findContours``' order (the last found first)."""
    assert "contours.cpp" in {src.name for src in tnative.SOURCES}
    assert hasattr(tnative.get_lib(), "external_contours")
    m = np.zeros((9, 14), np.uint8)
    m[1:8, 1:8] = 1
    m[3:6, 3:6] = 0
    m[4, 4] = 1
    m[2, 10:13] = 1
    got = tnative.external_contours(m)
    assert [c.tolist() for c in got] == [[[10, 2], [12, 2]], [[1, 1], [1, 7], [7, 7], [7, 1]]]
    assert [tnative.contour_area(c) for c in got] == [0.0, 36.0]
    assert tnative.external_contours(np.zeros((3, 3), np.uint8)) == []
    big = np.zeros((40, 40), np.uint8)
    big[::2, ::2] = 1  # 400 single pixels: more than the first buffers hold
    assert len(tnative.external_contours(big)) == 400
    with pytest.raises(ValueError, match="2-D"):
        tnative.external_contours(np.zeros((2, 2, 2), np.uint8))
