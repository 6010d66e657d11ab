"""The port's copies of OpenCV's image routines (``native/imgproc.cpp``)
against ``cv2`` itself, on seeded inputs.

``box_blur`` (uint8 10 x 10 as ``lvis_crop`` blurs, float32 5 x 5 as the
'gaussian' blend), ``dilate`` with a rectangular kernel and iterations, HSV
both ways over all 2^24 colours, and ``warp_affine`` (INTER_LINEAR and
INTER_NEAREST, 1 and 3 channels) are bit exact. ``warp_affine`` copies OpenCV
5's float32 kernels, whose vector body (16 lanes where OpenCV dispatches
AVX-512) rounds its fused multiply-adds differently from its scalar tail:
on a CPU where OpenCV picks 8-lane AVX2 instead, the pixels where the two
roundings differ may be a level apart, and the test allows that. The float32
resize is within 1e-5 of the value range (OpenCV's own float path is not
reproduced bit for bit). Telea inpainting is bit exact too, on smooth and on
noise images, with holes inside the image and against its border.
"""
import cv2
import numpy as np
import pytest
import torch

from divergen_tpu_torch import native

torch.set_num_threads(1)

AVX512 = "*AVX512-SKX" in cv2.getCPUFeaturesLine()  # the dispatched set


def smooth(rng, h, w):
    grid = rng.random((max(h // 8, 2), max(w // 8, 2), 3)).astype(np.float32) * 255
    img = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.mark.parametrize("shape", [(1, 1), (3, 5), (9, 12), (10, 10), (1, 40), (60, 70),
                                   (480, 640)], ids=lambda s: "x".join(map(str, s)))
def test_box_blur(shape):
    rng = np.random.default_rng(sum(shape))
    img = rng.integers(0, 256, shape + (3,)).astype(np.uint8)
    np.testing.assert_array_equal(native.box_blur(img, (10, 10)), cv2.blur(img, (10, 10)))
    np.testing.assert_array_equal(native.box_blur(img[..., 0].copy(), (3, 7)),
                                  cv2.blur(img[..., 0].copy(), (3, 7)))
    f = (rng.random(shape) > 0.5).astype(np.float32)
    np.testing.assert_array_equal(native.box_blur(f, (5, 5)), cv2.blur(f, (5, 5)))


@pytest.mark.parametrize("iterations", [1, 3, 6])
def test_dilate(iterations):
    rng = np.random.default_rng(iterations)
    for ksize in ((5, 5), (3, 3), (4, 6)):
        m = (rng.random((37, 53)) < 0.02).astype(np.uint8)
        want = cv2.dilate(m, np.ones(ksize[::-1], np.uint8), iterations=iterations)
        np.testing.assert_array_equal(native.dilate(m, ksize, iterations), want)


def all_colours():
    c = np.arange(256, dtype=np.uint8)
    return np.stack(np.meshgrid(c, c, c, indexing="ij"), -1).reshape(4096, 4096, 3)


def test_rgb_to_hsv_all_colours():
    img = all_colours()
    np.testing.assert_array_equal(native.rgb_to_hsv(img), cv2.cvtColor(img, cv2.COLOR_RGB2HSV))


def test_hsv_to_rgb_all_triples():
    """Every (H, S, V) byte triple, H past 179 included."""
    img = all_colours()
    np.testing.assert_array_equal(native.hsv_to_rgb(img), cv2.cvtColor(img, cv2.COLOR_HSV2RGB))


def affine(rng, h, w, mirror):
    """InstaBoost's matrices: scale + rotate about a point, translate, flip."""
    cx, cy = rng.uniform(0, w), rng.uniform(0, h)
    s, ang = rng.uniform(0.8, 1.2), np.deg2rad(rng.uniform(-30, 30))
    tx, ty = rng.uniform(-15, 15), rng.uniform(-15, 15)
    c, si = np.cos(ang), np.sin(ang)
    m = np.array([[s * c, -s * si, 0], [s * si, s * c, 0], [0, 0, 1]])
    m = (np.array([[1, 0, cx + tx], [0, 1, cy + ty], [0, 0, 1.]]) @ m
         @ np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.]]))
    if mirror:
        m = m @ np.array([[-1, 0, 2 * cx], [0, 1, 0], [0, 0, 1.]])
    return m[:2]


@pytest.mark.parametrize("nearest", [False, True], ids=["linear", "nearest"])
@pytest.mark.parametrize("channels", [3, 1])
def test_warp_affine(nearest, channels):
    rng = np.random.default_rng(7 + channels + 2 * nearest)
    flag = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
    for trial in range(24):
        h, w = (int(v) for v in rng.integers(3, 160, 2))
        img = rng.integers(0, 256, (h, w, channels)).astype(np.uint8)
        img = img[..., 0].copy() if channels == 1 else img
        m = affine(rng, h, w, mirror=trial % 3 == 0)
        want = cv2.warpAffine(img, m, (w, h), flags=flag)
        got = native.warp_affine(img, m, (w, h), nearest=nearest)
        if AVX512 or nearest:
            np.testing.assert_array_equal(got, want)
        else:
            assert np.abs(got.astype(int) - want).max() <= 1


@pytest.mark.parametrize("src,dst", [((28, 28), (50, 37)), ((28, 28), (4, 4)),
                                     ((28, 28), (14, 14)), ((28, 28), (300, 200)),
                                     ((33, 21), (128, 128)), ((1, 1), (5, 3)), ((7, 9), (1, 1))],
                         ids=lambda s: "x".join(map(str, s)))
def test_resize_linear_float(src, dst):
    rng = np.random.default_rng(sum(src) + sum(dst))
    for channels, scale in ((0, 1.0), (4, 255.0)):
        img = (rng.random(src + ((channels,) if channels else ())) * scale).astype(np.float32)
        want = cv2.resize(img, dst[::-1], interpolation=cv2.INTER_LINEAR)
        got = native.resize_linear(img, *dst)
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-5 * scale


@pytest.mark.parametrize("radius", [3, 5])
@pytest.mark.parametrize("shape", [(40, 50), (97, 131), (200, 150)],
                         ids=lambda s: "x".join(map(str, s)))
def test_inpaint_telea(shape, radius):
    rng = np.random.default_rng(shape[0] + radius)
    h, w = shape
    img = smooth(rng, h, w)
    mask = np.zeros((h, w), np.uint8)
    for _ in range(3):
        y0, x0 = int(rng.integers(0, h - 5)), int(rng.integers(0, w - 5))
        mask[y0:y0 + int(rng.integers(3, h // 2)), x0:x0 + int(rng.integers(3, w // 2))] = 1
    mask[0:3, 5:9] = 1  # touching the image border
    np.testing.assert_array_equal(native.inpaint_telea(img, mask, radius),
                                  cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA))


@pytest.mark.parametrize("radius", [1, 3, 5])
def test_inpaint_telea_noise_and_borders(radius):
    """Scattered holes in noise, many of them on the image border, where
    the fast march's ties and the border-clamped gradients decide."""
    rng = np.random.default_rng(radius)
    for _ in range(20):
        h, w = (int(v) for v in rng.integers(6, 60, 2))
        img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
        mask = (rng.random((h, w)) < 0.15).astype(np.uint8)
        np.testing.assert_array_equal(native.inpaint_telea(img, mask, radius),
                                      cv2.inpaint(img, mask, radius, cv2.INPAINT_TELEA))
