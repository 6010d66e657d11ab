"""The port's copy-paste compositor against the JAX one, same inputs.

numpy makes the inputs from a seed; both run in float32 on the CPU. Float
outputs agree to 1e-4 · max |reference| (the two frameworks may fuse a
multiply-add differently); bool and int outputs are equal, and at most
MAX_FLIPS mask pixels per mask may differ: a mask is ``alpha > 128/255`` on a
bilinear sample, and a pixel whose sample sits within rounding of the
threshold can flip. The inputs here have none.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops import copy_paste as jcp
from divergen_tpu_torch.ops import copy_paste as tcp

torch.set_num_threads(1)
TOL = 1e-4
MAX_FLIPS = 0
H, W = 48, 64


def close(got, ref, tol=TOL):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    if ref.dtype == bool or np.issubdtype(ref.dtype, np.integer):
        flips = int((got != ref).sum())
        per_mask = MAX_FLIPS * max(1, int(np.prod(ref.shape[:-2]))) if ref.ndim >= 3 else 0
        assert flips <= per_mask, flips
        return
    err = np.abs(got.astype(np.float64) - ref).max()
    assert err <= tol * max(np.abs(ref).max(), 1.0), err


def make_patch(rng, ph=20, pw=24):
    """Random rgb, a soft-edged alpha blob (values away from the threshold)."""
    rgb = rng.rand(ph, pw, 3).astype(np.float32) * 255
    alpha = np.zeros((ph, pw), np.float32)
    alpha[3:-3, 4:-4] = 0.9
    alpha[5:-5, 7:-7] = 1.0
    alpha[0, :] = 0.2
    return np.concatenate([rgb, alpha[..., None]], -1)


def sample(rng, n=3, p=3, invalid_patch=True, occluded=True):
    image = rng.rand(H, W, 3).astype(np.float32) * 255
    masks = np.zeros((n, H, W), bool)
    boxes = np.zeros((n, 4), np.float32)
    spots = [(9, 9, 17, 17), (30, 10, 60, 40), (2, 30, 18, 46)]
    for i, (x1, y1, x2, y2) in enumerate(spots[:n]):
        masks[i, y1:y2, x1:x2] = True
        boxes[i] = [x1, y1, x2, y2]
    patches = np.stack([make_patch(rng) for _ in range(p)])
    # patch 0 covers dst instance 0 entirely (occluded); patch 1 overlaps patch 0
    patch_boxes = np.array([[1.5, 2.0, 24.5, 23.0], [15.0, 8.5, 47.0, 37.5],
                            [40.2, 20.1, 70.0, 52.3]], np.float32)[:p]
    if not occluded:
        patch_boxes[0] = [44.0, 1.0, 54.0, 9.0]
    patch_valid = np.ones(p, bool)
    if invalid_patch:
        patch_valid[-1] = False
    return dict(
        image=image, masks=masks, boxes=boxes,
        classes=np.arange(n, dtype=np.int32), valid=np.ones(n, bool),
        source=np.zeros(n, np.int32), patches=patches, patch_boxes=patch_boxes,
        patch_classes=np.arange(10, 10 + p, dtype=np.int32), patch_valid=patch_valid,
        patch_flip=np.array([True, False, True])[:p],
        patch_angle=np.array([0.3, -0.7, 1.1], np.float32)[:p],
    )


ORDER = ("image", "masks", "boxes", "classes", "valid", "source", "patches", "patch_boxes",
         "patch_classes", "patch_valid", "patch_flip")


def both(jfn, tfn, s, with_angle, **kw):
    args = [s[k] for k in ORDER]
    angle = s["patch_angle"] if with_angle else None
    want = jfn(*(jnp.asarray(a) for a in args), patch_angle=None if angle is None
               else jnp.asarray(angle), **kw)
    got = tfn(*(torch.from_numpy(a) for a in args), patch_angle=None if angle is None
              else torch.from_numpy(angle), **kw)
    assert set(got) == set(want)
    for k in want:
        close(got[k].numpy(), want[k])
    return got, want


def test_mask_threshold():
    assert tcp.MASK_THRESHOLD == jcp.MASK_THRESHOLD


@pytest.mark.parametrize("flip", [None, False, True])
@pytest.mark.parametrize("angle", [None, 0.0, 0.6])
def test_rasterize_patch(flip, angle):
    rng = np.random.RandomState(0)
    patch = make_patch(rng)
    box = np.array([5.3, 7.9, 41.2, 39.6], np.float32)
    jkw = dict(flip=None if flip is None else jnp.asarray(flip),
               angle=None if angle is None else jnp.float32(angle))
    tkw = dict(flip=None if flip is None else torch.tensor(flip),
               angle=None if angle is None else torch.tensor(angle))
    want = jcp.rasterize_patch(jnp.asarray(patch), jnp.asarray(box), (H, W), **jkw)
    got = tcp.rasterize_patch(torch.from_numpy(patch), torch.from_numpy(box), (H, W), **tkw)
    for g, w in zip(got, want):
        close(g.numpy(), w)
    # the thresholded masks agree exactly
    close((got[1] > tcp.MASK_THRESHOLD).numpy()[None],
          np.asarray(want[1] > jcp.MASK_THRESHOLD)[None])


def test_box_blur_5x5():
    x = np.random.RandomState(1).rand(17, 23).astype(np.float32)
    close(tcp._box_blur_5x5(torch.from_numpy(x)).numpy(), jcp._box_blur_5x5(jnp.asarray(x)))


def test_boxes_from_masks():
    rng = np.random.RandomState(2)
    masks = rng.rand(5, 40, 60) > 0.8
    masks[3] = False  # empty
    want = np.asarray(jcp.boxes_from_masks(jnp.asarray(masks)))
    np.testing.assert_array_equal(tcp.boxes_from_masks(torch.from_numpy(masks)).numpy(), want)


def test_crop_binary_and_subbox():
    rng = np.random.RandomState(3)
    full = (rng.rand(H, W) > 0.5).astype(np.float32)
    for box in ([3.2, 4.1, 30.7, 28.4], [-5.0, -3.0, 20.0, 25.0], [50.0, 30.0, 80.0, 60.0]):
        box = np.array(box, np.float32)
        want = jcp._crop_binary(jnp.asarray(full), jnp.asarray(box), 14)
        got = tcp._crop_binary(torch.from_numpy(full), torch.from_numpy(box), 14)
        close(got.numpy(), want)
        close(tcp._boxframe_subbox(got, torch.from_numpy(box)).numpy(),
              jcp._boxframe_subbox(want, jnp.asarray(box)))
    empty = np.zeros((14, 14), np.float32)
    close(tcp._boxframe_subbox(torch.from_numpy(empty), torch.from_numpy(box)).numpy(),
          jcp._boxframe_subbox(jnp.asarray(empty), jnp.asarray(box)))


def test_normalize_cp_method():
    for m in ("basic", ["alpha"], ("gaussian",)):
        assert tcp.normalize_cp_method(m) == jcp.normalize_cp_method(m)
    with pytest.raises(NotImplementedError):
        tcp.normalize_cp_method(["basic", "alpha"])


@pytest.mark.parametrize("mode", ["basic", "alpha", "gaussian"])
@pytest.mark.parametrize("with_angle", [False, True])
def test_paste_instances(mode, with_angle):
    s = sample(np.random.RandomState(4))
    got, _ = both(jcp.paste_instances, tcp.paste_instances, s, with_angle, mode=mode)
    assert with_angle or not got["valid"][0]  # dst instance 0 lies under patch 0
    assert got["valid"][1] and not got["valid"][-1]  # the invalid patch stays invalid


def test_paste_instances_thresholds_and_no_flip():
    s = sample(np.random.RandomState(5), invalid_patch=False, occluded=False)
    s["patch_flip"] = None
    args = [s[k] for k in ORDER[:-1]]
    kw = dict(bbox_occluded_thr=2.0, mask_occluded_thr=50.0)
    want = jcp.paste_instances(*(jnp.asarray(a) for a in args), **kw)
    got = tcp.paste_instances(*(torch.from_numpy(a) for a in args), **kw)
    for k in want:
        close(got[k].numpy(), want[k])


def boxframe_sample(rng, s=14):
    smp = sample(rng)
    n = len(smp["boxes"])
    smp["masks"] = (rng.rand(n, s, s) > 0.3).astype(np.float32)
    return smp


@pytest.mark.parametrize("mode", ["basic", "alpha", "gaussian"])
@pytest.mark.parametrize("with_angle", [False, True])
def test_paste_instances_boxframe(mode, with_angle):
    s = boxframe_sample(np.random.RandomState(6))
    got, _ = both(jcp.paste_instances_boxframe, tcp.paste_instances_boxframe, s, with_angle,
                  mode=mode)
    assert with_angle or not got["valid"][0]
    assert not got["valid"][-1]


def test_paste_instances_boxframe_batched_equals_per_sample():
    """A leading batch dimension is the JAX package's vmap."""
    samples = [boxframe_sample(np.random.RandomState(10 + i)) for i in range(3)]
    stacked = [torch.from_numpy(np.stack([s[k] for s in samples])) for k in ORDER]
    got = tcp.paste_instances_boxframe(*stacked, mode="alpha")
    for i, s in enumerate(samples):
        one = tcp.paste_instances_boxframe(*(torch.from_numpy(s[k]) for k in ORDER),
                                           mode="alpha")
        for k in one:
            torch.testing.assert_close(got[k][i], one[k], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["basic", "gaussian"])
def test_paste_instances_batch(mode):
    samples = [sample(np.random.RandomState(20 + i)) for i in range(2)]
    keys = {"image": "image", "masks": "masks", "boxes": "boxes", "classes": "classes",
            "valid": "valid", "instance_source": "source", "patches": "patches",
            "patch_boxes": "patch_boxes", "patch_classes": "patch_classes",
            "patch_valid": "patch_valid", "patch_flip": "patch_flip"}
    batch = {k: np.stack([s[src] for s in samples]) for k, src in keys.items()}
    want = jcp.paste_instances_batch(mode, bbox_occluded_thr=5.0)(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = tcp.paste_instances_batch(mode, bbox_occluded_thr=5.0)(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    for k in want:
        close(got[k].numpy(), want[k])
