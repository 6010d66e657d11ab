"""The port's pipeline-overlap orchestration: the four cases of the JAX
package's orchestrator tests on the port's classes, the port's ``LivePool``
and ``InstanceProducer`` against the JAX package's on the same seeds, patches
and callbacks, and the patch resize against OpenCV's (the JAX package's)
bilinear resize."""
import cv2
import numpy as np
import pytest
import torch

from divergen_tpu.pipeline import orchestrator as jax_orch
from divergen_tpu_torch.ops.copy_paste import paste_instances_boxframe
from divergen_tpu_torch.pipeline import orchestrator as torch_orch
from divergen_tpu_torch.pipeline.orchestrator import InstanceProducer, LivePool

torch.set_num_threads(1)


def fake_generate(cat, rng):
    return (rng.random((2, 32, 32, 3)) * 255).astype(np.uint8)


def fake_mask(images):
    m = np.zeros(images.shape[:3], bool)
    m[:, 8:24, 8:24] = True
    return m


def fake_score(images, masks, cat):
    return np.full(len(images), 0.9)


def test_producer_fills_pool_and_sampling_works():
    pool = LivePool(patch_size=16, train_size=(64, 64), max_samples=4)
    prod = InstanceProducer(
        pool, categories=[3, 7], generate_fn=fake_generate, mask_fn=fake_mask,
        score_fn=fake_score, clip_threshold=0.5, max_rounds=3,
    )
    prod.start()
    prod.join(timeout=30)
    assert prod.produced == 2 * 2 * 3
    counts = pool.counts()
    assert counts[3] == 6 and counts[7] == 6

    rng = np.random.default_rng(0)
    got_any = False
    for _ in range(10):
        s = pool.make_paste_sample(rng, max_pastes=3)
        if s["patch_valid"].any():
            got_any = True
            k = np.where(s["patch_valid"])[0][0]
            assert s["patches"][k, ..., 3].max() == 1.0
            assert s["patch_classes"][k] in (3, 7)
    assert got_any


def test_producer_rejects_low_scores():
    pool = LivePool(patch_size=16)
    prod = InstanceProducer(
        pool, categories=[1], generate_fn=fake_generate, mask_fn=fake_mask,
        score_fn=lambda i, m, c: np.zeros(len(i)), clip_threshold=0.5, max_rounds=2,
    )
    prod.start()
    prod.join(timeout=30)
    assert prod.produced == 0 and prod.rejected == 4
    assert pool.counts() == {}


def test_live_pool_feeds_device_compositor():
    pool = LivePool(patch_size=16, train_size=(64, 64), max_samples=4)
    prod = InstanceProducer(
        pool, categories=[2], generate_fn=fake_generate, mask_fn=fake_mask,
        score_fn=fake_score, clip_threshold=0.5, max_rounds=1,
    )
    prod.start()
    prod.join(timeout=30)
    rng = np.random.default_rng(1)
    s = None
    for _ in range(20):
        s = pool.make_paste_sample(rng, max_pastes=2)
        if s["patch_valid"].any():
            break
    assert s is not None and s["patch_valid"].any()
    out = paste_instances_boxframe(
        torch.zeros((64, 64, 3)),
        torch.ones((1, 8, 8)),
        torch.tensor([[10.0, 10.0, 30.0, 30.0]]),
        torch.tensor([0], dtype=torch.int32),
        torch.tensor([True]),
        torch.tensor([0], dtype=torch.int32),
        *(torch.from_numpy(s[k]) for k in ("patches", "patch_boxes", "patch_classes",
                                           "patch_valid", "patch_flip")),
    )
    assert bool(out["valid"][1:][torch.from_numpy(s["patch_valid"])].all())


def test_live_pool_ring_capacity():
    pool = LivePool(patch_size=8, capacity_per_cat=3)
    for i in range(5):
        pool.add(0, np.full((8, 8, 4), i, np.float32))
    assert pool.counts()[0] == 3
    with pool._lock:
        vals = [int(v[0, 0, 0]) for v in pool._store[0]]
    assert vals == [2, 3, 4]  # oldest retired


def test_patch_resize_matches_opencv():
    """Float RGBA crops resize as ``cv2.resize`` (bilinear, half-pixel
    centers) does; 1e-3 of the 0..255 range covers OpenCV's float rounding."""
    rgba = (np.random.RandomState(0).rand(23, 17, 4) * 255).astype(np.float32)
    for size in (8, 16, 40):
        got = torch_orch._resize_bilinear(rgba, size)
        want = cv2.resize(rgba, (size, size))
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= 1e-3 * 255


PASTE_KEYS = ("patches", "patch_boxes", "patch_classes", "patch_valid", "patch_flip")
RESIZE_TOL = 1e-3 * 255  # F.interpolate against cv2.resize, float rounding only


def _pools(**kw):
    return jax_orch.LivePool(**kw), LivePool(**kw)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_live_pool_sampling_matches_jax_package(seed):
    """The same patches added to both pools (one category past its ring
    capacity), then the same generator seeds: boxes, classes, flips, validity
    and the patches picked are array-equal, draw after draw."""
    jpool, tpool = _pools(patch_size=8, capacity_per_cat=3, train_size=(96, 64), max_samples=6)
    rs = np.random.RandomState(seed)
    for cat in (5, 2, 9, 2, 2, 5, 2, 2):
        patch = rs.rand(8, 8, 4).astype(np.float64 if cat == 9 else np.float32) * 255
        jpool.add(cat, patch)
        tpool.add(cat, patch)
    assert jpool.counts() == tpool.counts() == {5: 2, 2: 3, 9: 1}
    assert jpool.total_added == tpool.total_added == 8
    for c in jpool.counts():
        for a, b in zip(jpool._store[c], tpool._store[c]):  # ring order
            assert a.dtype == b.dtype == np.float32
            np.testing.assert_array_equal(a, b)
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    drew = False
    for _ in range(6):
        js = jpool.make_paste_sample(jrng, max_pastes=4, flip_prob=0.3)
        ts = tpool.make_paste_sample(trng, max_pastes=4, flip_prob=0.3)
        assert set(js) == set(ts) == set(PASTE_KEYS)
        for key in PASTE_KEYS:
            assert js[key].dtype == ts[key].dtype
            np.testing.assert_array_equal(js[key], ts[key])
        drew = drew or bool(ts["patch_valid"].any())
    assert drew
    # both generators were advanced alike
    assert jrng.integers(1 << 30) == trng.integers(1 << 30)


def test_live_pool_empty_matches_jax_package():
    jpool, tpool = _pools(patch_size=8)
    js = jpool.make_paste_sample(np.random.default_rng(0), max_pastes=3)
    ts = tpool.make_paste_sample(np.random.default_rng(0), max_pastes=3)
    for key in PASTE_KEYS:
        np.testing.assert_array_equal(js[key], ts[key])
    assert not ts["patch_valid"].any()


def varied_generate(cat, rng):
    return (rng.random((3, 40, 48, 3)) * 255).astype(np.uint8)


def varied_mask(images):
    """A rectangle per image whose corners depend on its pixels; the third
    image of a batch gets an empty mask."""
    m = np.zeros(images.shape[:3], bool)
    for i, img in enumerate(images):
        if i == 2:
            continue
        y0, x0 = int(img[0, 0, 0]) % 12, int(img[0, 1, 0]) % 12
        y1, x1 = 20 + int(img[0, 2, 0]) % 18, 22 + int(img[0, 3, 0]) % 24
        m[i, y0:y1, x0:x1] = True
    return m


def varied_score(images, masks, cat):
    """Scores on both sides of the threshold, from the pixels."""
    return np.array([0.3 + 0.4 * (int(img[1, 1, 1]) % 2) for img in images])


@pytest.mark.parametrize("seed,score_fn", [(0, varied_score), (7, varied_score), (3, None)])
def test_producer_matches_jax_package(seed, score_fn):
    """Both producers with the same callbacks and seed: equal produced and
    rejected counts and pool sizes, the pooled patches (crop to the mask's
    box, RGBA, resize to the patch size) within 1e-3 of the 0..255 range
    (OpenCV's resize against ``F.interpolate``), and paste samples drawn from
    both pools with one seed equal but for that tolerance on the patches."""
    jpool, tpool = _pools(patch_size=16, capacity_per_cat=4, train_size=(64, 64), max_samples=4)
    kw = dict(categories=[4, 1, 8], generate_fn=varied_generate, mask_fn=varied_mask,
              score_fn=score_fn, clip_threshold=0.5, area_range=(0.05, 0.9), seed=seed,
              max_rounds=3)
    jprod = jax_orch.InstanceProducer(jpool, **kw)
    tprod = InstanceProducer(tpool, **kw)
    for prod in (jprod, tprod):
        prod.start()
        prod.join(timeout=60)
        assert not prod.is_alive()
    assert (tprod.produced, tprod.rejected) == (jprod.produced, jprod.rejected)
    assert tprod.produced + tprod.rejected == 3 * 3 * 3
    assert tprod.produced > 0 and tprod.rejected >= 9  # the empty masks at least
    if score_fn is not None:
        assert tprod.rejected > 9  # and some scores below the threshold
    assert tpool.counts() == jpool.counts()
    assert tpool.total_added == jpool.total_added == tprod.produced
    for c, n in tpool.counts().items():
        assert n <= 4
        for a, b in zip(jpool._store[c], tpool._store[c]):
            assert a.shape == b.shape == (16, 16, 4)
            assert np.abs(a - b).max() <= RESIZE_TOL
            assert np.abs(a[..., 3] - b[..., 3]).max() <= 1e-3  # alpha in [0, 1]
    jrng, trng = np.random.default_rng(seed), np.random.default_rng(seed)
    for _ in range(4):
        js = jpool.make_paste_sample(jrng, max_pastes=3)
        ts = tpool.make_paste_sample(trng, max_pastes=3)
        assert np.abs(js["patches"] - ts["patches"]).max() <= RESIZE_TOL
        for key in PASTE_KEYS[1:]:
            np.testing.assert_array_equal(js[key], ts[key])
