"""The port's train data path against the JAX package's, on seeded inputs.

- samplers: the index streams equal for a seed, rank and world size;
- ``largest_component``: the native border following (``native/
  contours.cpp``) against the JAX function (``cv2.findContours`` +
  ``contourArea`` + ``fillPoly``) on 600 fuzzed masks with holes, nested
  components, one-pixel lines and equal-area ties: equal in every pixel; the
  contours themselves equal ``cv2.findContours``' points, in its order;
- ``InstPool``: equal selections for every strategy, ``load_rgba`` equal
  (the same decoded pixels, the same largest part), ``make_paste_sample``
  within float rounding (the float32 resize is ``F.interpolate`` against
  ``cv2.resize``: 1e-2 on the 0–255 range, 4e-5 of it);
- the train ``DatasetMapper`` and ``CopyPasteMapper`` on a synthetic LVIS
  train set and pool: boxes within 1e-5, polygon masks equal, RLE masks
  within 1e-4, the same patches from the pool within 1e-2; images (and the
  self-copy patches cut from them) within one level on at most 15 % of the
  pixels, since the port resizes uint8 images with ``F.interpolate``, one
  level from OpenCV's 11-bit fixed point on 10–15 % of them;
- ``TrainLoader``: the same batches in the same order; ``device_prefetch``
  on the CPU hands the batches out as tensors, integers as int64, strings on
  the host.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from divergen_tpu.config import get_cfg as jget
from divergen_tpu.data import copy_paste_mapper as jcpm
from divergen_tpu.data import dataset_mapper as jdm
from divergen_tpu.data import inst_pool as jpool
from divergen_tpu.data import loader as jloader
from divergen_tpu.data import samplers as jsamp
from divergen_tpu_torch import native as tnative
from divergen_tpu_torch.config import get_cfg as tget
from divergen_tpu_torch.data import copy_paste_mapper as tcpm
from divergen_tpu_torch.data import dataset_mapper as tdm
from divergen_tpu_torch.data import inst_pool as tpool
from divergen_tpu_torch.data import loader as tloader
from divergen_tpu_torch.data import samplers as tsamp
from divergen_tpu_torch.data.datasets.lvis import load_lvis_json
from divergen_tpu_torch.data.datasets.synthetic_lvis import write_training_root

torch.set_num_threads(1)


# -- samplers --------------------------------------------------------------------------

def take(it, n):
    it = iter(it)
    return [next(it) for _ in range(n)]


@pytest.mark.parametrize("rank,world", [(0, 1), (1, 3)])
def test_samplers_equal_streams(rank, world):
    rng = np.random.RandomState(0)
    recs = [{"annotations": [{"category_id": int(c)} for c in rng.randint(0, 12, rng.randint(0, 4))],
             "pos_category_ids": [int(c) for c in rng.randint(0, 12, rng.randint(0, 3))]}
            for _ in range(40)]
    rf = jsamp.repeat_factors_from_category_frequency(recs, 0.2)
    np.testing.assert_array_equal(tsamp.repeat_factors_from_category_frequency(recs, 0.2), rf)
    np.testing.assert_array_equal(tsamp.repeat_factors_from_tag_frequency(recs, 0.3),
                                  jsamp.repeat_factors_from_tag_frequency(recs, 0.3))
    kw = dict(seed=5, rank=rank, world_size=world)
    pairs = [
        (jsamp.TrainingSampler(40, **kw), tsamp.TrainingSampler(40, **kw)),
        (jsamp.TrainingSampler(40, shuffle=False, **kw), tsamp.TrainingSampler(40, shuffle=False, **kw)),
        (jsamp.RepeatFactorTrainingSampler(rf, **kw), tsamp.RepeatFactorTrainingSampler(rf, **kw)),
        (jsamp.MultiDatasetSampler([25, 15], [1.0, 3.0], rf, chunk=64, **kw),
         tsamp.MultiDatasetSampler([25, 15], [1.0, 3.0], rf, chunk=64, **kw)),
    ]
    for j, t in pairs:
        assert take(t, 150) == take(j, 150)
    j, t = jsamp.InferenceSampler(41, rank, world), tsamp.InferenceSampler(41, rank, world)
    assert list(t) == list(j) and len(t) == len(j)


# -- largest_component -----------------------------------------------------------------

def fuzzed_mask(rng: np.random.RandomState, kind: int) -> np.ndarray:
    h, w = rng.randint(1, 48, 2)
    m = np.zeros((h, w), np.uint8)
    if kind == 0:  # speckle
        m[:] = rng.rand(h, w) > rng.uniform(0.3, 0.9)
    elif kind == 1:  # blocks, some cut out of others (holes, nesting)
        for _ in range(rng.randint(1, 7)):
            y0, x0 = rng.randint(0, h), rng.randint(0, w)
            y1, x1 = min(h, y0 + rng.randint(1, 14)), min(w, x0 + rng.randint(1, 14))
            m[y0:y1, x0:x1] = 1 - m[y0:y1, x0:x1] if rng.rand() < 0.5 else 1
    elif kind == 2:  # one-pixel lines, broken
        for _ in range(rng.randint(1, 5)):
            if rng.rand() < 0.5:
                m[rng.randint(0, h), :] = 1
            else:
                m[:, rng.randint(0, w)] = 1
        m[rng.rand(h, w) > 0.9] = 0
    elif kind == 3:  # concentric rings: components inside holes
        for r in range(rng.randint(0, 3), min(h, w) // 2, 2):
            m[r:h - r, r:w - r] = 1 - m[r:h - r, r:w - r]
        m[rng.rand(h, w) > 0.95] ^= 1
    else:  # equal-area ties: the same block at several places
        bh, bw = rng.randint(1, 6, 2)
        for _ in range(rng.randint(2, 5)):
            y, x = rng.randint(0, max(h - bh, 1)), rng.randint(0, max(w - bw, 1))
            m[y:y + bh, x:x + bw] = 1
    return m


def test_largest_component_equals_opencv():
    rng = np.random.RandomState(0)
    for trial in range(600):
        m = fuzzed_mask(rng, trial % 5)
        got, want = tpool.largest_component(m), jpool.largest_component(m)
        assert got.dtype == want.dtype == np.uint8
        np.testing.assert_array_equal(got, want, err_msg=f"trial {trial}")
        contours, _ = cv2.findContours(m.copy(), cv2.RETR_EXTERNAL, cv2.CHAIN_APPROX_SIMPLE)
        ours = tnative.external_contours(m)
        assert len(ours) == len(contours), trial
        for a, b in zip(ours, contours):
            np.testing.assert_array_equal(a, b.reshape(-1, 2))
            assert tnative.contour_area(a) == cv2.contourArea(b)


def test_largest_component_cases():
    empty = np.zeros((5, 7), np.uint8)
    np.testing.assert_array_equal(tpool.largest_component(empty), empty)
    ring = np.zeros((9, 9), np.uint8)
    ring[1:8, 1:8] = 1
    ring[3:6, 3:6] = 0
    ring[4, 4] = 1  # inside the hole: never traced, filled with the ring
    out = tpool.largest_component(ring)
    assert out[1:8, 1:8].all() and out.sum() == 49
    line = np.zeros((6, 12), np.uint8)
    line[2, 1:11] = 1  # area 0 against a 2 x 2 block's 1
    line[4:6, 0:2] = 1
    out = tpool.largest_component(line)
    assert out[4:6, 0:2].all() and out.sum() == 4
    np.testing.assert_array_equal(out, jpool.largest_component(line))


# -- the synthetic training data, the pool and the mappers -----------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("synth"))
    files = write_training_root(root, 40, [(64, 48), (48, 64), (50, 33), (102, 68)] * 2,
                                [(64, 48)] * 2, 26, 8, seed=3)
    files["records"] = load_lvis_json(files["train"]["json_file"], os.path.join(root, "coco"))
    return files


def test_synthetic_root(synth):
    info = json.load(open(synth["cat_info"]))
    assert len(info) == 40 and {c["frequency"] for c in info} == {"r", "c", "f"}
    assert all(c["image_count"] >= 1 for c in info)
    pool = json.load(open(synth["pool"]["json_file"]))
    entries = [e for v in pool.values() for e in v]
    assert len(pool) == 8 and len(entries) == 26 and sum("|" in e for e in entries) == 5
    recs = synth["records"]
    assert len(recs) == 8 and all(os.path.exists(r["file_name"]) for r in recs)
    kinds = {isinstance(a["segmentation"], dict) for r in recs for a in r["annotations"]}
    assert kinds == {True, False}  # polygons and RLEs


def pool_args(synth, **kw):
    return dict(json_file=synth["pool"]["json_file"], image_root=synth["pool"]["image_root"],
                train_size=(96, 96), max_samples=6, patch_size=24,
                cat_freq_path=synth["cat_info"], mean_std2_path=synth["pool"]["area_prior"], **kw)


def test_inst_pool(synth):
    jp, tp = jpool.InstPool(**pool_args(synth)), tpool.InstPool(**pool_args(synth))
    assert tp.dataset == jp.dataset and tp.per_cat_pool == jp.per_cat_pool
    groups = {"r": {0, 3, 6}, "c": {1, 4, 7}, "f": {2, 5}}
    matrix = np.random.RandomState(4).rand(40, 40)
    for p in (jp, tp):
        p.set_freq_groups(groups)
        p.set_transition_matrix(matrix)
    for strategy in ("random", "cas_random", "cats_random", "rare_random", "com_random",
                     "fre_random", "rare_and_common_random", "rcf_random", "prob_random",
                     "binary_prob_random", "one_class_random"):
        for seed in range(3):
            kw = dict(cids=[1, 2, 5], label_set=[0, 4, 9])
            want = jp.sample_ids(np.random.default_rng(seed), 7, strategy, **kw)
            got = tp.sample_ids(np.random.default_rng(seed), 7, strategy, **kw)
            assert [int(i) for i in got] == [int(i) for i in want], strategy
    decoded = 0
    for idx in range(len(jp.dataset)):
        want, got = jp.load_rgba(idx), tp.load_rgba(idx)
        assert (got is None) == (want is None), jp.dataset[idx]
        if want is not None:
            decoded += 1
            np.testing.assert_array_equal(got, want)
    broken = [i for i, e in enumerate(tp.dataset) if e.endswith("_broken.png")]
    assert decoded >= 15 and len(broken) == 1 and tp.load_rgba(broken[0]) is None
    for seed in range(4):
        for random_scale in (False, True):
            kw = dict(random_scale=random_scale, order_seed=seed)
            jq, tq = jpool.InstPool(**pool_args(synth, **kw)), tpool.InstPool(**pool_args(synth, **kw))
            want = jq.make_paste_sample(np.random.default_rng(seed), 5, "cas_random")
            got = tq.make_paste_sample(np.random.default_rng(seed), 5, "cas_random")
            for k, w in want.items():
                if w.dtype.kind in "US":
                    assert (got[k] == w).all(), k
                else:
                    np.testing.assert_allclose(got[k], w, atol=POOL_TOL if k == "patches" else 0,
                                               err_msg=k)


def mapper_cfgs(synth, **keys):
    keys = dict({"INPUT.TRAIN_SIZE": 96, "DATALOADER.MAX_INSTANCES": 6,
                 "DATALOADER.MAX_PASTES": 4, "DATALOADER.PATCH_SIZE": 24,
                 "MODEL.ROI_HEADS.NUM_CLASSES": 40, "INPUT.PASTE_MAX_INST": 6}, **keys)
    out = []
    for get in (jget, tget):
        cfg = get()
        cfg.merge_from_file("configs/DiverGen_swinL.yaml")
        cfg.merge_from_list(synth["overrides"][:8] + [x for kv in keys.items() for x in kv])
        out.append(cfg)
    return out


def compare_samples(got, want, images):
    for k, w in want.items():
        if k == "image_id":
            assert got[k] == w
        elif k == "tfms":
            continue
        elif k == "gt":
            for g in w:
                tol = 1e-4 if g == "masks" else 1e-5 if g == "boxes" else 0
                np.testing.assert_allclose(got["gt"][g], w[g], atol=tol, err_msg=g)
        elif w.dtype.kind in "US":
            assert (got[k] == w).all(), k
        elif k == "image":
            diff = np.abs(got[k].astype(np.float64) - w)
            assert diff.max() <= 1.0, k
            images.append((diff > 0).mean())
        elif k == "patches":
            # pool patches: the float32 resize; self-copy patches are cut
            # from the resized uint8 image, so one level off where it is
            scp = np.char.startswith(want["patch_filenames"].astype(str), "scp:")
            diff = np.abs(got[k].astype(np.float64) - w).max(axis=(1, 2, 3))
            assert (diff <= np.where(scp, 1.0 + POOL_TOL, POOL_TOL)).all(), diff
        else:
            np.testing.assert_allclose(got[k], w, atol=1e-5, err_msg=k)


# cv2.resize and F.interpolate in float32: sums in another order
POOL_TOL = 1e-2


@pytest.mark.parametrize("method", ["syn_copy", "self_copy", "both", "p:0.3"])
def test_copy_paste_mapper(synth, method):
    keys = {"INPUT.COPY_METHOD": method, "INPUT.USE_RFS": method == "both",
            "INPUT.SELF_COPY_MODE": "cas" if method == "p:0.3" else "random",
            "INPUT.RC_ONLY": method == "self_copy", "INPUT.BLANK_RATIO": 0.3}
    jcfg, tcfg = mapper_cfgs(synth, **keys)
    jm = jcpm.CopyPasteMapper(jdm.DatasetMapper(jcfg, True), jcfg)
    tm = tcpm.CopyPasteMapper(tdm.DatasetMapper(tcfg, True), tcfg)
    recs = synth["records"]
    jm.set_dataset(recs)
    tm.set_dataset(recs)
    assert len(tm.dataset) == len(jm.dataset) and tm.per_cat_map == jm.per_cat_map
    image_off = []
    for i, rec in enumerate(recs):
        want, got = jm(rec, np.random.default_rng(i)), tm(rec, np.random.default_rng(i))
        assert set(got) == set(want)
        compare_samples(got, want, image_off)
    assert max(image_off) <= 0.15, image_off


def test_train_dataset_mapper_sem_seg_and_flip(synth):
    keys = {"MODEL.ROI_MASK_HEAD.SEM_SEG_ON": True, "INPUT.CUSTOM_AUG": "ResizeShortestEdge",
            "INPUT.MIN_SIZE_TRAIN": (72,), "INPUT.MAX_SIZE_TRAIN": 96}
    jcfg, tcfg = mapper_cfgs(synth, **keys)
    jm, tm = jdm.DatasetMapper(jcfg, True), tdm.DatasetMapper(tcfg, True)
    off = []
    for i, rec in enumerate(synth["records"]):
        want, got = jm(rec, np.random.default_rng(i)), tm(rec, np.random.default_rng(i))
        compare_samples(got, want, off)
        assert got["gt"]["valid"].any()
    assert max(off) <= 0.15
    # polygon masks rasterize to the same pixels
    box = np.array([3.2, 4.7, 40.1, 33.3], np.float32)
    poly = [[5.0, 6.0, 38.5, 9.1, 30.2, 32.0, 8.8, 25.5]]
    np.testing.assert_array_equal(tdm.rasterize_box_frame(poly, box, 28),
                                  jdm.rasterize_box_frame(poly, box, 28))


def test_unported_augmentations_raise(synth):
    for key in ("INPUT.USE_COLOR_JITTER", "INPUT.USE_INSTABOOST", "INPUT.USE_INP_ROTATE"):
        _, tcfg = mapper_cfgs(synth, **{key: True})
        with pytest.raises(NotImplementedError, match="not yet ported"):
            tcpm.CopyPasteMapper(tdm.DatasetMapper(tcfg, True), tcfg)


# -- the loader ------------------------------------------------------------------------

def test_train_loader_same_batches(synth):
    jcfg, tcfg = mapper_cfgs(synth, **{"INPUT.COPY_METHOD": "syn_copy"})
    recs = synth["records"]
    recs_missing = recs + [dict(recs[0], file_name=recs[0]["file_name"] + ".missing.png")]
    batches = []
    for cfg, cpm, dm, samp, lmod in ((jcfg, jcpm, jdm, jsamp, jloader),
                                     (tcfg, tcpm, tdm, tsamp, tloader)):
        mapper = cpm.CopyPasteMapper(dm.DatasetMapper(cfg, True), cfg)
        mapper.set_dataset(recs)
        loader = lmod.TrainLoader(recs_missing, mapper, samp.TrainingSampler(len(recs_missing), seed=2),
                                  batch_size=3, num_workers=2, seed=7)
        it = iter(loader)
        batches.append([next(it) for _ in range(4)])
        loader.stop()
    for want, got in zip(*batches):
        assert list(got["image_ids"]) == list(want["image_ids"])
        assert sorted(got) == sorted(want)
        off = []
        for k in want:
            if k in ("tfms", "image_ids"):
                continue
            if k == "gt":
                for g in want["gt"]:
                    np.testing.assert_allclose(got["gt"][g], want["gt"][g],
                                               atol=1e-4 if g == "masks" else 1e-5, err_msg=g)
            elif want[k].dtype.kind in "US":
                assert (got[k] == want[k]).all()
            elif k == "image":
                diff = np.abs(got[k] - want[k])
                assert diff.max() <= 1.0
                off.append((diff > 0).mean())
            else:
                np.testing.assert_allclose(got[k], want[k], atol=POOL_TOL, err_msg=k)
        assert max(off) <= 0.15


def test_device_prefetch_on_cpu():
    batches = [{"image": np.full((2, 4, 4, 3), i, np.float32),
                "image_size": np.array([[4, 4], [3, 2]], np.int32),
                "gt": {"classes": np.array([[1, 2]], np.int32), "valid": np.array([[True, False]])},
                "patch_filenames": np.array([["a.png", ""]], dtype="<U8"),
                "tfms": [None, None], "image_ids": np.array([7, 8])} for i in range(4)]
    out = list(tloader.device_prefetch(iter(batches), size=2, device="cpu"))
    assert [float(b["image"][0, 0, 0, 0]) for b in out] == [0.0, 1.0, 2.0, 3.0]
    b = out[1]
    assert b["image_size"].dtype == torch.int64 and b["gt"]["classes"].dtype == torch.int64
    assert b["gt"]["valid"].dtype == torch.bool and isinstance(b["patch_filenames"], np.ndarray)
    assert b["tfms"] == [None, None] and list(b["image_ids"]) == [7, 8]
