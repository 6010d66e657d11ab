"""The port's data augmentations against the JAX modules: the same seeded
record (a JPEG written here with ``cv2.imencode``, polygon instances of
frequency-bucketed classes) and the same ``np.random.Generator`` seed go
through both.

``PhotoMetricDistortion``, ``InstaBoost`` (``get_new_data`` with and without
the heatmap placement, and the record wrapper), ``inp_rotate_sample``,
``poisson_edit`` / ``blend_image_host`` and the copy-paste mapper with
``USE_COLOR_JITTER``, ``USE_INSTABOOST`` (src / dst / both) and
``USE_INP_ROTATE`` on. Boxes, classes, validity and the random draws agree
exactly; masks on at least 99.9 % of pixels; images exactly (the OpenCV
copies they go through are bit exact, ``tests/test_torch_imgproc.py``), float
patches to 1e-5 of their range (the float resize). The canvas is 128 with
``SCALE_RANGE`` (1, 1), so the mapper's own resize is the identity in both
packages.
"""
import copy
import json

import cv2
import numpy as np
import pytest
import torch

from divergen_tpu.config import get_cfg as jget_cfg
from divergen_tpu.data import color_jitter as jcj
from divergen_tpu.data import copy_paste_mapper as jcp
from divergen_tpu.data import dataset_mapper as jdm
from divergen_tpu.data import inp_rotate as jir
from divergen_tpu.data import instaboost as jib
from divergen_tpu.data import poisson_blend as jpb
from divergen_tpu_torch.config import get_cfg as tget_cfg
from divergen_tpu_torch.data import color_jitter as tcj
from divergen_tpu_torch.data import copy_paste_mapper as tcp
from divergen_tpu_torch.data import dataset_mapper as tdm
from divergen_tpu_torch.data import inp_rotate as tir
from divergen_tpu_torch.data import instaboost as tib
from divergen_tpu_torch.data import poisson_blend as tpb

torch.set_num_threads(1)

FREQ = "rcf"
CID_TO_FREQ = {c: FREQ[c % 3] for c in range(6)}


def smooth(rng, h, w):
    grid = rng.random((h // 16, w // 16, 3)).astype(np.float32) * 255
    img = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC) + rng.normal(0, 5, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Four 128 x 128 JPEGs, each with three filled polygon instances."""
    tmp = tmp_path_factory.mktemp("augment")
    rng = np.random.default_rng(0)
    out = []
    for i in range(4):
        img = smooth(rng, 128, 128)
        anns = []
        for k in range(3):
            cx, cy = rng.uniform(30, 98, 2)
            r = float(rng.uniform(10, 25))
            ang = np.sort(rng.uniform(0, 2 * np.pi, 6))
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
            colour = tuple(int(v) for v in rng.integers(0, 256, 3))
            cv2.fillPoly(img, [np.round(pts).astype(np.int32)], colour)
            (x0, y0), (x1, y1) = pts.min(0), pts.max(0)
            anns.append({"bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "category_id": (k + i) % 5, "area": float((x1 - x0) * (y1 - y0)),
                         "segmentation": [pts.reshape(-1).tolist()]})
        path = str(tmp / f"im{i}.jpg")
        cv2.imwrite(path, cv2.cvtColor(img, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 90])
        out.append({"file_name": path, "image_id": i, "height": 128, "width": 128,
                    "annotations": anns})
    freq = str(tmp / "cat_freq.json")
    with open(freq, "w") as f:
        json.dump([{"id": c + 1, "frequency": FREQ[c % 3]} for c in range(6)], f)
    return out, freq


def cfg_pair(freq, **inputs):
    out = []
    for get_cfg in (jget_cfg, tget_cfg):
        cfg = get_cfg()
        cfg.INPUT.TRAIN_SIZE = 128
        cfg.INPUT.SCALE_RANGE = (1.0, 1.0)
        cfg.DATALOADER.MAX_INSTANCES = 8
        cfg.DATALOADER.MAX_PASTES = 3
        cfg.DATALOADER.PATCH_SIZE = 32
        cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH = freq
        cfg.INPUT.AREA_PRIOR_PATH = ""
        cfg.INPUT.INST_POOL = False
        for k, v in inputs.items():
            setattr(cfg.INPUT, k, v)
        out.append(cfg)
    return out


def assert_gt_equal(got, want):
    for k in ("boxes", "classes", "valid"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    agree = (got["masks"] >= 0.5) == (want["masks"] >= 0.5)
    assert agree.mean() >= 0.999, agree.mean()


def base_sample(records, freq, seed):
    jc, _ = cfg_pair(freq)
    return jdm.DatasetMapper(jc, True)(records[seed % len(records)], np.random.default_rng(seed))


@pytest.mark.parametrize("seed", range(6))
def test_photometric_distortion(records, seed):
    recs, freq = records
    sample = base_sample(recs, freq, seed)
    img = sample["image"]
    np.testing.assert_array_equal(
        tcj.PhotoMetricDistortion(CID_TO_FREQ).apply_img(img, np.random.default_rng(seed)),
        jcj.PhotoMetricDistortion(CID_TO_FREQ).apply_img(img, np.random.default_rng(seed)))
    for freq_filter in (("r", "c"), ("f",)):
        want = jcj.PhotoMetricDistortion(CID_TO_FREQ, freq_filter)(
            copy.deepcopy(sample), np.random.default_rng(seed))
        got = tcj.PhotoMetricDistortion(CID_TO_FREQ, freq_filter)(
            copy.deepcopy(sample), np.random.default_rng(seed))
        np.testing.assert_array_equal(got["image"], want["image"])


@pytest.mark.parametrize("hflag", [False, True], ids=["random", "heatmap"])
@pytest.mark.parametrize("seed", range(4))
def test_instaboost_get_new_data(records, seed, hflag):
    recs, _ = records
    rec = recs[seed]
    img = cv2.cvtColor(cv2.imread(rec["file_name"]), cv2.COLOR_BGR2RGB)
    kw = dict(action_prob=(1, 1, 0), color_prob=0.5, hflag=hflag)
    want_anns, want = jib.get_new_data(copy.deepcopy(rec["annotations"]), img,
                                      jib.InstaBoostConfig(**kw), np.random.default_rng(seed))
    got_anns, got = tib.get_new_data(copy.deepcopy(rec["annotations"]), img,
                                     tib.InstaBoostConfig(**kw), np.random.default_rng(seed))
    assert got_anns == want_anns
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tib._poly_mask(rec["annotations"], 128, 128),
                                  jib._poly_mask(rec["annotations"], 128, 128))


def test_instaboost_wrapper_on_a_jpeg_record(records):
    recs, _ = records
    cid = {c: FREQ[c % 3] for c in range(6)}
    for seed in range(4):
        rec = recs[seed]
        want = jib.InstaBoost(cid_to_freq=cid, apply_freq=("r", "c"), aug_ratio=0.7)(
            copy.deepcopy(rec), np.random.default_rng(seed))
        got = tib.InstaBoost(cid_to_freq=cid, apply_freq=("r", "c"), aug_ratio=0.7)(
            copy.deepcopy(rec), np.random.default_rng(seed))
        assert got["annotations"] == want["annotations"]
        assert ("image_new" in got) == ("image_new" in want)
        if "image_new" in want:
            np.testing.assert_array_equal(got["image_new"], want["image_new"])


@pytest.mark.parametrize("seed", range(4))
def test_inp_rotate_sample(records, seed):
    recs, freq = records
    sample = base_sample(recs, freq, seed)
    kw = dict(patch_size=32, max_pastes=4, angle_range=30.0)
    want = jir.inp_rotate_sample(copy.deepcopy(sample), np.random.default_rng(seed), **kw)
    got = tir.inp_rotate_sample(copy.deepcopy(sample), np.random.default_rng(seed), **kw)
    for k in ("patch_boxes", "patch_classes", "patch_valid", "patch_flip", "patch_angle"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert_gt_equal(got["gt"], want["gt"])
    assert np.abs(got["patches"] - want["patches"]).max() <= 1e-5 * 255
    np.testing.assert_array_equal(got["image"], want["image"])


def test_poisson_and_host_blends():
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 255, (24, 28, 3)).astype(np.float32)
    tgt = rng.uniform(0, 255, (24, 28, 3)).astype(np.float32)
    mask = np.zeros((24, 28), np.uint8)
    mask[5:17, 6:20] = 1
    mask[0:4, 0:3] = 1  # at the border
    np.testing.assert_array_equal(tpb.poisson_edit(src, tgt, mask), jpb.poisson_edit(src, tgt, mask))
    for method in ("possion", "alpha", "gaussian", "basic"):
        for dtype in (np.float32, np.uint8):
            s, t = src.astype(dtype), tgt.astype(dtype)
            np.testing.assert_array_equal(tpb.blend_image_host(t, s, mask, method),
                                          jpb.blend_image_host(t, s, mask, method), err_msg=method)


SWITCHES = {
    "color_jitter": dict(USE_COLOR_JITTER=True, COLOR_JITTER_FREQ=["r", "c"]),
    "instaboost_src": dict(USE_INSTABOOST=True, INSTABOOST_APPLY_TYPE="src"),
    "instaboost_dst": dict(USE_INSTABOOST=True, INSTABOOST_APPLY_TYPE="dst"),
    "instaboost_both": dict(USE_INSTABOOST=True, INSTABOOST_APPLY_TYPE="both"),
    "inp_rotate": dict(USE_INP_ROTATE=True, INP_ROTATE_PROB=0.6),
    "all_three": dict(USE_COLOR_JITTER=True, USE_INSTABOOST=True, INSTABOOST_APPLY_TYPE="both",
                      USE_INP_ROTATE=True, INP_ROTATE_PROB=0.5),
}


@pytest.mark.parametrize("switch", list(SWITCHES))
def test_copy_paste_mapper_switches(records, switch):
    recs, freq = records
    jc, tc = cfg_pair(freq, COPY_METHOD="self_copy", **SWITCHES[switch])
    jm = jcp.CopyPasteMapper(jdm.DatasetMapper(jc, True), jc)
    tm = tcp.CopyPasteMapper(tdm.DatasetMapper(tc, True), tc)
    jm.set_dataset(recs)
    tm.set_dataset(recs)
    _, tc0 = cfg_pair(freq, COPY_METHOD="self_copy")  # the same mapper, switches off
    plain = tcp.CopyPasteMapper(tdm.DatasetMapper(tc0, True), tc0)
    plain.set_dataset(recs)
    altered = 0  # samples the switch changed: it is on, not merely accepted
    for seed in range(4):
        want = jm(copy.deepcopy(recs[seed]), np.random.default_rng(seed))
        got = tm(copy.deepcopy(recs[seed]), np.random.default_rng(seed))
        base = plain(copy.deepcopy(recs[seed]), np.random.default_rng(seed))
        altered += int(any(not np.array_equal(got[k], base[k])
                           for k in ("image", "patches", "patch_angle")))
        assert sorted(got) == sorted(want)
        assert_gt_equal(got["gt"], want["gt"])
        for k in ("patch_boxes", "patch_classes", "patch_valid", "patch_flip", "patch_angle",
                  "patch_filenames", "image_size"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        # the self-copy crops go through data/transforms.py:resize_image (F.interpolate)
        assert np.abs(got["patches"] - want["patches"]).max() <= 1.0
        np.testing.assert_array_equal(got["image"], want["image"])
    assert altered >= 2, altered


def test_instaboost_apply_type_is_checked(records):
    _, freq = records
    _, tc = cfg_pair(freq, USE_INSTABOOST=True, INSTABOOST_APPLY_TYPE="everywhere")
    with pytest.raises(ValueError, match="INSTABOOST_APPLY_TYPE"):
        tcp.CopyPasteMapper(tdm.DatasetMapper(tc, True), tc)
