"""The port's tar readers (``data/tar_dataset.py``) and
``CustomDatasetMapper`` against the JAX package's, on tars of JPEGs written
here with ``cv2.imencode`` (and one PNG member).

``build_tar_index`` gives the same (name, offset, size) rows, ``TarDataset``
and ``DiskTarDataset`` (with and without saved ``.npy`` indices) the same
pixels, and ``CustomDatasetMapper`` the same samples for tar-backed records,
'box' and 'image' annotation types and image-level labels. The canvas is the
images' own size with ``SCALE_RANGE`` (1, 1), so the resize is the identity
in both packages and the images are compared exactly.
"""
import io
import os
import tarfile

import cv2
import numpy as np
import pytest
import torch

from divergen_tpu.config import get_cfg as jget_cfg
from divergen_tpu.data import custom_dataset_mapper as jcdm
from divergen_tpu.data import tar_dataset as jtar
from divergen_tpu_torch.config import get_cfg as tget_cfg
from divergen_tpu_torch.data import custom_dataset_mapper as tcdm
from divergen_tpu_torch.data import tar_dataset as ttar

torch.set_num_threads(1)


def encode(img, ext=".jpg", *params):
    ok, buf = cv2.imencode(ext, cv2.cvtColor(img, cv2.COLOR_RGB2BGR), list(params))
    assert ok
    return buf.tobytes()


@pytest.fixture(scope="module")
def tars(tmp_path_factory):
    root = tmp_path_factory.mktemp("tars")
    rng = np.random.default_rng(0)
    paths = []
    for t in range(2):
        path = str(root / f"n0{t}.tar")
        with tarfile.open(path, "w") as tf:
            for k in range(3 + t):
                img = rng.integers(0, 256, (96, 128, 3)).astype(np.uint8)
                if (t, k) == (1, 2):
                    data, name = encode(img, ".png"), f"n0{t}_{k}.png"
                else:
                    data = encode(img, ".jpg", cv2.IMWRITE_JPEG_QUALITY, 70 + 10 * k)
                    name = f"n0{t}_{k}.JPEG"
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
            d = tarfile.TarInfo("subdir")
            d.type = tarfile.DIRTYPE
            tf.addfile(d)
        paths.append(path)
    return root, paths


def test_index_and_single_tar(tars):
    root, paths = tars
    for p in paths:
        want = jtar.build_tar_index(p, str(root / (os.path.basename(p) + ".j.npy")))
        got = ttar.build_tar_index(p, str(root / (os.path.basename(p) + ".npy")))
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(np.load(str(root / (os.path.basename(p) + ".npy"))), want)
        jd, td = jtar.TarDataset(p), ttar.TarDataset(p)
        assert len(td) == len(jd) >= 3
        for i in range(len(jd)):
            assert td.read_bytes(i) == jd.read_bytes(i)
            np.testing.assert_array_equal(td[i], jd[i])


@pytest.mark.parametrize("saved_index", [False, True])
def test_disk_tar_dataset(tars, saved_index):
    root, paths = tars
    index_dir = str(root) if saved_index else None
    jd, td = jtar.DiskTarDataset(paths, index_dir), ttar.DiskTarDataset(paths, index_dir)
    assert td.offsets == jd.offsets and len(td) == len(jd) == 7
    for i in range(len(jd)):
        np.testing.assert_array_equal(td[i], jd[i])


def cfg_pair(tarfile_list=None):
    out = []
    for get_cfg in (jget_cfg, tget_cfg):
        cfg = get_cfg()
        cfg.INPUT.TRAIN_SIZE = 128
        cfg.INPUT.SCALE_RANGE = (1.0, 1.0)
        cfg.DATALOADER.MAX_INSTANCES = 8
        cfg.DATALOADER.DATASET_ANN = ["box", "image"]
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 6
        if tarfile_list:
            cfg.DATALOADER.USE_TAR_DATASET = True
            cfg.DATALOADER.TARFILE_PATH = tarfile_list
            cfg.DATALOADER.TAR_INDEX_DIR = ""
        out.append(cfg)
    return out


def assert_samples_equal(got, want):
    assert sorted(got) == sorted(want)
    np.testing.assert_array_equal(got["image"], want["image"])
    np.testing.assert_array_equal(got["image_size"], want["image_size"])
    np.testing.assert_array_equal(got["image_labels"], want["image_labels"])
    assert (got["ann_type"], got["dataset_source"], got["image_id"]) == (
        want["ann_type"], want["dataset_source"], want["image_id"])
    for k in ("boxes", "classes", "valid", "masks"):
        np.testing.assert_array_equal(got["gt"][k], want["gt"][k], err_msg=k)


def test_custom_dataset_mapper(tars, tmp_path):
    root, paths = tars
    listing = str(tmp_path / "tar_files.npy")
    np.save(listing, np.array(paths))
    jc, tc = cfg_pair(listing)
    jm, tm = jcdm.CustomDatasetMapper(jc, True), tcdm.CustomDatasetMapper(tc, True)
    assert len(tm.tar_dataset) == len(jm.tar_dataset) == 7
    img = np.random.default_rng(5).integers(0, 256, (128, 96, 3)).astype(np.uint8)
    file_name = str(tmp_path / "coco.jpg")
    cv2.imwrite(file_name, cv2.cvtColor(img, cv2.COLOR_RGB2BGR), [cv2.IMWRITE_JPEG_QUALITY, 85])
    anns = [{"bbox": [10.0, 12.0, 40.0, 30.0], "category_id": 2,
             "segmentation": [[10, 12, 50, 12, 50, 42, 10, 42]]},
            {"bbox": [60.0, 70.0, 20.0, 25.0], "category_id": 4}]
    records = [
        {"tar_index": 3, "image_id": 77, "dataset_source": 1, "pos_category_ids": [2, 9]},
        {"tar_index": 6, "image_id": 78, "dataset_source": 0},
        {"file_name": file_name, "image_id": 5, "dataset_source": 0, "annotations": anns},
        {"file_name": file_name, "image_id": 6, "dataset_source": 1, "annotations": anns},
    ]
    for seed, rec in enumerate(records):
        want = jm(dict(rec), np.random.default_rng(seed))
        got = tm(dict(rec), np.random.default_rng(seed))
        assert_samples_equal(got, want)
    assert got["ann_type"] == "image" and not got["gt"]["valid"].any()
    assert got["image_labels"][[2, 4]].tolist() == [1.0, 1.0]
    # an explicit DiskTarDataset, as the JAX test passes one
    tm2 = tcdm.CustomDatasetMapper(tc, True, tar_dataset=ttar.DiskTarDataset(paths[:1]))
    jm2 = jcdm.CustomDatasetMapper(jc, True, tar_dataset=jtar.DiskTarDataset(paths[:1]))
    rec = dict(records[0], tar_index=1)
    assert_samples_equal(tm2(dict(rec), np.random.default_rng(0)),
                         jm2(dict(rec), np.random.default_rng(0)))
