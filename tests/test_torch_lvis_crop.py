"""The port's filtration ``lvis_crop`` against the JAX CLI, and the pool reads
that take JPEG as ``cv2.imread`` does.

An LVIS-format root of JPEGs written here with ``cv2.imencode`` (polygon
annotations, one box too small to crop, one image file missing, several
annotations of one category to exercise ``--max_per_category``) goes through
both CLIs for every ``--crop_mode`` x ``--background``: the same files, the
same pixels (the JAX CLI writes BGR PNGs through OpenCV, the port RGB PNGs
through its codec; the 10 x 10 blur is exact). Then a pool entry
``image.jpg|mask.png`` loads in ``InstPool.load_rgba`` and ``clean_pool``
crops a JPEG image as in the JAX package.
"""
import json
import os

import cv2
import numpy as np
import pytest
import torch

from divergen_tpu.data import inst_pool as jpool
from divergen_tpu.pipeline.filteration import cli as jcli
from divergen_tpu_torch.data import inst_pool as tpool
from divergen_tpu_torch.pipeline.filteration import cli as tcli
from divergen_tpu_torch.utils.png import read_png, write_png

torch.set_num_threads(1)


def smooth(rng, h, w):
    grid = rng.random((max(h // 12, 2), max(w // 12, 2), 3)).astype(np.float32) * 255
    img = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC) + rng.normal(0, 6, (h, w, 3))
    return np.clip(img, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def lvis_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lvis")
    rng = np.random.default_rng(0)
    images, anns = [], []
    for i, (h, w) in enumerate([(96, 128), (75, 101), (64, 64)]):
        name = f"train2017/{i:012d}.jpg"
        os.makedirs(root / "train2017", exist_ok=True)
        cv2.imwrite(str(root / name), smooth(rng, h, w), [cv2.IMWRITE_JPEG_QUALITY, 88])
        images.append({"id": i + 1, "file_name": name, "height": h, "width": w})
        for k in range(3):
            cx, cy, r = rng.uniform(20, w - 20), rng.uniform(20, h - 20), rng.uniform(6, 18)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 7))
            pts = np.stack([cx + r * np.cos(ang), cy + r * np.sin(ang)], 1)
            (x0, y0), (x1, y1) = pts.min(0), pts.max(0)
            anns.append({"id": 100 + len(anns), "image_id": i + 1, "category_id": 1 + k % 2,
                         "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
                         "segmentation": [pts.reshape(-1).tolist()], "area": 1.0})
    anns.append({"id": 900, "image_id": 1, "category_id": 3, "bbox": [5.0, 5.0, 1.2, 30.0],
                 "segmentation": [[5, 5, 6, 5, 6, 35]], "area": 1.0})  # too thin: skipped
    images.append({"id": 9, "coco_url": "http://images.cocodataset.org/train2017/missing.jpg"})
    anns.append({"id": 901, "image_id": 9, "category_id": 2, "bbox": [0.0, 0.0, 9.0, 9.0],
                 "segmentation": [[0, 0, 9, 0, 9, 9]], "area": 1.0})  # no file: skipped
    path = root / "lvis_v1_train.json"
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": c} for c in (1, 2, 3)]}))
    return root, str(path)


def listing(d):
    return sorted(os.path.relpath(os.path.join(r, f), d) for r, _, fs in os.walk(d) for f in fs)


@pytest.mark.parametrize("background", ["white", "blur", "ori", "black"])
@pytest.mark.parametrize("crop_mode", ["tight", "square", "padding"])
def test_lvis_crop_matches_jax(tmp_path, lvis_root, crop_mode, background):
    root, js = lvis_root
    args = ["--lvis_json", js, "--image_root", str(root), "--crop_mode", crop_mode,
            "--background", background, "--padding_width", "7"]
    if crop_mode == "square":
        args += ["--max_per_category", "3"]
    assert jcli.lvis_crop(args + ["--out_dir", str(tmp_path / "jax")]) == 0
    assert tcli.lvis_crop(args + ["--out_dir", str(tmp_path / "torch")]) == 0
    names = listing(tmp_path / "jax")
    assert names == listing(tmp_path / "torch") and len(names) >= 6
    assert "3/900.png" not in names and "2/901.png" not in names
    for name in names:
        want = cv2.cvtColor(cv2.imread(str(tmp_path / "jax" / name)), cv2.COLOR_BGR2RGB)
        np.testing.assert_array_equal(read_png(str(tmp_path / "torch" / name)), want, name)


def test_pool_reads_jpeg_image_with_png_mask(tmp_path):
    """An ``img|mask`` pool entry whose image is a JPEG loads as in the JAX
    pool, which reads both through cv2.imread."""
    rng = np.random.default_rng(1)
    img = smooth(rng, 40, 52)
    cv2.imwrite(str(tmp_path / "a.jpg"), img, [cv2.IMWRITE_JPEG_QUALITY, 90])
    mask = np.zeros((40, 52), np.uint8)
    mask[8:30, 10:44] = 255
    write_png(str(tmp_path / "a_mask.png"), mask)
    pool_json = tmp_path / "pool.json"
    pool_json.write_text(json.dumps({"1": ["a.jpg|a_mask.png"]}))
    kw = dict(json_file=str(pool_json), image_root=str(tmp_path), train_size=(64, 64),
              max_samples=2, patch_size=16)
    want = jpool.InstPool(**kw).load_rgba(0)
    got = tpool.InstPool(**kw).load_rgba(0)
    assert want is not None
    np.testing.assert_array_equal(got, want)


def test_clean_pool_crops_a_jpeg_image(tmp_path):
    rng = np.random.default_rng(2)
    (tmp_path / "img" / "apple").mkdir(parents=True)
    (tmp_path / "mask" / "apple").mkdir(parents=True)
    for i in range(2):
        name = f"7_{i:07d}"
        cv2.imwrite(str(tmp_path / "img" / "apple" / f"{name}.jpg"), smooth(rng, 36, 44),
                    [cv2.IMWRITE_JPEG_QUALITY, 90])
        mask = np.zeros((36, 44), np.uint8)
        mask[5 + i:30, 6:40 - i] = 255
        cv2.imwrite(str(tmp_path / "mask" / "apple" / f"{name}.png"), mask)
    scores = {f"apple/7_{i:07d}.jpg": {"clip_score": 0.3, "mask_area": 0.5} for i in range(2)}
    (tmp_path / "scores.json").write_text(json.dumps(scores))
    for cli, out in ((jcli, "jax"), (tcli, "torch")):
        assert cli.clean_pool(["--image_dir", str(tmp_path / "img"), "--mask_dirs",
                               str(tmp_path / "mask"), "--score_jsons",
                               str(tmp_path / "scores.json"), "--out_dir", str(tmp_path / out),
                               "--out_json", str(tmp_path / out / "pool.json")]) == 0
    for i in range(2):
        rel = os.path.join("apple", f"7_{i:07d}.png")
        want = cv2.imread(str(tmp_path / "jax" / rel), cv2.IMREAD_UNCHANGED)
        np.testing.assert_array_equal(read_png(str(tmp_path / "torch" / rel)),
                                      cv2.cvtColor(want, cv2.COLOR_BGRA2RGBA))
