"""The port's ``clean_pool`` against the JAX CLI on a synthetic folder.

Generated PNG images of two categories, masks from two segmentation methods
(some at another size than their image, one empty, one missing), their CLIP
score jsons, a similarity keep list and a name → id map: both CLIs must write
the same pool JSON (paths relative to their output folders) and RGBA crops of
the same pixels. The JAX CLI reads and writes through OpenCV (BGR, BGRA), the
port through its PNG codec (RGB, RGBA).
"""
import csv
import json
import os

import cv2
import numpy as np
import pytest

from divergen_tpu.pipeline.filteration import cli as jcli
from divergen_tpu_torch.pipeline.filteration import cli as tcli
from divergen_tpu_torch.utils.png import read_png, write_png


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    root = tmp_path_factory.mktemp("gen")
    rng = np.random.RandomState(0)
    images = {("apple", f"7_{i:07d}.png"): (40 + 4 * i, 48 - 2 * i) for i in range(6)}
    images.update({("chair", f"11_{i:07d}.png"): (32, 36) for i in range(4)})
    scores = [{}, {}]
    for (cat, name), (h, w) in images.items():
        os.makedirs(root / "img" / cat, exist_ok=True)
        write_png(str(root / "img" / cat / name), rng.randint(0, 256, (h, w, 3), dtype=np.uint8))
        for m in range(2):
            key = f"{cat}/{name}"
            if (m, name) == (1, "7_0000005.png"):
                continue  # no mask of method 1: method 0 wins whatever its score
            d = root / f"mask{m}" / cat
            os.makedirs(d, exist_ok=True)
            # method 1 writes its masks at another size than the image
            mh, mw = (h, w) if m == 0 else (h // 2 + 3, w * 2 - 5)
            yy, xx = np.mgrid[:mh, :mw]
            cy, cx, r = rng.uniform(0.3, 0.7) * mh, rng.uniform(0.3, 0.7) * mw, 0.3 * min(mh, mw)
            mask = np.where((yy - cy) ** 2 + (xx - cx) ** 2 < r * r, 255, 0).astype(np.uint8)
            mask[rng.rand(mh, mw) < 0.05] = 127  # on the threshold: background
            mask[rng.rand(mh, mw) < 0.02] = 128
            if name == "11_0000003.png":
                mask[:] = 100  # empty: the image is dropped
            if name != "7_0000004.png" or m == 0:  # method 1's file is missing
                cv2.imwrite(str(d / name), mask)
            scores[m][key] = {"clip_score": float(rng.uniform(0.25, 0.4)),
                              "mask_area": float(rng.uniform(0.1, 0.9))}
    scores[0]["apple/7_0000000.png"]["clip_score"] = 0.15  # both under the threshold
    scores[1]["apple/7_0000000.png"]["clip_score"] = 0.19
    scores[0]["apple/7_0000001.png"].update(clip_score=0.5, mask_area=0.99)  # area too large
    scores[1]["apple/7_0000004.png"]["clip_score"] = 0.9  # best, but its mask is missing
    jsons = []
    for m, sc in enumerate(scores):
        jsons.append(str(root / f"scores{m}.json"))
        with open(jsons[-1], "w") as f:
            json.dump(sc, f)
    with open(root / "keep.csv", "w", newline="") as f:
        w = csv.writer(f)
        for cat, name in images:
            if name != "11_0000001.png":
                w.writerow([cat, name, 0.9])
    with open(root / "name2id.json", "w") as f:
        json.dump({"apple": 7}, f)  # chair keeps its folder name
    return root, jsons


def run(cli, root, jsons, tag, *extra):
    out = root / f"out_{tag}"
    argv = ["--image_dir", str(root / "img"), "--mask_dirs", str(root / "mask0"),
            str(root / "mask1"), "--score_jsons", *jsons, "--out_dir", str(out / "pool"),
            "--out_json", str(out / "pool.json"), "--workers", "2", *extra]
    assert cli.clean_pool(argv) == 0
    with open(out / "pool.json") as f:
        pool = json.load(f)
    return out, {k: [os.path.relpath(p, out) for p in v] for k, v in pool.items()}


@pytest.mark.parametrize("extra", [[], ["--similarity_csv", "keep.csv", "--name_to_id_json",
                                        "name2id.json"]])
def test_clean_pool_matches_jax_cli(folder, extra):
    root, jsons = folder
    extra = [str(root / e) if e.endswith((".csv", ".json")) else e for e in extra]
    tag = "sim" if extra else "plain"
    jout, jpool = run(jcli, root, jsons, f"jax_{tag}", *extra)
    tout, tpool = run(tcli, root, jsons, f"torch_{tag}", *extra)
    assert tpool == jpool
    kept = sum(len(v) for v in tpool.values())
    assert kept == (5 if extra else 6), tpool  # the filters above drop 4 of 10 (5 with the csv)
    for paths in tpool.values():
        for rel in paths:
            rgba = read_png(str(tout / rel))
            assert rgba.ndim == 3 and rgba.shape[2] == 4
            bgra = cv2.imread(str(jout / rel), cv2.IMREAD_UNCHANGED)
            np.testing.assert_array_equal(rgba, bgra[..., [2, 1, 0, 3]], err_msg=rel)
            assert (rgba[..., 3] > 127).any()


@pytest.mark.parametrize("src,dst", [((20, 30), (40, 48)), ((37, 91), (40, 44)), ((5, 5), (3, 17))])
def test_nearest_resize_matches_cv2(src, dst):
    mask = np.random.RandomState(1).randint(0, 256, src, dtype=np.uint8)
    want = cv2.resize(mask, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(tcli.resize_nearest_cv2(mask, *dst), want)
