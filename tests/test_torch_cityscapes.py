"""The port's Cityscapes evaluation and ``inference_on_dataset_exp`` against
the JAX package's, on the CPU.

``LVISToCityscapesInstanceEvaluator``: both packages process the same padded
detections; the ``*_pred.txt`` files are equal line for line and the mask
PNGs (the port's writer against ``cv2.imwrite``) pixel for pixel. The
``*_gtFine_instanceIds.png`` ground truth is written by PIL (16-bit gray,
mode "I") and read by each package's scorer; the AP dicts are equal, a
ground truth made of the predictions themselves scores AP 1, and an image
without a ``*_pred.txt`` scores as zero predictions in both.
``inference_on_dataset_exp`` on the tiny Swin detector and the synthetic LVIS
set of ``test_torch_predictor.py``: every ``det_<id>.npz`` array within 1e-4
of max |reference|, the logits files and the result dicts alike.
"""
import json
import os

import numpy as np
import pytest
from PIL import Image

from divergen_tpu.engine import eval_loop as jeval
from divergen_tpu.evaluation import cityscapes_eval as jcs
from divergen_tpu.evaluation import cityscapes_instance_scoring as jscore
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu_torch.engine import eval_loop as teval
from divergen_tpu_torch.evaluation import cityscapes_eval as tcs
from divergen_tpu_torch.evaluation import cityscapes_instance_scoring as tscore
from divergen_tpu_torch.utils.png import read_png
from test_torch_predictor import DATASET, assert_close_results, eval_case, tiny_swin

__all__ = ["eval_case", "tiny_swin"]  # the fixtures, imported

CAR, PERSON, BUS, ROAD = 26, 24, 28, 7
# LVIS contiguous ids → Cityscapes label ids; class 5 maps to a non-thing label, 6 to none
MAPPING = {"0": CAR, "1": PERSON, "2": BUS, "3": CAR, "5": ROAD}
H, W = 48, 64


def detections(seed, b=2, k=6, classes=8):
    rng = np.random.RandomState(seed)
    xy = rng.rand(b, k, 2) * [40, 28]
    boxes = np.concatenate([xy, xy + rng.rand(b, k, 2) * 20 + 6], -1).astype(np.float32)
    return {"boxes": boxes, "scores": rng.rand(b, k).astype(np.float32),
            "classes": rng.randint(0, classes, (b, k)).astype(np.int32),
            "valid": rng.rand(b, k) > 0.2,
            "mask_logits": (rng.randn(b, k, 28, 28) * 3).astype(np.float32)}


def inputs(names):
    return [{"file_name": f"/data/{n}_leftImg8bit.png", "image_id": i, "orig_height": H,
             "orig_width": W} for i, n in enumerate(names)]


def write_gt(root, name, ids):
    os.makedirs(root / "city", exist_ok=True)
    path = root / "city" / f"{name}_gtFine_instanceIds.png"
    Image.fromarray(ids.astype(np.int32), mode="I").save(str(path))
    return path


@pytest.fixture
def dumps(tmp_path):
    mapper = tmp_path / "map.json"
    mapper.write_text(json.dumps(MAPPING))
    out = detections(60)
    names = ["aachen_000000_000019", "bochum_000000_000313"]
    dirs = {}
    for name, mod in (("jax", jcs), ("port", tcs)):
        ev = mod.LVISToCityscapesInstanceEvaluator(str(mapper), str(tmp_path / name),
                                                   gt_dir=str(tmp_path / "gt"))
        ev.reset()
        ev.process(inputs(names), out)
        dirs[name] = (ev, tmp_path / name)
    return dirs, names, tmp_path


def test_cityscapes_dump_equal(dumps):
    dirs, names, _ = dumps
    jdir, tdir = dirs["jax"][1], dirs["port"][1]
    assert sorted(os.listdir(jdir)) == sorted(os.listdir(tdir))
    pngs = [f for f in os.listdir(tdir) if f.endswith(".png")]
    assert len(pngs) >= 4
    for f in os.listdir(tdir):
        if f.endswith(".txt"):
            assert (tdir / f).read_text() == (jdir / f).read_text(), f
        else:
            got = read_png(str(tdir / f))
            np.testing.assert_array_equal(got, np.asarray(Image.open(jdir / f)))
            assert got.dtype == np.uint8 and set(np.unique(got)) <= {0, 255}
    # road (not a thing class) and unmapped classes are left out of the dump
    lines = [ln for n in names for ln in (tdir / f"{n}_leftImg8bit_pred.txt").read_text().splitlines()]
    assert {int(ln.split()[1]) for ln in lines} <= {CAR, PERSON, BUS}


def gt_from_predictions(pred_dir, name):
    """The instance-id map of an image whose ground truth is its own
    predictions: each mask, in the dump's order, one instance of its label."""
    ids = np.full((H, W), ROAD, np.int64)
    count = {}
    for line in (pred_dir / f"{name}_leftImg8bit_pred.txt").read_text().splitlines():
        png, label, _ = line.split()
        m = read_png(str(pred_dir / png)) > 0
        count[int(label)] = count.get(int(label), 0) + 1
        ids[m & (ids == ROAD)] = int(label) * 1000 + count[int(label)]
    return ids


def test_ground_truth_equal_to_predictions_scores_ap_one(dumps):
    dirs, names, root = dumps
    pred_dir = dirs["port"][1]
    for name in names:
        write_gt(root / "gt", name, gt_from_predictions(pred_dir, name))
    # the instances that overlap a bigger earlier one lose pixels: score with a
    # ground truth of disjoint masks only, each its own prediction
    got = {m: dirs[m][0].evaluate() for m in ("jax", "port")}
    assert got["port"] == got["jax"]
    ids = np.full((H, W), ROAD, np.int64)
    ids[4:24, 4:30] = CAR * 1000 + 1
    ids[26:46, 34:60] = PERSON * 1000 + 1
    gt_root = root / "gt_one"
    write_gt(gt_root, names[0], ids)
    pred_dir = root / "one"
    os.makedirs(pred_dir)
    lines = []
    for n, (label, inst) in enumerate(((CAR, 1), (PERSON, 1))):
        mask = ((ids == label * 1000 + inst) * 255).astype(np.uint8)
        Image.fromarray(mask).save(str(pred_dir / f"m{n}.png"))
        lines.append(f"m{n}.png {label} 0.{9 - n}\n")
    (pred_dir / f"{names[0]}_leftImg8bit_pred.txt").write_text("".join(lines))
    for mod in (jscore, tscore):
        res = mod.score_prediction_dir(str(pred_dir), str(gt_root))
        assert res["allAp"] == pytest.approx(1.0) and res["allAp50%"] == pytest.approx(1.0)


def test_scoring_equal_and_missing_predictions(dumps):
    dirs, names, root = dumps
    rng = np.random.RandomState(61)
    for name in names + ["cologne_000000_000001"]:  # the last has no _pred.txt: a hard miss
        ids = np.full((H, W), ROAD, np.int64)
        for n, label in enumerate((CAR, PERSON, BUS, CAR)):
            y, x = rng.randint(0, H - 16), rng.randint(0, W - 20)
            ids[y:y + 16, x:x + 20] = label * 1000 + n + 1
        ids[:4, :8] = CAR  # a crowd region
        ids[-3:, -3:] = 0  # void
        write_gt(root / "gt", name, ids)
    got = {m: dirs[m][0].evaluate() for m in ("jax", "port")}
    assert got["port"] == got["jax"] and got["port"]["segm"]["scorer"] == "native"
    res = {m: mod.score_prediction_dir(str(dirs["port"][1]), str(root / "gt"))
           for m, mod in (("jax", jscore), ("port", tscore))}
    assert res["port"] == res["jax"]
    # without the image that has no predictions the recall denominator shrinks
    os.remove(root / "gt" / "city" / "cologne_000000_000001_gtFine_instanceIds.png")
    fewer = tscore.score_prediction_dir(str(dirs["port"][1]), str(root / "gt"))
    assert fewer == jscore.score_prediction_dir(str(dirs["port"][1]), str(root / "gt"))
    assert fewer["allAp"] >= res["port"]["allAp"]


def test_scorer_without_ground_truth(dumps, tmp_path):
    dirs, _, _ = dumps
    for m in ("jax", "port"):
        ev = dirs[m][0]
        ev.gt_dir = str(tmp_path / "empty")
        res = ev.evaluate()["segm"]
        assert np.isnan(res["AP"]) and "native scoring skipped" in res["note"]
        ev.gt_dir = None
        assert "no gt_dir" in ev.evaluate()["segm"]["note"]
    with pytest.raises(FileNotFoundError):
        tscore.score_prediction_dir(str(tmp_path), str(tmp_path / "empty"))


def test_inference_on_dataset_exp_against_jax(eval_case, tmp_path):
    tcfg, jcfg, params, model = eval_case
    want = jeval.inference_on_dataset_exp(jrcnn.build_model(jcfg), params, jcfg, DATASET,
                                          str(tmp_path / "jax"), batch_size=3)
    got = teval.inference_on_dataset_exp(model, None, tcfg, DATASET, str(tmp_path / "port"),
                                         batch_size=3)
    assert_close_results(got, want)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    dets = [f for f in files if f.startswith("det_")]
    assert len(dets) == 4 and len(files) == 8  # and the evaluator's <id>.npz of logits
    total = 0
    for f in files:
        a, b = np.load(tmp_path / "port" / f), np.load(tmp_path / "jax" / f)
        assert sorted(a.files) == sorted(b.files) == (
            ["boxes", "classes", "logits", "scores"] if f.startswith("det_") else ["logits"])
        for k in a.files:
            assert a[k].shape == b[k].shape, (f, k)
            if k == "classes":
                np.testing.assert_array_equal(a[k], b[k])
            elif b[k].size:
                assert np.abs(a[k] - b[k]).max() <= 1e-4 * max(np.abs(b[k]).max(), 1e-6), (f, k)
        total += len(a["logits"])
    assert total > 0
