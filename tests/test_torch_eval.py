"""The port's evaluation (``divergen_tpu_torch/evaluation``, ``data/catalog.py``,
``data/datasets/lvis.py``) against the JAX package's, on seeded inputs.

``DetEval``'s precision, recall and summaries must be equal (tolerance 0) on
sets with crowd boxes, objects of every area range and several ``max_dets``,
in bbox and segm, LVIS and COCO mode. Each evaluator (LVIS, custom COCO,
LVIS-to-COCO, OID) is fed the same synthetic json and the same padded
outputs on both sides (the port's as torch tensors) and must give an equal
result dict. A control: ground truth fed back as predictions scores AP 1.
"""
import json

import numpy as np
import pytest
import torch

from divergen_tpu.data import catalog as jcat
from divergen_tpu.data import transforms as jtf
from divergen_tpu.data.datasets import lvis as jlvis
from divergen_tpu.evaluation import coco_eval_np as jce
from divergen_tpu.evaluation import lvis_evaluator as jle
from divergen_tpu.utils.mask_codec import rle_encode
from divergen_tpu_torch.data import catalog as tcat
from divergen_tpu_torch.data import transforms as ttf
from divergen_tpu_torch.data.datasets import lvis as tlvis
from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
from divergen_tpu_torch.evaluation import coco_eval_np as tce
from divergen_tpu_torch.evaluation import lvis_evaluator as tle

torch.set_num_threads(1)

SIZES = [(64, 80), (90, 70), (48, 48), (100, 120), (77, 61), (56, 90)]
NUM_CLASSES = 12


def assert_results_equal(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            assert_results_equal(got[k], want[k])
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


# -- DetEval ---------------------------------------------------------------------

def deteval_records(rng, segm):
    """gt and det records over 5 images and 3 categories: objects from 10 to
    140 px a side (every area range), crowd gts, dets jittered around the
    gts plus false positives. With ``segm`` each record carries an RLE of
    its box in a 160 x 160 frame (crowd gts a sparse one)."""
    gts, dets = [], []
    for img in range(1, 6):
        for _ in range(rng.randint(2, 7)):
            cat = int(rng.randint(1, 4))
            side = rng.choice([10, 25, 40, 70, 140]) * rng.uniform(0.8, 1.2, 2)
            xy = rng.rand(2) * (160 - side)
            crowd = int(rng.rand() < 0.15)
            g = {"image_id": img, "category_id": cat, "bbox": [*xy, *side],
                 "area": float(side[0] * side[1]), "iscrowd": crowd}
            gts.append(g)
            for _ in range(rng.randint(0, 3)):
                jit = xy + rng.randn(2) * side * 0.15
                dets.append({"image_id": img, "category_id": cat,
                             "bbox": [*jit, *(side * rng.uniform(0.7, 1.3, 2))],
                             "score": float(rng.rand())})
        for _ in range(rng.randint(0, 4)):  # false positives
            side = rng.uniform(8, 100, 2)
            dets.append({"image_id": img, "category_id": int(rng.randint(1, 4)),
                         "bbox": [*(rng.rand(2) * (160 - side)), *side], "score": float(rng.rand())})
    if segm:
        for r in gts + dets:
            m = np.zeros((160, 160), bool)
            x, y, w, h = [int(round(v)) for v in r["bbox"]]
            m[max(y, 0):y + h, max(x, 0):x + w] = True
            if r.get("iscrowd"):
                m &= rng.rand(160, 160) < 0.5
            r["segmentation"] = rle_encode(m)
    return gts, dets


@pytest.mark.parametrize("iou_type", ["bbox", "segm"])
@pytest.mark.parametrize("lvis_mode", [False, True], ids=["coco", "lvis"])
@pytest.mark.parametrize("max_dets", [1, 10, 100])
def test_deteval_equal(iou_type, lvis_mode, max_dets):
    rng = np.random.RandomState(10 + max_dets)
    gts, dets = deteval_records(rng, iou_type == "segm")
    infos = {i: {"neg_category_ids": [3] if i % 2 else [], "pos_category_ids": []}
             for i in range(1, 6)}
    freq = {"r": {1}, "c": {2}, "f": {3}}
    evs = []
    for mod in (tce, jce):
        ev = mod.DetEval(gts, dets, iou_type=iou_type, lvis_mode=lvis_mode, img_infos=infos,
                         max_dets=max_dets)
        ev.evaluate()
        ev.accumulate()
        evs.append((ev, ev.summarize(freq if lvis_mode else None), ev.per_category_ap()))
    (tev, tres, tpc), (jev, jres, jpc) = evs
    np.testing.assert_array_equal(tev.precision, jev.precision)
    np.testing.assert_array_equal(tev.recall, jev.recall)
    assert_results_equal(tres, jres)
    assert_results_equal(tpc, jpc)
    assert (tev.precision > 0).any()  # not an empty comparison


# -- the evaluators ---------------------------------------------------------------

@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """A synthetic LVIS set registered under the same name in both packages'
    catalogs."""
    root = tmp_path_factory.mktemp("synth_lvis")
    files = write_synthetic_lvis(str(root), SIZES, NUM_CLASSES, seed=3)
    name = "torch_port_eval_synth_lvis"
    with open(files["json_file"]) as f:
        data = json.load(f)
    for cat_mod, lvis_mod in ((jcat, jlvis), (tcat, tlvis)):
        cat_mod.DatasetCatalog.remove(name)
        cat_mod.MetadataCatalog.remove(name)
        lvis_mod.register_lvis_instances(name, lvis_mod.lvis_meta_from_json(files["json_file"]),
                                         files["json_file"], files["image_root"])
    yield name, files, data
    for cat_mod in (jcat, tcat):
        cat_mod.DatasetCatalog.remove(name)
        cat_mod.MetadataCatalog.remove(name)


def padded_outputs(data, rng, scale, k=10):
    """(inputs, outputs) as the eval loop hands them to ``process``: boxes in
    the resized frame (``scale``), jittered copies of the gts (class = the
    contiguous id) plus random boxes, random 28 x 28 mask logits, some
    slots invalid. Inputs carry each package's transform."""
    cats = sorted(c["id"] for c in data["categories"])
    contid = {c: i for i, c in enumerate(cats)}
    imgs = sorted(data["images"], key=lambda r: r["id"])
    b = len(imgs)
    out = {"boxes": np.zeros((b, k, 4), np.float32), "scores": np.zeros((b, k), np.float32),
           "classes": np.zeros((b, k), np.int64), "valid": np.zeros((b, k), bool),
           "mask_logits": (rng.randn(b, k, 28, 28) * 3).astype(np.float32)}
    for i, img in enumerate(imgs):
        anns = [a for a in data["annotations"] if a["image_id"] == img["id"]]
        for j in range(k):
            if j < len(anns) and rng.rand() < 0.8:
                x, y, w, h = np.asarray(anns[j]["bbox"]) + rng.randn(4) * 2
                cls = contid[anns[j]["category_id"]]
            else:
                w, h = rng.uniform(5, 40, 2)
                x, y = rng.rand() * (img["width"] - w), rng.rand() * (img["height"] - h)
                cls = rng.randint(len(cats))
            out["boxes"][i, j] = np.array([x, y, x + w, y + h]) * scale
            out["scores"][i, j] = rng.rand()
            out["classes"][i, j] = cls
            out["valid"][i, j] = rng.rand() < 0.9
        out["mask_logits"][i, :, 8:20, 8:20] += 4.0  # a blob in the middle
    inputs = {}
    for name, tf in (("jax", jtf), ("torch", ttf)):
        inputs[name] = [
            {"image_id": img["id"], "orig_height": img["height"], "orig_width": img["width"],
             "tfms": tf.TransformList([tf.ResizeCropTransform(
                 round(img["height"] * scale), round(img["width"] * scale), 0, 0, scale,
                 (round(img["height"] * scale), round(img["width"] * scale)))])}
            for img in imgs]
    return inputs, out


def run_both(jev, tev, inputs, outputs, batch=4):
    for ofs in range(0, len(inputs["jax"]), batch):
        part = {k: v[ofs:ofs + batch] for k, v in outputs.items()}
        jev.process(inputs["jax"][ofs:ofs + batch], part)
        tev.process(inputs["torch"][ofs:ofs + batch], {k: torch.from_numpy(v) for k, v in part.items()})
    assert tev._predictions == jev._predictions
    return tev.evaluate(), jev.evaluate()


def test_lvis_evaluator_equal(synth):
    name, _, data = synth
    inputs, outputs = padded_outputs(data, np.random.RandomState(5), scale=1.25)
    got, want = run_both(jle.LVISEvaluator(name), tle.LVISEvaluator(name), inputs, outputs)
    assert_results_equal(got, want)
    assert set(got) == {"bbox", "segm"} and {"APr", "APc", "APf"} <= set(got["bbox"])
    assert got["bbox"]["AP"] > 0 and got["segm"]["AP"] > 0
    assert tle.print_csv_format(got) == jle.print_csv_format(want)


def test_custom_coco_evaluator_equal(synth):
    name, _, data = synth
    inputs, outputs = padded_outputs(data, np.random.RandomState(6), scale=0.8)
    got, want = run_both(jle.CustomCOCOEvaluator(name), tle.CustomCOCOEvaluator(name),
                         inputs, outputs)
    assert_results_equal(got, want)
    assert got["bbox"]["AP"] > 0


@pytest.mark.parametrize("via", ["mapper_json", "lvis_json"])
def test_lvis_to_coco_evaluator_equal(synth, tmp_path, via):
    name, files, data = synth
    coco = dict(data, categories=[{"id": 100 + c["id"], "name": c["name"]}
                                  for c in data["categories"][:8]])
    coco["annotations"] = [dict(a, category_id=100 + a["category_id"]) for a in data["annotations"]
                           if a["category_id"] <= 8]
    cf = tmp_path / "coco.json"
    cf.write_text(json.dumps(coco))
    mf = tmp_path / "mapper.json"
    mf.write_text(json.dumps({str(i): 101 + i for i in range(0, 8, 2)}))
    coco_name = f"torch_port_eval_coco_{via}"
    for mod in (jcat, tcat):
        mod.MetadataCatalog.remove(coco_name)
        mod.MetadataCatalog.get(coco_name).set(json_file=str(cf), evaluator_type="lvis_to_coco")
    kw = {"mapper_json": str(mf)} if via == "mapper_json" else {"lvis_json": files["json_file"]}
    inputs, outputs = padded_outputs(data, np.random.RandomState(7), scale=1.0)
    got, want = run_both(jle.LVISToCOCOEvaluator(coco_name, **kw),
                         tle.LVISToCOCOEvaluator(coco_name, **kw), inputs, outputs)
    assert_results_equal(got, want)
    assert got["bbox"]["AP"] > 0
    assert (tle.build_lvis_to_coco_mapper(files["json_file"], coco["categories"])
            == jle.build_lvis_to_coco_mapper(files["json_file"], coco["categories"]))


def test_oid_evaluator_equal(synth, tmp_path):
    name, _, data = synth
    oid = json.loads(json.dumps(data))
    for k, a in enumerate(oid["annotations"]):
        a["IsGroupOf"] = int(k % 5 == 0)
    for img in oid["images"]:
        img["pos_category_ids"] = sorted({a["category_id"] for a in oid["annotations"]
                                          if a["image_id"] == img["id"]})
    for c in oid["categories"]:
        c["freebase_id"] = f"/m/{c['id']}"
    hierarchy = {"LabelName": "/m/root", "Subcategory": [
        {"LabelName": "/m/1", "Subcategory": [{"LabelName": "/m/2"}, {"LabelName": "/m/3"}]},
        {"LabelName": "/m/4"}]}
    of, hf = tmp_path / "oid.json", tmp_path / "hierarchy.json"
    of.write_text(json.dumps(oid))
    hf.write_text(json.dumps(hierarchy))
    oid_name = "torch_port_eval_oid"
    for mod in (jcat, tcat):
        mod.MetadataCatalog.remove(oid_name)
        mod.MetadataCatalog.get(oid_name).set(json_file=str(of), evaluator_type="oid",
                                              hierarchy_file=str(hf))
    inputs, outputs = padded_outputs(oid, np.random.RandomState(8), scale=1.0)
    evs = [mod.OIDEvaluator(oid_name, output_dir=str(tmp_path / tag))
           for mod, tag in ((jle, "jax"), (tle, "torch"))]
    got, want = run_both(evs[0], evs[1], inputs, outputs)
    assert_results_equal(got, want)
    assert {"AP50", "AP50_expand"} <= set(got["bbox"]) and got["bbox"]["AP50"] > 0
    np.testing.assert_array_equal(np.load(tmp_path / "torch" / "oid_mAP.npy"),
                                  np.load(tmp_path / "jax" / "oid_mAP.npy"))


def test_ground_truth_control_scores_ap_one(synth):
    """The ground truth fed back as predictions (score 1, the gt's own mask
    as RLE) scores AP 1 in bbox and segm, APr / APc / APf included, through
    the native IoU and matching; the JAX evaluator agrees."""
    name, _, data = synth
    results = []
    for mod in (tle, jle):
        ev = mod.LVISEvaluator(name)
        cats = sorted(c["id"] for c in data["categories"])
        for a in data["annotations"]:
            seg = ev._ann_rle(a, data)
            ev._predictions.append({"image_id": a["image_id"], "category_id": a["category_id"],
                                    "bbox": a["bbox"], "score": 1.0, "segmentation": seg})
        assert len(cats) == NUM_CLASSES
        results.append(ev.evaluate())
    got, want = results
    assert_results_equal(got, want)
    for task in ("bbox", "segm"):
        for key in ("AP", "AP50", "AP75", "APr", "APc", "APf"):
            assert got[task][key] == 1.0, (task, key, got[task][key])


def test_catalog_and_lvis_loading_equal(synth):
    name, files, _ = synth
    got, want = tcat.DatasetCatalog.get(name), jcat.DatasetCatalog.get(name)
    assert got == want and len(got) == len(SIZES)
    assert vars(tcat.MetadataCatalog.get(name)) == vars(jcat.MetadataCatalog.get(name))
    with open(files["json_file"]) as f:
        cats = json.load(f)["categories"]
    assert tlvis.frequency_groups(cats) == jlvis.frequency_groups(cats)
    assert tlvis.lvis_meta_from_json(files["json_file"]) == jlvis.lvis_meta_from_json(files["json_file"])
    assert all(len(r["neg_category_ids"]) and len(r["annotations"]) for r in got)
    assert {c["frequency"] for c in cats} == {"r", "c", "f"}
