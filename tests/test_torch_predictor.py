"""The port's serving and evaluation path (``divergen_tpu_torch/predictor.py``,
``engine/eval_loop.py``) against the JAX package's, on the CPU in float32.

A tiny Swin detector (the JAX predictor test builds ResNet-18, which the port
lacks) with the randomized weights of ``test_torch_detector``, carried over
by ``params_from_jax``. ``Predictor`` on a 64 x 80 image whose short edge is
``MIN_SIZE_TEST``, so that both resizes are the identity: boxes and scores
within 1e-4 of max |reference|, the same classes and kept set, masks equal
except where the pasted probability lies within 1e-4 of 0.5.
``BatchPredictor`` and ``AsyncPredictor`` against the port's ``Predictor``:
request order and equal results. ``do_test(state=...)`` against the JAX
``inference_on_dataset`` on a 4-image 64 x 64 synthetic LVIS set whose
ground truth includes some of the model's own detections (so AP is not 0):
result dicts within 1e-6. Two JAX detector runs in all.
"""
import importlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.data import catalog as jcat
from divergen_tpu.data.datasets import lvis as jlvis
from divergen_tpu.engine import eval_loop as jeval
from divergen_tpu.evaluation import lvis_evaluator as jle
from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch import predictor as tpred
from divergen_tpu_torch.data import catalog as tcat
from divergen_tpu_torch.data.datasets import lvis as tlvis
from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
from divergen_tpu_torch.engine import eval_loop as teval
from divergen_tpu_torch.engine.train_loop import TrainState
from divergen_tpu_torch.evaluation.lvis_evaluator import paste_mask_prob
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.utils.convert import params_from_jax
from divergen_tpu_torch.utils.png import read_png
from test_torch_detector import TINY_SWIN, randomized, shape_init, tiny_cfg

torch.set_num_threads(1)


def cfg_pair(test_size, min_size, max_size):
    """(port cfg, JAX cfg) of the tiny Swin detector at one test canvas."""
    jentry = importlib.import_module("__graft_entry__")
    out = []
    for cfg in (tiny_cfg(lambda: tge._small_cfg(backbone="swin")), tiny_cfg(lambda: jentry._small_cfg(backbone="swin"))):
        cfg.INPUT.TEST_SIZE = test_size
        cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST = min_size, max_size
        cfg.PARALLEL.DATA_PARALLEL = 1
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def tiny_swin():
    mp = pytest.MonkeyPatch()
    mp.setitem(jswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    yield
    mp.undo()


def weights(jcfg, tcfg, canvas, seed):
    """JAX params and the port's state_dict of the same randomized weights."""
    jm = jrcnn.build_model(jcfg)
    img = jnp.zeros((1, canvas, canvas, 3), jnp.float32)
    params = randomized(shape_init(jm, img, jnp.asarray([[canvas, canvas]]), training=False),
                        np.random.RandomState(seed))
    tm = trcnn.build_model(tcfg, input_size=(canvas, canvas))
    return params, params_from_jax(params, tm)


def assert_detections_match(got, want, want_probs=None, tol=1e-4):
    np.testing.assert_array_equal(got["classes"], want["classes"])
    assert got["boxes"].shape == want["boxes"].shape
    for k in ("boxes", "scores"):
        ref = np.asarray(want[k], np.float64)
        err = np.abs(got[k] - ref).max() if ref.size else 0.0
        assert err <= tol * max(np.abs(ref).max() if ref.size else 1.0, 1e-12), (k, err)
    if want_probs is not None:
        differ = got["masks"] != want["masks"]
        assert np.all(np.abs(want_probs[differ] - 0.5) <= 1e-4), int(differ.sum())


PRED_THRESH = 0.05


@pytest.fixture(scope="module")
def predictor_case(tiny_swin):
    from divergen_tpu.predictor import Predictor as JPredictor

    tcfg, jcfg = cfg_pair(96, 64, 96)
    params, sd = weights(jcfg, tcfg, 96, seed=21)
    rng = np.random.RandomState(22)
    images = [(rng.rand(64, 80, 3) * 255).astype(np.uint8) for _ in range(5)]
    jp = JPredictor(jcfg, params, score_thresh=PRED_THRESH)
    want = jp(images[0])
    # the pasted probabilities of the JAX side, to tell threshold ties apart
    x, size, _ = jp.preprocess(images[0])
    raw = jax.tree.map(np.asarray, jp._infer(params, jnp.asarray(x[None]), jnp.asarray(size[None])))
    keep = raw["valid"][0] & (raw["scores"][0] >= PRED_THRESH)
    probs = 1 / (1 + np.exp(-raw["mask_logits"][0][keep]))
    want_probs = np.stack([paste_mask_prob(p, b, 64, 80) for p, b in zip(probs, want["boxes"])])
    tp = tpred.Predictor(tcfg, sd, score_thresh=PRED_THRESH, device="cpu")
    return tcfg, sd, tp, images, want, want_probs


def test_predictor_against_jax(predictor_case):
    _, _, tp, images, want, want_probs = predictor_case
    got = tp(images[0])
    assert len(want["boxes"]) >= 3  # a kept set worth comparing
    assert got["masks"].shape == (len(want["boxes"]), 64, 80) and got["masks"].dtype == bool
    assert_detections_match(got, want, want_probs)
    assert (got["boxes"][:, [0, 2]] <= 80).all() and (got["boxes"][:, [1, 3]] <= 64).all()


def test_batch_predictor_order_and_equality(predictor_case):
    _, _, tp, images, _, _ = predictor_case
    want = [tp(im) for im in images]
    bp = tpred.BatchPredictor(tp, batch_size=2, depth=1)
    got = list(bp(images))
    assert len(got) == len(images) and len(bp.host_syncs) == 3  # 2 + 2 + 1 (padded)
    assert all(n >= 2 for n in bp.host_syncs)  # NMS fixpoint reads, two stages at least
    for g, w in zip(got, want):
        g = dict(g, boxes=g["boxes"].copy())
        g["boxes"][:, [0, 2]] = np.clip(g["boxes"][:, [0, 2]], 0, 80)
        g["boxes"][:, [1, 3]] = np.clip(g["boxes"][:, [1, 3]], 0, 64)
        assert_detections_match(g, w, tol=1e-5)


def test_async_predictor_order_and_equality(predictor_case):
    tcfg, sd, tp, images, _, _ = predictor_case
    want = [tp(im) for im in images]
    ap = tpred.AsyncPredictor(tcfg, sd, num_workers=2, score_thresh=PRED_THRESH, device="cpu")
    try:
        for im in images:
            ap.put(im)
        assert len(ap) == 5
        got = [ap.get() for _ in images]
        assert len(ap) == 0
        for g, w in zip(got, want):  # request order, the synchronous results
            assert_detections_match(g, w, tol=0)
            np.testing.assert_array_equal(g["masks"], w["masks"])
        one = ap(images[3])
        np.testing.assert_array_equal(one["scores"], want[3]["scores"])
        assert ap.default_buffer_size == 10
    finally:
        ap.shutdown()


def test_async_predictor_spreads_workers_over_the_cards(predictor_case, monkeypatch):
    """Worker ``wid`` runs on ``cuda:(wid % n)`` over the ``n`` local cards,
    as the JAX class pins it to ``devices[wid % len(devices)]`` (the device
    count patched to 3); a device with an index, or the CPU, takes every
    worker; on the CPU ``num_workers`` defaults to 1."""
    tcfg, sd, tp, images, _, _ = predictor_case
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    spread = tpred.worker_devices(torch.device("cuda"), 5)
    assert spread == [torch.device("cuda", i % 3) for i in range(5)]
    assert [d.index for d in spread] == [list(range(3))[wid % 3] for wid in range(5)]
    assert tpred.worker_devices(torch.device("cuda", 2), 2) == [torch.device("cuda", 2)] * 2
    assert tpred.worker_devices(torch.device("cpu"), 2) == [torch.device("cpu")] * 2
    ap = tpred.AsyncPredictor(tcfg, sd, score_thresh=PRED_THRESH, device="cpu")
    try:
        assert ap.devices == [torch.device("cpu")] and ap.default_buffer_size == 5
        assert_detections_match(ap(images[0]), tp(images[0]), tol=0)
    finally:
        ap.shutdown()


def test_visualization_demo(predictor_case, tmp_path):
    from divergen_tpu_torch.utils.visualizer import save_visualization

    _, _, tp, images, _, _ = predictor_case
    preds, vis = tpred.VisualizationDemo(tp, [f"c{i}" for i in range(8)]).run_on_image(images[1])
    assert vis.shape == images[1].shape and vis.dtype == np.uint8
    assert (vis != images[1]).any()  # boxes, masks and labels drawn
    save_visualization(str(tmp_path / "vis.png"), vis)
    np.testing.assert_array_equal(read_png(str(tmp_path / "vis.png")), vis)


def test_entry_points_need_a_device(predictor_case):
    tcfg, sd, _, _, _, _ = predictor_case
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    for make in (lambda: tpred.Predictor(tcfg, sd), lambda: tpred.AsyncPredictor(tcfg, sd),
                 lambda: teval.do_test(tcfg, state=None)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make()


# -- do_test against the JAX inference_on_dataset -----------------------------------

DATASET = "torch_port_predictor_synth_lvis"


def register(files):
    for cat_mod, lvis_mod in ((jcat, jlvis), (tcat, tlvis)):
        cat_mod.DatasetCatalog.remove(DATASET)
        cat_mod.MetadataCatalog.remove(DATASET)
        lvis_mod.register_lvis_instances(DATASET, lvis_mod.lvis_meta_from_json(files["json_file"]),
                                         files["json_file"], files["image_root"])


def with_detections_as_gt(files, model, cfg):
    """Add two of the model's own detections per image (their boxes and
    pasted masks) to the set's ground truth, so that AP is not 0."""
    from divergen_tpu_torch.data.dataset_mapper import DatasetMapper
    from divergen_tpu_torch.native import paste_mask_rle
    from divergen_tpu_torch.utils.mask_codec import rle_area

    with open(files["json_file"]) as f:
        data = json.load(f)
    mapper = DatasetMapper(cfg, is_train=False)
    for img in data["images"]:
        s = mapper({"file_name": f"{files['image_root']}/{img['file_name']}"})
        with torch.no_grad():
            out = model(torch.from_numpy(s["image"][None]),
                        torch.from_numpy(s["image_size"][None]).long())
        valid = out["valid"][0]
        probs = torch.sigmoid(out["mask_logits"][0][valid]).numpy()
        added = 0
        for prob, box, cls in zip(probs, out["boxes"][0][valid].numpy(),
                                  out["classes"][0][valid].tolist()):
            rle = paste_mask_rle(prob, box, img["height"], img["width"])
            if added == 2 or not rle_area(rle):  # an empty mask matches nothing
                continue
            x1, y1, x2, y2 = box.tolist()
            data["annotations"].append({
                "id": len(data["annotations"]) + 1, "image_id": img["id"],
                "category_id": int(cls) + 1, "bbox": [x1, y1, x2 - x1, y2 - y1],
                "area": (x2 - x1) * (y2 - y1), "iscrowd": 0, "segmentation": rle})
            added += 1
    with open(files["json_file"], "w") as f:
        json.dump(data, f)


@pytest.fixture(scope="module")
def eval_case(tiny_swin, tmp_path_factory):
    tcfg, jcfg = cfg_pair(64, 64, 64)
    for cfg in (tcfg, jcfg):
        cfg.DATASETS.TEST = (DATASET,)
    params, sd = weights(jcfg, tcfg, 64, seed=31)
    model = trcnn.build_model(tcfg, input_size=(64, 64))
    model.load_state_dict(sd)
    model.eval()
    root = tmp_path_factory.mktemp("do_test")
    files = write_synthetic_lvis(str(root), [(64, 64)] * 4, 8, seed=32)
    with_detections_as_gt(files, model, tcfg)
    register(files)
    yield tcfg, jcfg, params, model
    for cat_mod in (jcat, tcat):
        cat_mod.DatasetCatalog.remove(DATASET)
        cat_mod.MetadataCatalog.remove(DATASET)


def assert_close_results(got, want, tol=1e-6):
    assert list(got) == list(want)
    for task in want:
        assert list(got[task]) == list(want[task])
        for k, v in want[task].items():
            if np.isnan(v):
                assert np.isnan(got[task][k]), (task, k)
            else:
                assert abs(got[task][k] - v) <= tol, (task, k, got[task][k], v)


def test_do_test_against_jax_inference_on_dataset(eval_case):
    tcfg, jcfg, params, model = eval_case
    want = jeval.inference_on_dataset(jrcnn.build_model(jcfg), params, jcfg, DATASET,
                                      jle.LVISEvaluator(DATASET))
    state = TrainState(step=0, model=model, optimizer=None)
    got = teval.do_test(tcfg, state=state, device="cpu")
    assert list(got) == [DATASET]
    assert_close_results(got[DATASET], want)
    assert got[DATASET]["bbox"]["AP"] > 0 and got[DATASET]["segm"]["AP"] > 0
    timing = teval.inference_on_dataset.last_timing
    assert timing["images"] == 4 and timing["total_s_per_image"] > 0


def test_inference_on_dataset_refuses_data_parallel(eval_case):
    """Evaluation ignores the model axis, as the JAX loop does: at
    ``MODEL_PARALLEL 2`` it gives the results of model 1 (a mesh of one data
    rank and two model ranks has no group without a process group); a data
    axis wider than the ranks takes them all, as the JAX loop takes every
    device."""
    from divergen_tpu_torch.parallel.mesh import create_mesh

    tcfg, _, _, model = eval_case
    cfg = tcfg.clone()
    one = teval.inference_on_dataset(model, None, cfg, DATASET,
                                     teval.build_evaluator(cfg, DATASET), max_images=2)
    cfg.PARALLEL.MODEL_PARALLEL = 2
    assert_close_results(teval.inference_on_dataset(
        model, None, cfg, DATASET, teval.build_evaluator(cfg, DATASET), max_images=2), one, tol=0)
    wide = create_mesh(1, 2, world=2)
    assert wide.group is None and wide.model_group is None
    cfg.PARALLEL.MODEL_PARALLEL = 1
    cfg.PARALLEL.DATA_PARALLEL = 2
    assert_close_results(teval.inference_on_dataset(
        model, None, cfg, DATASET, teval.build_evaluator(cfg, DATASET), max_images=2), one, tol=0)


def test_transfer_keeps_dtypes_and_bits():
    """``to_host`` / ``to_device`` pack a dict into one buffer each way: odd
    byte counts (bool, int8) before wider dtypes, bfloat16 (as float32)."""
    from divergen_tpu_torch.utils.transfer import to_device, to_host

    gen = torch.Generator().manual_seed(0)
    tensors = {"valid": torch.rand(3, 5, generator=gen) > 0.5,
               "codes": torch.randint(-9, 9, (7,), generator=gen, dtype=torch.int8),
               "classes": torch.randint(0, 1453, (3, 5), generator=gen),
               "boxes": torch.randn(3, 5, 4, generator=gen),
               "logits": torch.randn(3, 2, 2, generator=gen).bfloat16(),
               "empty": torch.zeros(0, 4)}
    host = to_host(tensors)
    assert list(host) == list(tensors)
    for k, v in tensors.items():
        want = v.float().numpy() if v.dtype == torch.bfloat16 else v.numpy()
        assert host[k].dtype == want.dtype and host[k].shape == want.shape
        np.testing.assert_array_equal(host[k], want)
    back = to_device(host, "cpu")
    for k, v in host.items():
        np.testing.assert_array_equal(back[k].numpy(), v)
