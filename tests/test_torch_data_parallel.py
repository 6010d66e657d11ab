"""Data parallelism over two gloo ranks on the CPU against one process and the JAX step.

One session of two ranks (``torch_ranks.detector_session``, a ``FileStore``
rendezvous) runs four tasks on the tiny Swin detector, float32:

- the train step (``make_train_step(group=…)``), each rank holding one of the
  two images of the batch of ``test_torch_train_step.py`` and its rows of
  the JAX draws. The two images hold different numbers of valid ground-truth
  boxes (5 and 1), so of positives and valid ROIs, and different classes.
  Against the JAX step on the global batch, within that file's bounds: every
  metric (the ranks' mean) within 2e-4 relative, Adam's moments within 2e-4
  and 4e-4 of each leaf's largest value, the parameters and the EMA copy
  through their updates (no element off by more than twice the learning
  rate, those with a sized first moment by at most 1e-2 of it). Against the
  port's one-process step on the same draws, tighter: every metric within
  1e-5 relative, the moments within 1e-5 of each leaf's largest value, the
  sized elements' updates within 1e-4 of the learning rate (with the floor
  of 1e-6 of the tree's largest moment for leaves whose gradients are
  rounding-sized, as there). The ranks' parameters are equal bit for bit. A control: the mean of each image's own
  losses misses the global ones by more than the bound;
- the captioned weak forward with ``SYNC_CAPTION_BATCH``, against the JAX
  forward under ``shard_map`` with ``axis_name="data"`` on two CPU devices:
  each rank's losses within 1e-4 relative of its device's, and the gradient
  of its rows of ``cap_emb`` within 2e-4 of the largest;
- BSGAL's step (gradient compare from one forward), against the port's
  one-process step from the same generator: one decision on both ranks,
  equal to the one process's, ``grad_sim`` and the threshold within 1e-5,
  the metrics within 1e-5 relative, the parameters as the train step's;
- ``inference_on_dataset`` over six synthetic images in batches of four,
  against the one-process loop: the same images in the same order, equal
  classes and validity, boxes and scores within 1e-5 of their largest, the
  mask logits within 1e-4 (a forward of two images against one of four: the
  convolutions sum in another order, 2e-5 seen), and the same results on
  rank 0 (an empty dict on rank 1).

The JAX programs and the session run once per module.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.engine import train_loop as jloop
from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.solver import build as jsolver
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.active import bsgal as tb
from divergen_tpu_torch.data import DatasetCatalog, MetadataCatalog
from divergen_tpu_torch.data.datasets.lvis import lvis_meta_from_json, register_lvis_instances
from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
from divergen_tpu_torch.engine import eval_loop as teval
from divergen_tpu_torch.engine import train_loop as tloop
from divergen_tpu_torch.engine import trainer as ttrainer
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.ops.losses import RankDraws, uniform_draw
from divergen_tpu_torch.solver import build as tsolver
from divergen_tpu_torch.utils import dist as tdist
from divergen_tpu_torch.utils.convert import params_from_jax, tree_from_module
from test_torch_bsgal import ACTIVE, active_batch, torch_batch
from test_torch_detector import TINY_SWIN, randomized, shape_init, t
from test_torch_train_losses import CANVAS, detector_batch, jax_draws, jx, torch_gt, train_cfg
from test_torch_train_step import SOLVER, adam_moments, metrics_close, moments_close, \
    named_as_tree, updates_close
from torch_ranks import RecordingEvaluator, detector_session, rows_of, run_ranks

torch.set_num_threads(1)

LOSS_WEIGHTS = {"loss_mask": 0.5}
CAPTION = {"MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS": True, "MODEL.ROI_BOX_HEAD.NORM_TEMP": 5.0,
           "MODEL.ROI_BOX_HEAD.IMAGE_LABEL_LOSS": "max_score", "MODEL.WITH_CAPTION": True,
           "MODEL.SYNC_CAPTION_BATCH": True, "MODEL.ROI_BOX_HEAD.ADD_IMAGE_BOX": True,
           "MODEL.ROI_BOX_HEAD.WS_NUM_PROPS": 8, "WITH_IMAGE_LABELS": True}
DATASET = "torch_port_data_parallel_synth_lvis"


def unequal_batch():
    """The train step's batch with 5 valid boxes in image 0 and 1 in image 1,
    the valid classes of the two images different sets."""
    images, sizes, gt, fed = detector_batch(41)
    gt["valid"][:] = False
    gt["valid"][0, :5] = True
    gt["valid"][1, 0] = True
    gt["classes"][0, :5] = [0, 1, 2, 1, 0]
    gt["classes"][1, 0] = 6
    return images, sizes, gt, fed


def jax_train_case(tiny):
    images, sizes, gt, fed = unequal_batch()
    key = jax.random.PRNGKey(8)
    jcfg = train_cfg(lambda: tiny._small_cfg(backbone="swin"), **SOLVER)
    tcfg = train_cfg(lambda: tge._small_cfg(backbone="swin"), **SOLVER)
    jm = jrcnn.build_model(jcfg)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), gt=jx(gt), rng=key,
                                   fed_weight=jnp.asarray(fed), training=True),
                        np.random.RandomState(42))
    opt = jsolver.build_optimizer(jcfg, params)
    jstate = jloop.create_train_state(jx(params), opt, ema=True)
    jstep = jloop.make_train_step(jm, opt, ema_decay=0.9, loss_weights=LOSS_WEIGHTS, donate=False)
    jbatch = {"images": jnp.asarray(images), "image_sizes": jnp.asarray(sizes), "gt": jx(gt),
              "fed_weight": jnp.asarray(fed)}
    jstate, want = jstep(jstate, jbatch, key)
    tm = trcnn.build_model(tcfg, input_size=CANVAS)
    sd = params_from_jax(params, tm)
    return {"params": jax.tree.map(np.asarray, params), "after": jax.tree.map(np.asarray, jstate.params),
            "ema": jax.tree.map(np.asarray, jstate.ema_params), "moments": adam_moments(jstate.opt_state, params),
            "metrics": {k: float(v) for k, v in want.items()}, "lr": float(jsolver.build_lr_schedule(jcfg)(0)),
            "tcfg": tcfg, "state_dict": sd,
            "batch": {"images": t(images), "image_sizes": t(sizes), "gt": torch_gt(gt),
                      "fed_weight": t(fed)},
            "draws": jax_draws(jax.random.fold_in(key, 0), 2, 24, 8)}


def port_train_step(case, batch, draws):
    tm = trcnn.build_model(case["tcfg"], input_size=CANVAS)
    tm.load_state_dict(case["state_dict"])
    topt = tsolver.build_optimizer(case["tcfg"], tm)
    state = tloop.create_train_state(tm, topt, ema=True)
    step = tloop.make_train_step(tm, topt, ema_decay=0.9, loss_weights=LOSS_WEIGHTS)
    _, metrics = step(state, batch, draws)
    return tm, topt, {k: float(v) for k, v in metrics.items()}


def jax_caption_case(tiny):
    """The weak captioned forward of the JAX package under ``shard_map`` over
    two CPU devices: per-device losses and the gradient of ``cap_emb``."""
    from jax.sharding import Mesh, PartitionSpec as P

    images, sizes, gt, fed = detector_batch(55)
    rng = np.random.RandomState(56)
    gt["image_labels"] = np.array([[3, 5, 0], [6, 6, 1]], np.int32)
    gt["image_labels_valid"] = np.array([[True, True, False], [True, False, True]])
    cap = (rng.randn(2, 512) * 0.1).astype(np.float32)
    key = jax.random.PRNGKey(57)
    jm = jrcnn.build_model(train_cfg(lambda: tiny._small_cfg(backbone="swin"), **CAPTION))
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), gt=jx(gt), rng=key,
                                   fed_weight=jnp.asarray(fed), training=True), rng)
    mesh = Mesh(np.array(jax.devices("cpu")[:2]), ("data",))

    def per_device(p, im, sz, g, c):
        losses = jm.apply(p, im, sz, gt=g, rng=key, training=True, ann_type="captiontag",
                          cap_emb=c, axis_name="data")
        return {k: v[None] for k, v in losses.items()}

    sharded = jax.shard_map(per_device, mesh=mesh, in_specs=(P(), P("data"), P("data"), P("data"),
                                                             P("data")),
                            out_specs=P("data"), check_vma=False)

    def total(c):
        out = sharded(params, jnp.asarray(images), jnp.asarray(sizes), jx(gt), c)
        return sum(v.sum() for v in out.values()), out

    (_, losses), grad = jax.jit(jax.value_and_grad(total, has_aux=True))(jnp.asarray(cap))
    tcfg = train_cfg(lambda: tge._small_cfg(backbone="swin"), **CAPTION)
    tm = trcnn.build_model(tcfg, input_size=CANVAS)
    tgt = torch_gt(gt)
    tgt["image_labels"] = t(gt["image_labels"]).long()
    tgt["image_labels_valid"] = t(gt["image_labels_valid"])
    return {"want": {k: np.asarray(v) for k, v in losses.items()}, "want_grad": np.asarray(grad),
            "task": {"cfg": tcfg, "state_dict": params_from_jax(params, tm), "canvas": CANVAS,
                     "images": t(images), "sizes": t(sizes), "gt": tgt, "cap": t(cap),
                     "draws": jax_draws(key, 2, 24, 8), "ann_type": "captiontag"}}


def bsgal_case(tiny, train):
    cfg = train_cfg(lambda: tge._small_cfg(backbone="swin"), **ACTIVE)
    batch = torch_batch(active_batch(51))
    tm = trcnn.build_model(cfg, input_size=CANVAS)
    tm.load_state_dict(train["state_dict"])
    topt = tsolver.build_optimizer(cfg, tm)
    state = tloop.create_train_state(tm, topt, ema=True)
    astate = tb.init_active_state(dict(tm.named_parameters()), queue_size=8)
    _, astate, metrics = tb.make_active_train_step(tm, topt, cfg)(
        state, astate, batch, torch.Generator().manual_seed(5))
    metrics.pop("aux_paste_rows", None)
    return {"model": tm, "optimizer": topt, "metrics": {k: float(v) for k, v in metrics.items()},
            "counts": (int(astate.n_paste), int(astate.n_discard)),
            "task": {"cfg": cfg, "state_dict": train["state_dict"], "canvas": CANVAS,
                     "batch": batch, "seed": 5}}


def eval_case(train, root):
    cfg = train["tcfg"].clone()
    cfg.INPUT.TEST_SIZE = cfg.INPUT.MIN_SIZE_TEST = cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.DATASETS.TEST = (DATASET,)
    files = write_synthetic_lvis(str(root), [(64, 64)] * 6, 8, seed=33)
    DatasetCatalog.remove(DATASET)
    MetadataCatalog.remove(DATASET)
    register_lvis_instances(DATASET, lvis_meta_from_json(files["json_file"]), files["json_file"],
                            files["image_root"])
    model = trcnn.build_model(cfg, input_size=(64, 64))
    model.load_state_dict(train["state_dict"])
    evaluator = RecordingEvaluator(teval.build_evaluator(cfg, DATASET))
    results = teval.inference_on_dataset(model, None, cfg, DATASET, evaluator, batch_size=4)
    return {"results": results, "outputs": evaluator.outputs,
            "task": {"cfg": cfg, "state_dict": train["state_dict"], "canvas": (64, 64),
                     "files": files, "dataset": DATASET, "batch_size": 3}}


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(jswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    tiny = importlib.import_module("__graft_entry__")
    try:
        train = jax_train_case(tiny)
        caption = jax_caption_case(tiny)
        bsgal = bsgal_case(tiny, train)
        evaluate = eval_case(train, tmp_path_factory.mktemp("data"))
        spec = {"tiny_swin": TINY_SWIN, "caption": caption["task"], "bsgal": bsgal["task"],
                "evaluate": evaluate["task"],
                "train": {"cfg": train["tcfg"], "state_dict": train["state_dict"],
                          "canvas": CANVAS, "batch": train["batch"], "draws": train["draws"],
                          "loss_weights": LOSS_WEIGHTS}}
        ranks = run_ranks(detector_session, 2, tmp_path_factory.mktemp("ranks"), spec)
        yield {"train": train, "caption": caption, "bsgal": bsgal, "evaluate": evaluate,
               "ranks": ranks}
    finally:
        DatasetCatalog.remove(DATASET)
        MetadataCatalog.remove(DATASET)
        mp.undo()


def test_unequal_ranks():
    _, _, gt, _ = unequal_batch()
    classes = [set(gt["classes"][i][gt["valid"][i]].tolist()) for i in range(2)]
    assert gt["valid"].sum(1).tolist() == [5, 1] and classes[0] != classes[1]


def test_train_step_against_jax(session):
    train, ranks = session["train"], session["ranks"]
    got = ranks[0]["train"]
    assert ranks[0]["train"]["checksum"] == ranks[1]["train"]["checksum"]
    assert got["step"] == ranks[1]["train"]["step"] == 1
    assert ranks[0]["train"]["metrics"] == ranks[1]["train"]["metrics"]
    metrics_close(got["metrics"], train["metrics"])
    mu, nu, count = train["moments"]
    assert count == 1
    tcfg, before = train["tcfg"], train["params"]
    holder = trcnn.build_model(tcfg, input_size=CANVAS)
    holder.load_state_dict(got["params"])
    opt = tsolver.build_optimizer(tcfg, holder)
    for n, p in holder.named_parameters():
        opt.optim.state[p] = {"exp_avg": got["exp_avg"][n], "exp_avg_sq": got["exp_avg_sq"][n]}
    moments_close("2 ranks", tcfg, opt, holder, mu, nu, before)
    updates_close("2 ranks", tree_from_module(holder, before), train["after"], before, mu,
                  train["lr"])
    updates_close("2 ranks, ema", named_as_tree(tcfg, got["ema"], before), train["ema"], before,
                  mu, train["lr"], scale=0.1)


def test_train_step_against_one_process(session):
    train, got = session["train"], session["ranks"][0]["train"]
    tm, topt, want = port_train_step(train, train["batch"], train["draws"])
    for k, w in want.items():
        assert got["metrics"][k] == pytest.approx(w, rel=1e-5, abs=1e-7), k
    named = dict(tm.named_parameters())
    largest = {key: max(float(topt.optim.state[p][key].abs().max()) for p in named.values())
               for key in ("exp_avg", "exp_avg_sq")}
    for n, p in named.items():
        state = topt.optim.state[p]
        for key in ("exp_avg", "exp_avg_sq"):
            w = state[key]
            bound = max(1e-5 * float(w.abs().max()), 1e-6 * largest[key])
            assert float((got[key][n] - w).abs().max()) <= bound, (n, key)
        m = state["exp_avg"].abs()
        diff = (got["params"][n] - p.detach()).abs()
        ulps = 2e-7 * max(1.0, float(p.detach().abs().max()))
        assert float(diff.max()) <= 2 * train["lr"] + ulps, n
        sized = m > max(1e-3 * float(m.max()), 1e-5 * largest["exp_avg"])
        if sized.any():
            assert float(diff[sized].max()) <= 1e-4 * train["lr"] + ulps, n
    # the control: each image's own normalizers miss the global batch's losses
    halves = [port_train_step(train, dict(rows_of({k: v for k, v in train["batch"].items()
                                                   if k != "fed_weight"}, i, 2),
                                          fed_weight=train["batch"]["fed_weight"]),
                              RankDraws(train["draws"], i, 2))[2] for i in range(2)]
    missed = [k for k in want if k.startswith("loss_") and abs(
        (halves[0][k] + halves[1][k]) / 2 - want[k]) > 2e-4 * abs(want[k]) + 1e-6]
    assert {"loss_cls_stage0", "loss_box_reg_stage0", "loss_centernet_loc"} <= set(missed)


def test_caption_all_gather_against_shard_map(session):
    caption, ranks = session["caption"], session["ranks"]
    scale = np.abs(caption["want_grad"]).max()
    assert scale > 0
    for rank in range(2):
        got = ranks[rank]["caption"]
        assert set(got["losses"]) == set(caption["want"])
        for k, w in caption["want"].items():
            np.testing.assert_allclose(got["losses"][k].numpy(), w[rank], rtol=1e-4, atol=1e-6,
                                       err_msg=k)
        assert np.abs(got["cap_grad"].numpy() - caption["want_grad"][rank:rank + 1]).max() \
            <= 2e-4 * scale
    # each rank's image loss scored the other rank's caption too
    assert all(float(r["caption"]["losses"]["image_loss_stage0"]) > 0 for r in ranks)


def test_bsgal_step_one_decision(session):
    one, ranks = session["bsgal"], session["ranks"]
    a, b = ranks[0]["bsgal"], ranks[1]["bsgal"]
    assert a["local"]["paste_used"] == b["local"]["paste_used"] == one["metrics"]["paste_used"]
    assert a["counts"] == b["counts"] == one["counts"]
    assert a["checksum"] == b["checksum"] and a["bank_checksum"] == b["bank_checksum"]
    for k in ("grad_sim", "threshold"):
        assert a["local"][k] == b["local"][k] == pytest.approx(one["metrics"][k], abs=1e-5), k
    for k, w in one["metrics"].items():
        assert a["metrics"][k] == pytest.approx(w, rel=1e-5, abs=1e-7), k
    lr = float(tsolver.build_lr_schedule(one["task"]["cfg"])(0))
    model, opt = one["model"], one["optimizer"]
    largest = max(float(opt.optim.state[p]["exp_avg"].abs().max()) for p in model.parameters())
    for n, p in model.named_parameters():
        m = opt.optim.state[p]["exp_avg"].abs()
        diff = (a["params"][n] - p.detach()).abs()
        ulps = 2e-7 * max(1.0, float(p.detach().abs().max()))
        assert float(diff.max()) <= 2 * lr + ulps, n
        sized = m > max(1e-3 * float(m.max()), 1e-5 * largest)
        if sized.any():
            assert float(diff[sized].max()) <= 1e-4 * lr + ulps, n


def test_inference_on_dataset_over_two_ranks(session):
    one, ranks = session["evaluate"], session["ranks"]
    got = ranks[0]["evaluate"]
    assert ranks[1]["evaluate"] == {"results": {}, "outputs": []}
    assert [ids for _, ids in got["outputs"]] == [ids for _, ids in one["outputs"]]
    assert sum(len(ids) for _, ids in got["outputs"]) == 6
    for (g, ids), (w, _) in zip(got["outputs"], one["outputs"]):
        n = len(ids)  # the padded rows past the last image are not evaluated
        assert g["boxes"].shape[0] >= n
        for k in ("classes", "valid"):
            np.testing.assert_array_equal(g[k][:n], w[k][:n], err_msg=k)
        for k, tol in (("boxes", 1e-5), ("scores", 1e-5), ("mask_logits", 1e-4)):
            scale = max(np.abs(w[k][:n]).max(), 1e-12)
            assert np.abs(g[k][:n] - w[k][:n]).max() <= tol * scale, k
        assert w["valid"][:n].any()
    assert list(got["results"]) == list(one["results"])
    for task in one["results"]:
        for k, v in one["results"][task].items():
            assert got["results"][task][k] == pytest.approx(v, abs=1e-6, nan_ok=True), (task, k)


def test_rank_draws():
    """Each rank draws what one process draws for the global batch: its rows
    of a per-image draw, the whole of any other, the generator advanced
    alike; a mapping of global draws (and BSGAL's nested one) is sliced the
    same way."""
    one = torch.Generator().manual_seed(3)
    want = [uniform_draw(one, "match", (4, 5), "cpu", per_image=True),
            uniform_draw(one, "fed0", (9,), "cpu"), uniform_draw(one, "mask", (4, 5), "cpu")]
    for rank in range(2):
        r = RankDraws(torch.Generator().manual_seed(3), rank, 2)
        got = [uniform_draw(r, "match", (2, 5), "cpu", per_image=True),
               uniform_draw(r, "fed0", (9,), "cpu"),
               uniform_draw(r, "mask", (2, 5), "cpu", per_image=True)]
        for g, w, rows in zip(got, want, (True, False, True)):
            assert torch.equal(g, w[2 * rank:2 * rank + 2] if rows else w)
        named = RankDraws({"match": want[0], "fed0": want[1]}, rank, 2)
        assert torch.equal(uniform_draw(named, "match", (2, 5), "cpu", per_image=True),
                           want[0][2 * rank:2 * rank + 2])
        assert torch.equal(uniform_draw(named, "fed0", (9,), "cpu"), want[1])
        probe, paste, final, cmp = tb.split_rng(RankDraws(
            {"probe": {"match": want[0]}, "paste": {}, "final": {}, "compare": 0.5}, rank, 2))
        assert torch.equal(uniform_draw(probe, "match", (2, 5), "cpu", per_image=True),
                           want[0][2 * rank:2 * rank + 2])
        assert float(uniform_draw(cmp, "compare", (), "cpu")) == 0.5


def test_world_size_without_a_group_raises(monkeypatch):
    """The repaired fault: WORLD_SIZE=2 without a process group used to train
    two independent replicas, each on its own stride of the data."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group is initialized"):
        tdist.layout()
    cfg = tge._small_cfg()
    with pytest.raises(RuntimeError, match="no process group is initialized"):
        ttrainer.do_train(cfg, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert tdist.layout() == tdist.Layout()


def test_train_rows_and_the_row_split_loader():
    """Two ranks of a node, each mapping its rows, hand out what one loader
    hands out (the per-sample seeds follow the whole batch); with BSGAL every
    second batch is a probe, split by ``PROBE_BATCH``."""
    from divergen_tpu_torch.data.loader import TrainLoader
    from divergen_tpu_torch.data.samplers import TrainingSampler

    cfg = tge._small_cfg()
    cfg.SOLVER.IMS_PER_BATCH, cfg.MODEL.ACTIVE.PROBE_BATCH = 4, 2
    cfg.MODEL.ACTIVE.ENABLED = True
    lay = lambda r: tdist.Layout(rank=r, world=2, local_rank=r, local_world=2)
    assert ttrainer.train_rows(cfg, lay(1)) == ((2, 4), (1, 2))
    cfg.MODEL.ACTIVE.PROBE_BATCH = 3
    with pytest.raises(ValueError, match="PROBE_BATCH 3"):
        ttrainer.train_rows(cfg, lay(0))
    cfg.SOLVER.IMS_PER_BATCH = 3
    with pytest.raises(ValueError, match="IMS_PER_BATCH 3"):
        ttrainer.train_rows(cfg, lay(0))

    mapper = lambda rec, rng: {"image": np.array([rec, rng.integers(1 << 30)])}
    batches = lambda rows: [b["image"] for _, b in zip(range(4), iter(TrainLoader(
        list(range(10)), mapper, TrainingSampler(10, seed=3), 4, num_workers=2, seed=9,
        rows=rows)))]
    whole = batches(())
    parts = [batches([(0, 2), (0, 1)]), batches([(2, 4), (1, 2)])]
    for i, w in enumerate(whole):
        lo = [(0, 2), (0, 1)][i % 2]
        hi = [(2, 4), (1, 2)][i % 2]
        np.testing.assert_array_equal(parts[0][i], w[lo[0]:lo[1]])
        np.testing.assert_array_equal(parts[1][i], w[hi[0]:hi[1]])
