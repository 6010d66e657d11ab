"""Data parallelism over two gloo ranks on the CPU against one process and the JAX step.

One session of two ranks (``torch_ranks.sessions``, a ``FileStore``
rendezvous) runs the tasks of ``detector_session`` and then those of
``model_axis_session`` on the tiny Swin detector, float32. The first four:

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

The model axis's tasks (data 1 × model 2 unless said): the train step of the
first task, with the leaves JAX's rule shards at ``min_size`` 2**12 held as
slices, against the JAX step and the one-process step, then saved and
stepped again; BSGAL's step with ``PER_INSTANCE``, at model 2 and over the
two ranks as data ranks, each against the JAX step on the global batch (one
more JAX program: the draws are the JAX step's) and against the port's one
process; ``inference_on_dataset`` at ``DATA_PARALLEL 1``. The row-split
loader with missing files is held against the JAX loader without ranks.

The JAX programs and the session run once per module.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.active import bsgal as jb
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
from test_torch_bsgal import ACTIVE, active_batch, step_draws, torch_batch
from test_torch_detector import TINY_SWIN, randomized, shape_init, t
from test_torch_train_losses import CANVAS, detector_batch, jax_draws, jx, torch_gt, train_cfg
from test_torch_train_step import SOLVER, adam_moments, metrics_close, moments_close, \
    named_as_tree, updates_close
from torch_ranks import RecordingEvaluator, rows_of, run_ranks, sessions

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


def bsgal_case(tiny, train, draws=None, **keys):
    """The port's one-process BSGAL step on ``active_batch(51)`` from the
    train case's weights, with a generator (seed 5) or the JAX step's
    ``draws``."""
    cfg = train_cfg(lambda: tge._small_cfg(backbone="swin"), **dict(ACTIVE, **keys))
    batch = torch_batch(active_batch(51))
    tm = trcnn.build_model(cfg, input_size=CANVAS)
    tm.load_state_dict(train["state_dict"])
    topt = tsolver.build_optimizer(cfg, tm)
    state = tloop.create_train_state(tm, topt, ema=True)
    astate = tb.init_active_state(dict(tm.named_parameters()), queue_size=8)
    rng = torch.Generator().manual_seed(5) if draws is None else draws
    state, astate, metrics = tb.make_active_train_step(tm, topt, cfg)(state, astate, batch, rng)
    rows = metrics.pop("aux_paste_rows", None)
    task = {"cfg": cfg, "state_dict": train["state_dict"], "canvas": CANVAS, "batch": batch}
    task.update({"seed": 5} if draws is None else {"draws": draws})
    return {"model": tm, "optimizer": topt, "metrics": {k: float(v) for k, v in metrics.items()},
            "counts": (int(astate.n_paste), int(astate.n_discard)), "rows": rows, "task": task}


def jax_per_instance_case(tiny, train):
    """The JAX BSGAL step with ``PER_INSTANCE`` on the global batch
    (``active_batch(51)``) from the train case's weights, and the port's one
    process on the same draws."""
    jcfg = train_cfg(lambda: tiny._small_cfg(backbone="swin"), **dict(ACTIVE, **PER_INSTANCE))
    key = jax.random.PRNGKey(10)
    jm = jrcnn.build_model(jcfg)
    opt = jsolver.build_optimizer(jcfg, train["params"])
    jstate = jloop.create_train_state(jx(train["params"]), opt, ema=True)
    jastate = jb.init_active_state(jstate.params, queue_size=8)
    jout = jb.make_active_train_step(jm, opt, jcfg)(jstate, jastate, jx(active_batch(51)), key)
    one = bsgal_case(tiny, train, draws=step_draws(key, 0), **PER_INSTANCE)
    rows = {k: np.asarray(v) for k, v in jout[2]["aux_paste_rows"].items()}
    return dict(one, jax=jout, jax_rows=rows,
                jax_metrics={k: float(v) for k, v in jout[2].items() if k != "aux_paste_rows"})


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
        train_task = {"cfg": train["tcfg"], "state_dict": train["state_dict"], "canvas": CANVAS,
                      "batch": train["batch"], "draws": train["draws"],
                      "loss_weights": LOSS_WEIGHTS}
        spec = {"tiny_swin": TINY_SWIN, "caption": caption["task"], "bsgal": bsgal["task"],
                "evaluate": evaluate["task"], "train": train_task}
        # the model axis's tasks run next in the same two ranks (``model_axis``)
        per_instance = jax_per_instance_case(tiny, train)
        narrow = dict(evaluate["task"], cfg=evaluate["task"]["cfg"].clone())
        narrow["cfg"].PARALLEL.DATA_PARALLEL, narrow["cfg"].PARALLEL.MODEL_PARALLEL = 1, 2
        model_spec = {"tiny_swin": TINY_SWIN, "per_instance": per_instance["task"],
                      "evaluate": narrow,
                      "train": train_task}
        ckpt = str(tmp_path_factory.mktemp("model_axis_ckpt"))
        both = run_ranks(sessions, 2, tmp_path_factory.mktemp("ranks"), spec, model_spec, ckpt)
        yield {"train": train, "caption": caption, "bsgal": bsgal, "evaluate": evaluate,
               "ranks": [r["detector"] for r in both],
               "model_axis": {"ranks": [r["model_axis"] for r in both],
                              "per_instance": per_instance, "ckpt": ckpt}}
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


def test_row_split_loader_backfills_a_missing_file_as_jax(tmp_path):
    """Files missing from a loader's records are skipped and the batch
    backfilled from the index stream as the JAX loader does: a loader of
    whole batches hands out the JAX loader's batches, and the two ranks'
    rows of each batch (and of each probe batch) concatenate to them,
    per-sample seeds included; every rank composes the batch, each maps only
    its own rows. A file the mapper cannot read that the record does not
    name (which the JAX loader skips) raises."""
    from divergen_tpu.data import loader as jloader
    from divergen_tpu.data import samplers as jsamplers
    from divergen_tpu_torch.data.loader import TrainLoader
    from divergen_tpu_torch.data.samplers import TrainingSampler

    records = []
    for i in range(12):
        path = tmp_path / f"{i}.txt"
        if i not in (2, 7, 8):  # three missing files, two of them neighbours
            path.write_text(str(i))
        records.append({"file_name": str(path), "image_id": i})

    def mapper_logging(log):
        def mapper(rec, rng):
            with open(rec["file_name"]) as f:  # FileNotFoundError for a missing file
                value = int(f.read())
            row = (value, int(rng.integers(1 << 30)))  # the draw names the row's seed
            log.append(row)
            return {"image": np.array(row), "image_id": rec["image_id"]}
        return mapper

    def take(loader, n):
        out = [b["image"] for _, b in zip(range(n), iter(loader))]
        loader.stop()
        return out

    # the JAX loader's batches, far enough ahead to cover the port loaders' prefetch
    want = take(jloader.TrainLoader(records, mapper_logging([]),
                                    jsamplers.TrainingSampler(12, seed=5), 4, num_workers=2,
                                    seed=3), 16)
    whole = take(TrainLoader(records, mapper_logging([]), TrainingSampler(12, seed=5), 4,
                             num_workers=2, seed=3), 6)
    for w, got in zip(want, whole):
        np.testing.assert_array_equal(got, w)
    rows = [[(0, 2), (0, 1)], [(2, 4), (1, 2)]]
    parts, logs = [], [[], []]
    for r, log in zip(rows, logs):
        parts.append(take(TrainLoader(records, mapper_logging(log), TrainingSampler(12, seed=5),
                                      4, num_workers=2, queue_size=1, seed=3, rows=r), 6))
    assert not any(int(v) in (2, 7, 8) for w in want for v in w[:, 0])
    for r, log in zip(rows, logs):
        # every row a rank mapped is one of its own rows of a batch
        own = {tuple(int(x) for x in row) for i, w in enumerate(want)
               for row in w[r[i % 2][0]:r[i % 2][1]]}
        assert log and set(log) <= own
    for i, w in enumerate(want[:6]):
        got = np.concatenate([parts[0][i], parts[1][i]])
        lo, hi = rows[0][i % 2], rows[1][i % 2]
        np.testing.assert_array_equal(got, np.concatenate([w[lo[0]:lo[1]], w[hi[0]:hi[1]]]))

    def reads_another_file(rec, rng):
        open(str(tmp_path / "2.txt")).close()  # a file the record does not name
        return {"image": np.zeros(2)}

    with pytest.raises(RuntimeError, match="does not name"):
        take(TrainLoader(records, reads_another_file, TrainingSampler(12, seed=5), 4,
                         num_workers=2, seed=3), 1)


# -- the model axis ---------------------------------------------------------------------------

# at 0.3 the global quantile of three pastes keeps one; per rank (two and one
# pastes) it would keep one of each
PER_INSTANCE = {"MODEL.ACTIVE.PER_INSTANCE": True, "MODEL.ACTIVE.PER_INSTANCE_PERCENT": 0.3}


@pytest.fixture(scope="module")
def model_axis(session):
    """The session's model-axis tasks (``torch_ranks.model_axis_session``,
    after ``detector_session`` in the same two ranks): as data 1 × model 2
    the train step, its checkpoint, BSGAL with ``PER_INSTANCE`` and the
    evaluation on the first rank; as two data ranks BSGAL with
    ``PER_INSTANCE``; with the JAX and one-process steps they are held
    against."""
    return session["model_axis"]


def jax_sharded_leaves(params, min_size):
    """The port names of the leaves JAX's rule shards on a (1, 2) mesh."""
    from divergen_tpu.parallel import mesh as jmesh

    sh = jmesh.param_sharding_rules(params["params"], jmesh.create_mesh(
        1, 2, devices=jax.devices("cpu")[:2]), min_size=min_size)
    leaf = {"kernel": "weight", "scale": "weight", "embedding": "weight"}
    out = set()
    for path, s in jax.tree_util.tree_leaves_with_path(sh):
        names = [str(p.key) for p in path]
        if "model" in s.spec:
            out.add(".".join(names[:-1] + [leaf.get(names[-1], names[-1])]))
    return out


def test_model_axis_slices_what_jax_shards(session, model_axis):
    """The only leaves held as slices are those JAX's rule shards (``min_size``
    2**12, as the JAX dryrun); each one's parameter, gradient, AdamW moments
    and EMA copy are half the full shape on each rank, along the dim that
    holds the JAX leaf's last axis; every other leaf is whole."""
    train = session["train"]
    got = model_axis["ranks"][0]["train"]
    assert got["groups"] == (True, True)  # no data group at data 1; a model group
    assert set(got["sliced"]) == jax_sharded_leaves(train["params"], 2**12)
    assert len(got["sliced"]) > 10
    full = {n: tuple(v.shape) for n, v in train["state_dict"].items()}
    for n, shapes in got["shapes"].items():
        want = list(full[n])
        if n in got["sliced"]:
            want[got["sliced"][n]] //= 2
        assert set(shapes.values()) == {tuple(want)}, n
    assert model_axis["ranks"][1]["train"]["shapes"] == got["shapes"]


def test_model_axis_step_against_jax_and_one_process(session, model_axis):
    """One train step at data 1 × model 2 against the JAX step on the global
    batch (the bounds of ``test_train_step_against_jax``) and against the
    port's one process (metrics within 1e-5 relative, the gathered moments
    within 1e-5 of each leaf's largest, the parameters within 1e-4 of the
    learning rate where the first moment is sized)."""
    train = session["train"]
    a, b = (r["train"] for r in model_axis["ranks"])
    assert a["metrics"] == b["metrics"]
    for key in ("params", "exp_avg", "exp_avg_sq", "ema"):
        for n, v in a["first"][key].items():
            assert torch.equal(v, b["first"][key][n]), (key, n)
    metrics_close(a["metrics"], train["metrics"])
    mu, nu, _ = train["moments"]
    tcfg, before = train["tcfg"], train["params"]
    holder = trcnn.build_model(tcfg, input_size=CANVAS)
    holder.load_state_dict(a["first"]["params"])
    opt = tsolver.build_optimizer(tcfg, holder)
    for n, p in holder.named_parameters():
        opt.optim.state[p] = {"exp_avg": a["first"]["exp_avg"][n],
                              "exp_avg_sq": a["first"]["exp_avg_sq"][n]}
    moments_close("model 2", tcfg, opt, holder, mu, nu, before)
    updates_close("model 2", tree_from_module(holder, before), train["after"], before, mu,
                  train["lr"])
    updates_close("model 2, ema", named_as_tree(tcfg, a["first"]["ema"], before), train["ema"],
                  before, mu, train["lr"], scale=0.1)
    tm, topt, want = port_train_step(train, train["batch"], train["draws"])
    for k, w in want.items():
        assert a["metrics"][k] == pytest.approx(w, rel=1e-5, abs=1e-7), k
    for n, p in tm.named_parameters():
        for key in ("exp_avg", "exp_avg_sq"):
            w = topt.optim.state[p][key]
            assert float((a["first"][key][n] - w).abs().max()) <= 1e-5 * float(w.abs().max()) \
                + 1e-12, (n, key)
        diff = (a["first"]["params"][n] - p.detach()).abs()
        assert float(diff.max()) <= 1e-4 * train["lr"] + 2e-7 * float(p.detach().abs().max()), n


def test_model_axis_checkpoint_resumes_at_model_one(session, model_axis):
    """The checkpoint written at model 2 is an unsliced model's file: it
    restores at model 1 to the gathered tensors bit for bit, and the next
    step there equals the second step at model 2 (metrics within 1e-5
    relative, parameters within 1e-4 of the learning rate)."""
    from divergen_tpu_torch.engine.checkpoint import Checkpointer

    train = session["train"]
    a = model_axis["ranks"][0]["train"]
    raw = Checkpointer(model_axis["ckpt"]).load(1)
    assert raw["step"] == 1 and set(raw["model"]) == set(train["state_dict"])
    for n, v in a["first"]["params"].items():
        assert torch.equal(raw["model"][n], v) and torch.equal(raw["ema_params"][n], a["first"]["ema"][n]), n
    tm = trcnn.build_model(train["tcfg"], input_size=CANVAS)
    topt = tsolver.build_optimizer(train["tcfg"], tm)
    state = Checkpointer(model_axis["ckpt"]).restore(tloop.create_train_state(tm, topt, ema=True))
    assert state.step == 1 and topt.count == 1
    for n, p in tm.named_parameters():
        assert torch.equal(p.detach(), a["first"]["params"][n]), n
        assert torch.equal(topt.optim.state[p]["exp_avg"], a["first"]["exp_avg"][n]), n
    step = tloop.make_train_step(tm, topt, ema_decay=0.9, loss_weights=LOSS_WEIGHTS)
    _, metrics = step(state, train["batch"], train["draws"])
    for k, v in metrics.items():
        assert float(v) == pytest.approx(a["second"]["metrics"][k], rel=1e-5, abs=1e-7), k
    for n, p in tm.named_parameters():
        diff = (a["second"]["params"][n] - p.detach()).abs()
        assert float(diff.max()) <= 1e-4 * train["lr"] + 2e-7 * float(p.detach().abs().max()), n


def close_to_jax(got, want):
    """A BSGAL step's metrics against the JAX step's, within the bounds of
    ``test_torch_bsgal.py``: the decision equal, ``grad_sim`` and the
    threshold within 1e-4, every other metric within 2e-4 relative."""
    assert set(got) == set(want) and got["paste_used"] == want["paste_used"]
    for k, w in want.items():
        if k in ("grad_sim", "threshold"):
            assert got[k] == pytest.approx(w, abs=1e-4), k
        else:
            assert got[k] == pytest.approx(w, rel=2e-4, abs=1e-6), k


def pastes_against_jax(rows, want):
    """The per-paste rows of a step (the ranks' concatenated) against the JAX
    step's: the same pasted instances kept (valid after the quantile's
    drop), the same proposal rows on a paste, their losses within 2e-4
    relative. The ids themselves are numbered per rank."""
    rows = {k: np.asarray(v) for k, v in rows.items()}
    kept = lambda r: (r["gt_ids"] > 0) & r["gt_valid"]
    np.testing.assert_array_equal(kept(rows), kept(want))
    np.testing.assert_array_equal(rows["id"] > 0, want["id"] > 0)
    np.testing.assert_allclose(rows["loss"], want["loss"], rtol=2e-4, atol=1e-6)


def test_model_axis_bsgal_step(session, model_axis):
    """BSGAL's step with ``PER_INSTANCE`` at data 1 × model 2 (its cosines
    and norms summed over the slices) against the JAX step on the same
    batch and draws (``close_to_jax``, ``pastes_against_jax``) and against
    the port's one process: the same decision and pastes kept, every metric
    within 1e-5 relative (``grad_sim`` within 1e-5), the parameters within
    1e-6 of the learning rate."""
    one = model_axis["per_instance"]
    a, b = (r["bsgal"] for r in model_axis["ranks"])
    assert a["metrics"] == b["metrics"] and a["counts"] == b["counts"] == one["counts"]
    close_to_jax(a["metrics"], one["jax_metrics"])
    pastes_against_jax(a["rows"], one["jax_rows"])
    for k, w in one["metrics"].items():
        assert a["metrics"][k] == pytest.approx(w, rel=1e-5, abs=1e-5 if k == "grad_sim" else 1e-7), k
    for n, p in one["model"].named_parameters():
        assert float((a["params"][n] - p.detach()).abs().max()) <= 2e-7 * max(
            1.0, float(p.detach().abs().max())) + 1e-6 * float(tsolver.build_lr_schedule(
                one["task"]["cfg"])(0)), n


def test_per_instance_over_two_data_ranks(session, model_axis):
    """BSGAL with ``PER_INSTANCE`` over two data ranks: the quantile is taken
    over the global batch's pastes (the ranks hold two and one), as the JAX
    step takes it on the global batch. The port's one process against the
    JAX step: its metrics (``close_to_jax``), its paste rows (ids and the
    pastes kept equal, losses within 2e-4 relative) and its parameters
    (``test_torch_train_step.updates_close``); the ranks against the JAX step
    (``close_to_jax``, ``pastes_against_jax``) and against the one process
    (every metric within 1e-5); a quantile per rank would keep two pastes,
    not one."""
    one = model_axis["per_instance"]
    jstate, _, _ = one["jax"]
    before = session["train"]["params"]
    close_to_jax(one["metrics"], one["jax_metrics"])
    pastes_against_jax(one["rows"], one["jax_rows"])
    for k in ("id", "gt_ids"):
        np.testing.assert_array_equal(one["rows"][k].numpy(), one["jax_rows"][k], err_msg=k)
    mu = adam_moments(jstate.opt_state, before)[0]
    updates_close("per instance", tree_from_module(one["model"], before),
                  jax.tree.map(np.asarray, jstate.params), before, mu,
                  float(tsolver.build_lr_schedule(one["task"]["cfg"])(0)))
    a, b = (r["per_instance"] for r in model_axis["ranks"])
    assert a["counts"] == b["counts"] == one["counts"] and a["checksum"] == b["checksum"]
    close_to_jax(a["metrics"], one["jax_metrics"])
    pastes_against_jax({k: torch.cat([a["rows"][k], b["rows"][k]]) for k in one["rows"]},
                       one["jax_rows"])
    for k, w in one["metrics"].items():
        assert a["metrics"][k] == pytest.approx(w, rel=1e-5, abs=1e-5), k
    assert one["jax_metrics"]["paste_num"] == a["metrics"]["paste_num"] == 1.0


def test_inference_on_the_first_rank_at_model_two(session, model_axis):
    """``inference_on_dataset`` at ``DATA_PARALLEL 1``, ``MODEL_PARALLEL 2``
    over two ranks: as the JAX loop on its first device, rank 0 maps and
    infers every row (batches of 3), rank 1 maps nothing and only takes part
    in the gathers. Each image's detections against the one-process loop's
    (batches of 4): equal classes and validity, boxes and scores within 1e-5
    of their largest, mask logits within 1e-4; the same results."""
    one = session["evaluate"]
    a, b = (r["evaluate"] for r in model_axis["ranks"])
    assert b == {"results": {}, "outputs": []}

    def by_image(outputs):
        rows = {}
        for out, ids in outputs:
            for j, i in enumerate(ids):
                rows[i] = {k: v[j] for k, v in out.items()}
        return rows

    got, want = by_image(a["outputs"]), by_image(one["outputs"])
    assert [ids for _, ids in a["outputs"]] == [[1, 2, 3], [4, 5, 6]] and set(got) == set(want)
    for i, w in want.items():
        for k in ("classes", "valid"):
            np.testing.assert_array_equal(got[i][k], w[k], err_msg=k)
        for k, tol in (("boxes", 1e-5), ("scores", 1e-5), ("mask_logits", 1e-4)):
            assert np.abs(got[i][k] - w[k]).max() <= tol * max(np.abs(w[k]).max(), 1e-12), k
    for task in one["results"]:
        for k, v in one["results"][task].items():
            assert a["results"][task][k] == pytest.approx(v, abs=1e-6, nan_ok=True), (task, k)
