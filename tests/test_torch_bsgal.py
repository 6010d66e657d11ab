"""The port's BSGAL active selection against the JAX package's.

The helpers (``tree_cosine``, ``update_bank``, ``dynamic_threshold``,
``push_sim``, ``unique_paste_ids``, ``apply_compare_baseline``,
``ActiveConfig.from_cfg`` with every ``ONCE_MODE`` string it parses,
``DecisionLogger`` and ``paste_ins_rows``) on seeded inputs: integers,
decisions and the log files exactly (byte for byte), float32 sums to
rounding (1e-6 relative).

Then ``make_active_train_step`` on the tiny Swin detector, float32 on the
CPU, against the JAX step on the same weights (``params_from_jax``), batch,
probe and random draws (the four keys the JAX step splits from
``fold_in(rng, step)``: the heads' draws of each forward through
``jax_draws``, the compare uniform by name): the same decision, ``grad_sim``
and the threshold within 1e-4, every metric within 2e-4 relative, and the
parameters, Adam's moments and the EMA copy after the step within the bounds
of ``test_torch_train_step.py``. The default mode (gradient compare from one
forward, ``paste_or_ori``) pastes; ``paste_or_zero`` with a threshold above
any cosine discards, and its update is then weight decay alone on both
sides (AdamW counts the step for every parameter). The cross-mode matrix runs the other decision machineries (two
forwards, the loss compare with its inner SGD step, ``only_gt``, dynamic
thresholds with per-instance decisions) against the JAX step as well; it is
marked slow, since each mode compiles the whole JAX step anew (about a
minute on one core).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.active import bsgal as jb
from divergen_tpu.config import get_cfg as jget
from divergen_tpu.engine import train_loop as jloop
from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.solver import build as jsolver
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.active import bsgal as tb
from divergen_tpu_torch.config import get_cfg as tget
from divergen_tpu_torch.engine import train_loop as tloop
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.solver import build as tsolver
from divergen_tpu_torch.utils.convert import params_from_jax, tree_from_module
from test_torch_detector import TINY_SWIN, randomized, shape_init, t
from test_torch_train_losses import CANVAS, detector_batch, jax_draws, jx, torch_gt, train_cfg
from test_torch_train_step import SOLVER, adam_moments, moments_close, updates_close

torch.set_num_threads(1)


# -- the helpers -------------------------------------------------------------------------

def _named(rng, shapes):
    return {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}


SHAPES = {"a.weight": (3, 4), "b.bias": (5,), "c.table": (2, 3, 2)}


def test_tree_cosine_and_update_bank():
    rng = np.random.RandomState(0)
    a, b = _named(rng, SHAPES), _named(rng, SHAPES)
    want = float(jb.tree_cosine(jx(a), jx(b)))
    got = float(tb.tree_cosine({k: t(v) for k, v in a.items()}, {k: t(v) for k, v in b.items()}))
    assert got == pytest.approx(want, rel=1e-6)
    zeros = {k: np.zeros_like(v) for k, v in a.items()}
    assert float(tb.tree_cosine({k: t(v) for k, v in zeros.items()},
                                {k: t(v) for k, v in b.items()})) == 0.0  # no division by zero

    jstate = jb.init_active_state(jx(a), queue_size=6)
    tstate = tb.init_active_state({k: t(v) for k, v in a.items()}, queue_size=6)
    for g in (a, b, _named(rng, SHAPES)):  # the first update copies, the next ones average
        jstate = jb.update_bank(jstate, jx(g), 0.1)
        tstate = tb.update_bank(tstate, {k: t(v) for k, v in g.items()}, 0.1)
        for k in g:
            np.testing.assert_allclose(tstate.grad_bank[k].numpy(), np.asarray(jstate.grad_bank[k]),
                                       rtol=1e-6, atol=1e-7)
        assert bool(tstate.bank_initialized) == bool(jstate.bank_initialized) is True
    assert all(v.dtype == torch.float32 for v in tstate.grad_bank.values())


def test_queue_threshold_ids_and_baselines():
    rng = np.random.RandomState(1)
    params = {"w": np.zeros((2,), np.float32)}
    jstate = jb.init_active_state(jx(params), queue_size=5)
    tstate = tb.init_active_state({"w": t(params["w"])}, queue_size=5)
    for sim in rng.randn(8).astype(np.float32):  # wraps around the ring
        for pct in (0.0, 0.3, 0.5, 0.9, 1.0):
            assert float(tb.dynamic_threshold(tstate, pct)) == float(jb.dynamic_threshold(jstate, pct))
        pct = torch.tensor(0.37)
        assert float(tb.dynamic_threshold(tstate, pct)) == float(
            jb.dynamic_threshold(jstate, jnp.float32(0.37)))
        jstate = jb.push_sim(jstate, jnp.float32(sim))
        tstate = tb.push_sim(tstate, torch.tensor(sim))
        np.testing.assert_array_equal(tstate.sim_queue.numpy(), np.asarray(jstate.sim_queue))
        assert (int(tstate.queue_pos), int(tstate.queue_filled)) == (
            int(jstate.queue_pos), int(jstate.queue_filled))

    src = rng.randint(0, 3, (3, 6)).astype(np.int32)
    valid = rng.rand(3, 6) > 0.3
    np.testing.assert_array_equal(tb.unique_paste_ids(t(src).long(), t(valid)).numpy(),
                                  np.asarray(jb.unique_paste_ids(jnp.asarray(src), jnp.asarray(valid))))

    key = jax.random.PRNGKey(3)
    u = {"compare": np.asarray(jax.random.uniform(key, ()))}
    for compare in ("default", "contra", "all", "random", "random_0.3", "random_0.9", "prob",
                    "schedule"):
        for dec in (False, True):
            for step in (0, 40, 200):
                want = bool(jb.apply_compare_baseline(compare, jnp.asarray(dec), key,
                                                      jnp.asarray(step, jnp.int32), 100))
                got = bool(tb.apply_compare_baseline(compare, torch.tensor(dec), u, step, 100))
                assert got == want, (compare, dec, step)
    with pytest.raises(NotImplementedError, match="ACTIVE.COMPARE"):
        tb.apply_compare_baseline("median", torch.tensor(True), u, 0, 100)


ONCE_MODES = ["", "only_gt", "only_paste_0.2", "only_paste_-0.1", "only_paste_dynamic_0.3",
              "only_paste_dynamic_linear_0.2_0.8"]


@pytest.mark.parametrize("once", ONCE_MODES)
def test_active_config_from_cfg(once):
    keys = ["MODEL.ACTIVE.ONCE_MODE", once, "MODEL.ACTIVE.MODE", "paste_or_zero",
            "MODEL.ACTIVE.PER_INSTANCE", True, "INPUT.CP_METHOD", "['alpha']",
            "MODEL.ACTIVE.BANK_UPDATE_PERIOD", 3, "SOLVER.MAX_ITER", 500]
    cfgs = []
    for get in (jget, tget):
        cfg = get()
        cfg.merge_from_list(keys)
        cfgs.append(cfg)
    want, got = jb.ActiveConfig.from_cfg(cfgs[0]), tb.ActiveConfig.from_cfg(cfgs[1])
    assert got.__dict__ == want.__dict__
    assert got.cp_mode == "alpha" and got.per_paste_rows and got.bank_update_period == 3


def test_active_config_refuses():
    for keys, match in ((["MODEL.ACTIVE.ONCE_MODE", "only_loss"], "ONCE_MODE"),
                        (["MODEL.ACTIVE.OPTIMIZER", "ADAM"], "ACTIVE.OPTIMIZER")):
        for get, mod in ((jget, jb), (tget, tb)):
            cfg = get()
            cfg.merge_from_list(keys)
            with pytest.raises(NotImplementedError, match=match):
                mod.ActiveConfig.from_cfg(cfg)


def test_decision_logs_byte_equal(tmp_path):
    rng = np.random.RandomState(2)
    b, n, p = 2, 6, 3
    ids = np.zeros((b, n), np.int64)
    ids[0, 3:5] = [1, 2]
    ids[1, 2] = 3
    aux = {"gt_ids": ids, "gt_valid": ids >= 0, "gt_classes": rng.randint(0, 9, (b, n)),
           "loss": rng.rand(b, 10).astype(np.float32), "id": rng.randint(0, 4, (b, 10)),
           "max_class": rng.randint(0, 9, (b, 10)), "max_loss": rng.rand(b, 10).astype(np.float32)}
    names = np.array([["x.png", "y_img.png|y_mask.png", ""], ["z.png", "", ""]], dtype="<U256")
    rows_t, rows_j = tb.paste_ins_rows(aux, names), jb.paste_ins_rows(aux, names)
    assert rows_t == rows_j and len(rows_t) == 3
    assert tb.paste_ins_rows(aux, None) == jb.paste_ins_rows(aux, None)
    for mod, out in ((jb, tmp_path / "jax"), (tb, tmp_path / "torch")):
        log = mod.DecisionLogger(str(out), rank=0)
        for it in (0, 1, 9999, 10000):
            log.log_decision(it, ["a.png", "b.png"], [3, -1], it % 2, 0.123456, -0.05, 4)
            log.log_paste_ins(it, rows_j, 1, 3)
        log.close()
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.txt"))
    assert [str(f) for f in files] == ["paste_ins_loss/rank_0/10000.txt",
                                       "paste_ins_loss/rank_0/20000.txt",
                                       "paste_source/rank_0/10000.txt",
                                       "paste_source/rank_0/20000.txt"]
    for f in files:
        assert (tmp_path / "torch" / f).read_bytes() == (tmp_path / "jax" / f).read_bytes()


# -- one step on the tiny detector -------------------------------------------------------

P, PS = 3, 16
ACTIVE = dict(SOLVER, **{"MODEL.ACTIVE.ENABLED": True, "INPUT.USE_COPY_PASTE": True,
                         "DATALOADER.MAX_PASTES": P, "DATALOADER.PATCH_SIZE": PS,
                         "MODEL.ACTIVE.PROBE_BATCH": 2})


@pytest.fixture(scope="module")
def tiny_swin():
    mp = pytest.MonkeyPatch()
    mp.setitem(jswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    yield importlib.import_module("__graft_entry__")
    mp.undo()


def active_batch(seed):
    images, sizes, gt, _ = detector_batch(seed)
    rng = np.random.RandomState(seed + 1)
    gt["instance_source"][:] = 0
    xy = rng.rand(2, P, 2) * 30
    batch = {
        "image": images, "image_size": sizes, "gt": gt,
        "patches": np.concatenate([rng.rand(2, P, PS, PS, 3) * 255,
                                   rng.rand(2, P, PS, PS, 1) > 0.3], -1).astype(np.float32),
        "patch_boxes": np.concatenate([xy, xy + rng.rand(2, P, 2) * 20 + 8], -1).astype(np.float32),
        "patch_classes": rng.randint(0, 8, (2, P)).astype(np.int32),
        "patch_valid": np.array([[True, True, False], [True, False, False]]),
        "patch_flip": rng.rand(2, P) > 0.5,
    }
    p_images, p_sizes, p_gt, _ = detector_batch(seed + 2)
    p_gt["instance_source"][:] = 0
    batch["probe"] = {"image": p_images, "image_size": p_sizes, "gt": p_gt}
    return batch


def torch_batch(batch):
    out = {k: torch_gt(v) if k == "gt" else t(np.asarray(v)) for k, v in batch.items()
           if k != "probe"}
    out["patch_classes"] = out["patch_classes"].long()
    out["probe"] = {k: torch_gt(v) if k == "gt" else t(np.asarray(v))
                    for k, v in batch["probe"].items()}
    return out


def step_draws(key, step, compare_only=False):
    """The draws of the port's step from the JAX step's key: the probe's
    forward has the ground truth as proposals (its rows: 8 proposals and the 8
    appended gt), the pasted and final forwards 16 proposals and 8 + 3 gt."""
    k_probe, k_paste, k_final, k_cmp = jax.random.split(jax.random.fold_in(key, step), 4)
    rows = 16 + 8 + P
    return {"probe": jax_draws(k_probe, 2, 16, 8), "paste": jax_draws(k_paste, 2, rows, 8),
            "final": jax_draws(k_final, 2, rows, 8),
            "compare": np.asarray(jax.random.uniform(k_cmp, ()))}


def run_both(tiny, keys, seed=51, key_seed=10):
    """One active step of each package from the same weights, batch and
    draws. Returns (jax (state, astate, metrics), torch (state, astate,
    metrics, model, optimizer), the initial params, cfg, lr)."""
    keys = dict(ACTIVE, **keys)
    jcfg = train_cfg(lambda: tiny._small_cfg(backbone="swin"), **keys)
    tcfg = train_cfg(tge._small_cfg, **keys)
    batch = active_batch(seed)
    key = jax.random.PRNGKey(key_seed)
    rng = np.random.RandomState(seed + 7)
    jm = jrcnn.build_model(jcfg)
    params = randomized(shape_init(jm, jnp.asarray(batch["image"]), jnp.asarray(batch["image_size"]),
                                   gt=jx(batch["gt"]), rng=key, training=True), rng)
    opt = jsolver.build_optimizer(jcfg, params)
    jstate = jloop.create_train_state(jx(params), opt, ema=True)
    jastate = jb.init_active_state(jstate.params, queue_size=8)
    jstep = jb.make_active_train_step(jm, opt, jcfg)
    jout = jstep(jstate, jastate, jx(batch), key)

    tm = trcnn.build_model(tcfg, input_size=CANVAS)
    tm.load_state_dict(params_from_jax(params, tm))
    topt = tsolver.build_optimizer(tcfg, tm)
    tstate = tloop.create_train_state(tm, topt, ema=True)
    tastate = tb.init_active_state(dict(tm.named_parameters()), queue_size=8)
    tout = tb.make_active_train_step(tm, topt, tcfg)(tstate, tastate, torch_batch(batch),
                                                     step_draws(key, 0))
    lr = float(jsolver.build_lr_schedule(jcfg)(0))
    return jout, (*tout, tm, topt), jax.tree.map(np.asarray, params), tcfg, lr


def check_step(jout, tout, before, tcfg, lr):
    (jstate, jastate, want), (tstate, tastate, got, tm, topt) = jout, tout
    want = dict(want)
    want.pop("aux_paste_rows", None)
    got = {k: v for k, v in got.items() if k != "aux_paste_rows"}
    assert set(got) == set(want)
    assert float(got["paste_used"]) == float(want["paste_used"])
    for k in ("grad_sim", "threshold"):
        assert float(got[k]) == pytest.approx(float(want[k]), abs=1e-4), k
    for k, w in want.items():
        if k not in ("grad_sim", "threshold"):
            assert float(got[k]) == pytest.approx(float(w), rel=2e-4, abs=1e-6), k
    assert tstate.step == 1 == int(jstate.step) == topt.count
    assert (int(tastate.n_paste), int(tastate.n_discard)) == (int(jastate.n_paste),
                                                             int(jastate.n_discard))
    np.testing.assert_allclose(tastate.sim_queue.numpy(), np.asarray(jastate.sim_queue), atol=1e-4)
    mu, nu, _ = adam_moments(jstate.opt_state, before)
    moments_close("active step", tcfg, topt, tm, mu, nu, before)
    updates_close("active step", tree_from_module(tm, before),
                  jax.tree.map(np.asarray, jstate.params), before, mu, lr)
    # the bank: the probe gradient, materialized (zeros where the probe's loss
    # does not reach, e.g. the CenterNet head)
    bank = tree_from_module(_holder(tcfg, tastate.grad_bank), before)
    for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(jastate.grad_bank),
                            jax.tree_util.tree_leaves(bank)):
        w = np.asarray(w)
        assert np.abs(g - w).max() <= 2e-4 * max(np.abs(w).max(), 1e-3), path
    return got


def _holder(cfg, named):
    holder = trcnn.build_model(cfg, input_size=CANVAS)
    holder.load_state_dict(dict(named), strict=False)
    return holder


def test_active_step_default_mode(tiny_swin):
    jout, tout, before, tcfg, lr = run_both(tiny_swin, {})
    got = check_step(jout, tout, before, tcfg, lr)
    assert float(got["paste_used"]) == 1.0 and float(got["paste_num"]) == 3.0
    # the CenterNet head takes no gradient from the probe: its bank entry is zero
    bank = tout[1].grad_bank
    assert not bank["centernet_head.agn_hm.conv.weight"].any()
    assert bank["roi_heads.box_predictor0.cls_score.weight"].abs().max() > 0


def test_active_step_paste_or_zero_discard(tiny_swin):
    keys = {"MODEL.ACTIVE.MODE": "paste_or_zero", "MODEL.ACTIVE.THRESHOLD": 2.0}
    jout, tout, before, tcfg, lr = run_both(tiny_swin, keys, seed=61, key_seed=11)
    got = check_step(jout, tout, before, tcfg, lr)
    assert float(got["paste_used"]) == 0.0 and int(tout[1].n_discard) == 1
    # zero gradients, not None: AdamW still took the step for every parameter
    # (its count rose, its first moment stays zero), as optax does
    states = [tout[4].optim.state[p] for p in tout[3].parameters()]
    assert len(states) == len(list(tout[3].parameters())) and tout[4].count == 1
    assert all(int(s["step"]) == 1 and not s["exp_avg"].any() for s in states)


CROSS_MODES = {
    "two forwards": {"MODEL.ACTIVE.FORWARD_ONCE": False},
    "loss compare": {"MODEL.ACTIVE.GRAD_COMPARE": False, "MODEL.ACTIVE.INNER_LR": 0.05},
    "only_gt": {"MODEL.ACTIVE.ONCE_MODE": "only_gt"},
    "dynamic, per instance, random compare": {
        "MODEL.ACTIVE.ONCE_MODE": "only_paste_dynamic_linear_0.2_0.8",
        "MODEL.ACTIVE.PER_INSTANCE": True, "MODEL.ACTIVE.COMPARE": "random_0.7",
        "MODEL.ACTIVE.MODE": "paste_only"},
}


@pytest.mark.slow  # one JAX compile of the whole active step (~65 s on one core) per mode
@pytest.mark.parametrize("mode", list(CROSS_MODES))
def test_active_step_cross_modes(tiny_swin, mode):
    jout, tout, before, tcfg, lr = run_both(tiny_swin, CROSS_MODES[mode], seed=71, key_seed=12)
    check_step(jout, tout, before, tcfg, lr)
    if "per instance" in mode:
        rows_j, rows_t = jout[2]["aux_paste_rows"], tout[2]["aux_paste_rows"]
        for k in ("id", "gt_ids", "gt_valid", "gt_classes", "max_class"):
            np.testing.assert_array_equal(rows_t[k].numpy(), np.asarray(rows_j[k]), err_msg=k)
        np.testing.assert_allclose(rows_t["loss"].numpy(), np.asarray(rows_j["loss"]),
                                   rtol=2e-4, atol=1e-6)
