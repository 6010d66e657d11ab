"""The port's solver and train steps against the JAX package's.

Schedules, learning-rate groups, the EMA update and one optimizer step on toy
parameters (optax against ``torch.optim`` on the same gradients), then the
step builders on the tiny detector: ``make_train_step`` for two steps and
``make_paste_train_step`` for one, float32 on the CPU, on the same weights,
batch and random draws (``jax_draws`` evaluates the keys the JAX step derives:
``fold_in(rng, step)`` first, then the keys of the heads).

Tolerances. Schedules agree to 1e-6 relative (or 1e-7 of the base rate where
the cosine nears zero: the JAX schedule is evaluated in float32). On the same gradients one
optimizer step agrees to 1e-6 absolute on parameters of size one. In the whole
step every metric agrees to 2e-4 relative. Adam's moments after a step are
linear and quadratic in the step's clipped gradients: per leaf they agree to
2e-4 (first) and 4e-4 (second) of the leaf's largest value. AdamW's first
steps move a weight by the learning rate times the *sign* of its gradient, and
an element whose gradient is rounding-sized (the key bias of an attention and
a convolution's bias in front of a GroupNorm have none mathematically) may
take either sign. So a parameter after a step is
compared through its update ``p_after - p_before``: no element differs by
more than twice the learning rate, and the elements whose first moment is
above 1e-3 of the leaf's largest and 1e-5 of the tree's largest differ by at
most 1e-2 of the learning rate.
The EMA copy is held to the same bounds scaled by ``1 - decay``; every bound
allows two float32 roundings of the stored value on top. The second
step starts on both sides from the JAX state after the first (parameters,
Adam moments and counts through ``load_adam_state``, EMA), so it is held to
the same bounds and not to two steps of drift.
"""
import importlib
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from divergen_tpu.engine import train_loop as jloop
from divergen_tpu.engine import trainer as jtrainer
from divergen_tpu.modeling.backbone import swin as jswin
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu.solver import build as jsolver
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.engine import train_loop as tloop
from divergen_tpu_torch.engine import trainer as ttrainer
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.solver import build as tsolver
from divergen_tpu_torch.utils.convert import load_adam_state, params_from_jax, tree_from_module
from test_torch_detector import TINY_SWIN, randomized, shape_init, t
from test_torch_train_losses import CANVAS, detector_batch, jax_draws, jx, torch_gt, train_cfg

torch.set_num_threads(1)


# -- schedules, groups, EMA ------------------------------------------------------------

STEPS = (0, 1, 5, 9, 10, 11, 59, 60, 61, 80, 99, 100)


@pytest.mark.parametrize("name", ["WarmupCosineLR", "WarmupMultiStepLR"])
def test_lr_schedules(name):
    from divergen_tpu.config import get_cfg as jget
    from divergen_tpu_torch.config import get_cfg as tget

    cfgs = []
    for get in (jget, tget):
        cfg = get()
        cfg.merge_from_list(["SOLVER.LR_SCHEDULER_NAME", name, "SOLVER.BASE_LR", 0.02,
                             "SOLVER.MAX_ITER", 100, "SOLVER.WARMUP_ITERS", 10,
                             "SOLVER.WARMUP_FACTOR", 0.01, "SOLVER.STEPS", (60, 80)])
        cfgs.append(cfg)
    want, got = jsolver.build_lr_schedule(cfgs[0]), tsolver.build_lr_schedule(cfgs[1])
    for step in STEPS:
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6, abs=1e-7 * 0.02), step
    assert got(0) == pytest.approx(0.02 * 0.01) and isinstance(got(3), float)
    bad = cfgs[1].clone()
    bad.SOLVER.LR_SCHEDULER_NAME = "Linear"
    with pytest.raises(ValueError, match="unknown LR scheduler"):
        tsolver.build_lr_schedule(bad)


def test_schedule_functions_with_their_defaults():
    for step in STEPS:
        assert tsolver.warmup_cosine_lr(1e-4, 1000, 100)(step) == pytest.approx(
            float(jsolver.warmup_cosine_lr(1e-4, 1000, 100)(step)), rel=1e-6)
        assert tsolver.warmup_multistep_lr(0.1, (60, 80), warmup_iters=10)(step) == pytest.approx(
            float(jsolver.warmup_multistep_lr(0.1, (60, 80), warmup_iters=10)(step)), rel=1e-6)
    assert tsolver.warmup_cosine_lr(1e-4, 0, 0)(0) == pytest.approx(1e-4)  # no division by zero


def test_lr_multiplier_labels():
    tree = {"params": {"bottom_up": {"stage0_block0": {"attn": {"qkv": {"kernel": 0, "bias": 0}}}},
                       "fpn": {"fpn_lateral3": {"kernel": 0}},
                       "roi_heads": {"box_predictor0": {"zs_weight": 0, "bbox_pred": {"bias": 0}}}}}
    custom = {"box_predictor": 0.1, "attn": 2.0}
    want = jsolver._lr_multiplier_labels(tree, "bottom_up", custom)
    names = ["bottom_up.stage0_block0.attn.qkv.weight", "bottom_up.stage0_block0.attn.qkv.bias",
             "fpn.fpn_lateral3.weight", "roi_heads.box_predictor0.zs_weight",
             "roi_heads.box_predictor0.bbox_pred.bias"]
    got = tsolver._lr_multiplier_labels(names, "bottom_up", custom)
    assert list(got.values()) == jax.tree_util.tree_leaves(want) == [
        "custom:attn", "custom:attn", "default", "custom:box_predictor", "custom:box_predictor"]
    assert set(tsolver._lr_multiplier_labels(names, "bottom_up", {}).values()) == {"backbone", "default"}


def test_ema_update():
    rng = np.random.RandomState(0)
    ema = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    p = {"a": rng.randn(3, 4).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    want = jsolver.ema_update(jx(ema), jx(p), 0.9)
    t_ema = {k: t(v).clone() for k, v in ema.items()}
    out = tsolver.ema_update(t_ema, {k: t(v).to(torch.bfloat16 if k == "b" else torch.float32)
                                     for k, v in p.items()}, 0.9)
    assert out is t_ema and out["b"].dtype == torch.float32  # in place, float32 kept
    np.testing.assert_allclose(out["a"].numpy(), np.asarray(want["a"]), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(out["b"].numpy(), np.asarray(want["b"]), atol=1e-3)  # bf16 params


class Toy(torch.nn.Module):
    def __init__(self, tree):
        super().__init__()
        self.bottom_up = torch.nn.Linear(4, 3)
        self.roi_heads = torch.nn.Linear(3, 2)
        self.load_state_dict(params_from_jax(tree, None))


@pytest.mark.parametrize("name,keys", [
    ("adamw, clipped", ["SOLVER.CLIP_GRADIENTS.ENABLED", True, "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 0.5]),
    ("adamw, below the clip", ["SOLVER.CLIP_GRADIENTS.ENABLED", True,
                               "SOLVER.CLIP_GRADIENTS.CLIP_VALUE", 1e3]),
    ("adamw, backbone x0.1", ["SOLVER.BACKBONE_MULTIPLIER", 0.1, "SOLVER.WEIGHT_DECAY", 0.05]),
    ("sgd", ["SOLVER.OPTIMIZER", "SGD", "SOLVER.WEIGHT_DECAY", 0.01]),
    ("sgd, custom group", ["SOLVER.OPTIMIZER", "SGD", "SOLVER.CUSTOM_MULTIPLIER", 3.0,
                           "SOLVER.CUSTOM_MULTIPLIER_NAME", ["roi_heads"]]),
], ids=lambda v: v if isinstance(v, str) else None)
def test_optimizer_steps_against_optax(name, keys):
    """Three steps on the same gradient sequence: parameters and the returned
    gradient norm agree to 1e-6. One leaf gets no gradient in torch (None) and
    zeros in JAX: it still decays."""
    from divergen_tpu.config import get_cfg as jget
    from divergen_tpu_torch.config import get_cfg as tget

    base = ["SOLVER.BASE_LR", 0.05, "SOLVER.WARMUP_ITERS", 2, "SOLVER.WARMUP_FACTOR", 0.1,
            "SOLVER.MAX_ITER", 10]
    jcfg, tcfg = jget(), tget()
    jcfg.merge_from_list(base + keys)
    tcfg.merge_from_list(base + keys)
    rng = np.random.RandomState(1)
    tree = {"params": {"bottom_up": {"kernel": rng.randn(4, 3).astype(np.float32),
                                     "bias": rng.randn(3).astype(np.float32)},
                       "roi_heads": {"kernel": rng.randn(3, 2).astype(np.float32),
                                     "bias": rng.randn(2).astype(np.float32)}}}
    opt = jsolver.build_optimizer(jcfg, jx(tree))
    jparams, jstate = jx(tree), opt.init(jx(tree))
    model = Toy(tree)
    topt = tsolver.build_optimizer(tcfg, model)
    for step in range(3):
        grads = jax.tree.map(lambda a: rng.randn(*a.shape).astype(np.float32), tree)
        grads["params"]["roi_heads"]["bias"] = np.zeros(2, np.float32)
        updates, jstate = opt.update(jx(grads), jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        topt.zero_grad()
        for pname, g in params_from_jax(grads, None).items():
            if pname != "roi_heads.bias":
                dict(model.named_parameters())[pname].grad = g.clone()
        norm = topt.step()
        assert float(norm) == pytest.approx(float(optax.global_norm(jx(grads))), rel=1e-6)
        got = tree_from_module(model, tree)
        for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(jparams)):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-6, rtol=1e-6, err_msg=f"step {step}")
    assert topt.count == 3
    assert not np.array_equal(tree_from_module(model, tree)["params"]["roi_heads"]["bias"],
                              tree["params"]["roi_heads"]["bias"]), name


def test_build_optimizer_refuses_an_unknown_name():
    from divergen_tpu_torch.config import get_cfg as tget

    cfg = tget()
    cfg.SOLVER.OPTIMIZER = "LION"
    with pytest.raises(ValueError, match="unknown optimizer"):
        tsolver.build_optimizer(cfg, torch.nn.Linear(2, 2))


def test_load_fed_weight(tmp_path):
    import json

    from divergen_tpu.config import get_cfg as jget
    from divergen_tpu_torch.config import get_cfg as tget

    path = tmp_path / "cat_info.json"
    path.write_text(json.dumps([{"id": 2, "image_count": 4}, {"id": 1, "image_count": 100}]))
    out = []
    for get, load in ((jget, jtrainer.load_fed_weight), (tget, ttrainer.load_fed_weight)):
        cfg = get()
        cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH = str(path)
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 3  # padded with ones
        out.append(np.asarray(load(cfg)))
        cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH = ""
        assert load(cfg) is None
    np.testing.assert_allclose(out[1], out[0], rtol=1e-6)
    np.testing.assert_allclose(out[1], [10.0, 2.0, 1.0])


# -- the step builders on the tiny detector --------------------------------------------------

SOLVER = {"SOLVER.BASE_LR": 1e-3, "SOLVER.WARMUP_ITERS": 4, "SOLVER.WARMUP_FACTOR": 0.1,
          "SOLVER.MAX_ITER": 100, "SOLVER.CLIP_GRADIENTS.ENABLED": True,
          "SOLVER.CLIP_GRADIENTS.CLIP_VALUE": 1.0, "SOLVER.BACKBONE_MULTIPLIER": 0.5,
          "MODEL.MODEL_EMA": 0.9}


@pytest.fixture(scope="module")
def tiny_swin():
    mp = pytest.MonkeyPatch()
    mp.setitem(jswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    yield importlib.import_module("__graft_entry__")
    mp.undo()


def adam_moments(opt_state, params):
    """(mu, nu, count) of an optax state built by ``build_optimizer``: the
    Adam states of the learning-rate groups, merged into whole trees."""
    is_adam = lambda x: isinstance(x, optax.ScaleByAdamState)
    adams = [s for s in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(s)]
    masked = lambda x: isinstance(x, optax.MaskedNode)
    pick = lambda *leaves: next(np.asarray(x) for x in leaves if not masked(x))
    mu = jax.tree.map(pick, *(s.mu for s in adams), is_leaf=masked)
    nu = jax.tree.map(pick, *(s.nu for s in adams), is_leaf=masked)
    assert jax.tree_util.tree_structure(mu) == jax.tree_util.tree_structure(params)
    counts = {int(s.count) for s in adams}
    assert len(counts) == 1
    return mu, nu, counts.pop()


def named_as_tree(cfg, named, like):
    """Tensors under the port's parameter names (an EMA copy, Adam moments) as
    a tree of numpy arrays under the flax names of ``like``."""
    holder = trcnn.build_model(cfg, input_size=CANVAS)
    holder.load_state_dict(dict(named))
    return tree_from_module(holder, like)


def moments_close(name, cfg, topt, tm, mu, nu, like):
    """Adam's moments after a step: linear (mu) and quadratic (nu) in the
    clipped gradients, so they hold the gradients of the step itself."""
    for key, want, tol in (("exp_avg", mu, 2e-4), ("exp_avg_sq", nu, 4e-4)):
        got = named_as_tree(cfg, {n: topt.optim.state[p][key] for n, p in tm.named_parameters()},
                            like)
        floor = 1e-6 * max(np.abs(w).max() for w in jax.tree_util.tree_leaves(want))
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree_util.tree_leaves(got)):
            assert np.abs(g - w).max() <= max(tol * np.abs(w).max(), floor), (name, key, path)


def updates_close(name, got_after, want_after, before, mu, lr, scale=1.0):
    """The bound of the module docstring on every leaf of a parameter tree;
    ``mu`` is Adam's first moment after the step (flax names)."""
    largest = max(np.abs(m).max() for m in jax.tree_util.tree_leaves(mu))
    for (path, b), g, w, m in zip(jax.tree_util.tree_leaves_with_path(before),
                                  jax.tree_util.tree_leaves(got_after),
                                  jax.tree_util.tree_leaves(want_after),
                                  jax.tree_util.tree_leaves(mu)):
        leaf = "/".join(str(p.key) for p in path)
        diff = np.abs((np.asarray(g) - b) - (np.asarray(w) - b))
        ulps = 2e-7 * max(1.0, np.abs(w).max())  # float32 rounding of the stored values
        assert diff.max() <= 2.0 * lr * scale + ulps, (name, leaf)
        sized = np.abs(m) > max(1e-3 * np.abs(m).max(), 1e-5 * largest)
        if sized.any():
            assert diff[sized].max() <= 1e-2 * lr * scale + ulps, (name, leaf, diff[sized].max() / lr)
        elif not m.any():  # no gradient at all (the unused s2 norm): only the decay moves it
            assert diff.max() <= 1e-6 * lr * scale + ulps, (name, leaf)


def metrics_close(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        assert float(got[k]) == pytest.approx(float(w), rel=2e-4, abs=1e-6), k


def test_make_train_step_two_steps(tiny_swin):
    images, sizes, gt, fed = detector_batch(41)
    rng = np.random.RandomState(42)
    key = jax.random.PRNGKey(8)
    jcfg = train_cfg(lambda: tiny_swin._small_cfg(backbone="swin"), **SOLVER)
    tcfg = train_cfg(lambda: tge._small_cfg(backbone="swin"), **SOLVER)
    jm = jrcnn.build_model(jcfg)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), gt=jx(gt), rng=key,
                                   fed_weight=jnp.asarray(fed), training=True), rng)
    opt = jsolver.build_optimizer(jcfg, params)
    jstate = jloop.create_train_state(jx(params), opt, ema=True)
    jstep = jloop.make_train_step(jm, opt, ema_decay=0.9, loss_weights={"loss_mask": 0.5},
                                  donate=False)
    jbatch = {"images": jnp.asarray(images), "image_sizes": jnp.asarray(sizes), "gt": jx(gt),
              "fed_weight": jnp.asarray(fed)}

    tm = trcnn.build_model(tcfg, input_size=CANVAS)
    tm.load_state_dict(params_from_jax(params, tm))
    topt = tsolver.build_optimizer(tcfg, tm)
    assert [g["name"] for g in topt.optim.param_groups] == ["default", "backbone"]
    tstate = tloop.create_train_state(tm, topt, ema=True)
    tstep = tloop.make_train_step(tm, topt, ema_decay=0.9, loss_weights={"loss_mask": 0.5})
    tbatch = {"images": t(images), "image_sizes": t(sizes), "gt": torch_gt(gt),
              "fed_weight": t(fed)}
    assert all(e.dtype == torch.float32 and e.data_ptr() != p.data_ptr()
               for e, p in zip(tstate.ema_params.values(), tm.parameters()))

    before = ema_before = jax.tree.map(np.asarray, params)
    for step in range(2):
        lr = float(jsolver.build_lr_schedule(jcfg)(step))
        jstate, want = jstep(jstate, jbatch, key)
        draws = jax_draws(jax.random.fold_in(key, step), 2, 24, 8)
        out, got = tstep(tstate, tbatch, draws)
        assert out is tstate and tstate.step == step + 1 == int(jstate.step) == topt.count
        metrics_close(got, want)
        assert got["total_loss"].item() == pytest.approx(
            sum(v.item() * (0.5 if k == "loss_mask" else 1.0) for k, v in got.items()
                if k.startswith("loss_")), rel=1e-5)
        after = jax.tree.map(np.asarray, jstate.params)
        mu, nu, count = adam_moments(jstate.opt_state, params)
        assert count == step + 1
        moments_close(f"step {step}", tcfg, topt, tm, mu, nu, params)
        updates_close(f"step {step}", tree_from_module(tm, params), after, before, mu, lr)
        want_ema = jax.tree.map(np.asarray, jstate.ema_params)
        updates_close(f"ema {step}", named_as_tree(tcfg, tstate.ema_params, params), want_ema,
                      ema_before, mu, lr, scale=0.1)
        # the next step starts from the JAX state on both sides
        tm.load_state_dict(params_from_jax(after, tm))
        load_adam_state(topt.optim, tm, mu, nu, count)
        for k, v in params_from_jax(want_ema, tm).items():
            tstate.ema_params[k].copy_(v)
        before, ema_before = after, want_ema
    assert float(want["grad_norm"]) > 1.0  # the clip was active


def test_make_paste_train_step(tiny_swin, tmp_path):
    """The federated loss's weights come from the config's frequency file, as
    in ``do_train`` (the JAX step maps every entry of the batch over images)."""
    images, sizes, gt, _ = detector_batch(43)
    rng = np.random.RandomState(44)
    key = jax.random.PRNGKey(9)
    freq = tmp_path / "cat_info.json"
    freq.write_text(json.dumps([{"id": i + 1, "image_count": int(c)}
                                for i, c in enumerate(rng.randint(1, 400, 8))]))
    keys = dict(SOLVER, **{"INPUT.USE_COPY_PASTE": True, "DATALOADER.MAX_PASTES": 3,
                           "DATALOADER.PATCH_SIZE": 16,
                           "MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH": str(freq)})
    jcfg = train_cfg(lambda: tiny_swin._small_cfg(backbone="swin"), **keys)
    tcfg = train_cfg(lambda: tge._small_cfg(backbone="swin"), **keys)
    p, ps = 3, 16
    xy = rng.rand(2, p, 2) * 30
    batch = {
        "image": images, "image_size": sizes, "gt": gt,
        "patches": np.concatenate([rng.rand(2, p, ps, ps, 3) * 255,
                                   rng.rand(2, p, ps, ps, 1) > 0.3], -1).astype(np.float32),
        "patch_boxes": np.concatenate([xy, xy + rng.rand(2, p, 2) * 20 + 8], -1).astype(np.float32),
        "patch_classes": rng.randint(0, 8, (2, p)).astype(np.int32),
        "patch_valid": np.array([[True, True, False], [True, False, False]]),
        "patch_flip": rng.rand(2, p) > 0.5,
    }
    jm = jrcnn.build_model(jcfg)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), gt=jx(gt), rng=key,
                                   training=True), rng)
    before = jax.tree.map(np.asarray, params)
    opt = jsolver.build_optimizer(jcfg, params)
    jstate = jloop.create_train_state(jx(params), opt, ema=True)
    jstate, want = jtrainer.make_paste_train_step(jm, opt, jcfg)(jstate, jx(batch), key)

    tm = trcnn.build_model(tcfg, input_size=CANVAS)
    tm.load_state_dict(params_from_jax(params, tm))
    topt = tsolver.build_optimizer(tcfg, tm)
    tstate = tloop.create_train_state(tm, topt, ema=True)
    tbatch = {k: torch_gt(v) if k == "gt" else t(np.asarray(v)) for k, v in batch.items()}
    tbatch["patch_classes"] = tbatch["patch_classes"].long()
    draws = jax_draws(jax.random.fold_in(key, 0), 2, 16 + 8 + p, 8)
    tstate, got = ttrainer.make_paste_train_step(tm, topt, tcfg)(tstate, tbatch, draws)
    assert tstate.step == 1 == int(jstate.step) and "grad_norm" not in got
    metrics_close(got, want)
    lr = float(jsolver.build_lr_schedule(jcfg)(0))
    mu, nu, _ = adam_moments(jstate.opt_state, params)
    moments_close("paste step", tcfg, topt, tm, mu, nu, params)
    updates_close("paste step", tree_from_module(tm, params), jax.tree.map(np.asarray, jstate.params),
                  before, mu, lr)
    # the pasted instances reached the losses: without the compositor they differ
    tcfg.INPUT.USE_COPY_PASTE = False
    tm2 = trcnn.build_model(tcfg, input_size=CANVAS)
    tm2.load_state_dict(params_from_jax(params, tm2))
    topt2 = tsolver.build_optimizer(tcfg, tm2)
    plain_draws = jax_draws(jax.random.fold_in(key, 0), 2, 24, 8)
    _, unpasted = ttrainer.make_paste_train_step(tm2, topt2, tcfg)(
        tloop.create_train_state(tm2, topt2, ema=False), tbatch, plain_draws)
    assert abs(unpasted["total_loss"].item() - got["total_loss"].item()) > 1e-3
    assert math.isfinite(unpasted["total_loss"].item())
