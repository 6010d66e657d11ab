"""The port's ``Checkpointer`` / ``PeriodicCheckpointer``
(``divergen_tpu_torch/engine/checkpoint.py``) and ``do_test``'s choice of
weights, on the CPU with the tiny Swin detector: a save / restore round trip
of model, EMA copy, optimizer and step; ``latest_step`` and ``max_to_keep``;
the periodic schedule of the JAX class; ``do_test`` evaluating the EMA
weights before the model's, from a state and from the newest checkpoint;
``RESET_CLS_TESTS`` through ``load_zs_weight`` and ``reset_cls_test``. Over
four gloo ranks as a 2 × 2 (data, model) grid, a model held as slices saves
and restores (``torch_ranks.checkpoint_grid``).
"""
import json

import numpy as np
import pytest
import torch

from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.config import get_cfg
from divergen_tpu_torch.data import catalog as tcat
from divergen_tpu_torch.data.datasets import lvis as tlvis
from divergen_tpu_torch.data.datasets.synthetic_lvis import write_synthetic_lvis
from divergen_tpu_torch.engine import eval_loop as teval
from divergen_tpu_torch.engine.checkpoint import Checkpointer, PeriodicCheckpointer
from divergen_tpu_torch.engine.train_loop import create_train_state
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.solver.build import build_optimizer
from test_torch_detector import TINY_SWIN, tiny_cfg
from torch_ranks import checkpoint_grid, run_ranks

torch.set_num_threads(1)

DATASET = "torch_port_checkpoint_synth_lvis"


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    mp = pytest.MonkeyPatch()
    mp.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    root = tmp_path_factory.mktemp("ckpt")
    cfg = tiny_cfg(lambda: tge._small_cfg(backbone="swin"))
    cfg.INPUT.TEST_SIZE = cfg.INPUT.MIN_SIZE_TEST = cfg.INPUT.MAX_SIZE_TEST = 64
    cfg.DATASETS.TEST = (DATASET,)
    cfg.OUTPUT_DIR = str(root / "out")
    files = write_synthetic_lvis(str(root / "data"), [(64, 64)] * 3, 8, seed=41)
    tcat.DatasetCatalog.remove(DATASET)
    tcat.MetadataCatalog.remove(DATASET)
    tlvis.register_lvis_instances(DATASET, {}, files["json_file"], files["image_root"])
    yield cfg
    tcat.DatasetCatalog.remove(DATASET)
    tcat.MetadataCatalog.remove(DATASET)
    mp.undo()


def make_state(cfg, seed, ema=True):
    model = trcnn.build_model(cfg, input_size=(64, 64), param_dtype=torch.float32)
    tge.fast_init_(model, torch.Generator().manual_seed(seed))
    return create_train_state(model, build_optimizer(cfg, model), ema=ema)


def perturb(state, seed):
    """One optimizer step on random gradients and an EMA copy that differs
    from the parameters, so every part of the state is non-trivial."""
    gen = torch.Generator().manual_seed(seed)
    for p in state.model.parameters():
        p.grad = torch.randn(p.shape, generator=gen) * 1e-2
    state.optimizer.step()
    state.step += 1
    for k, v in state.ema_params.items():
        v.add_(torch.randn(v.shape, generator=gen) * 1e-3)


def test_round_trip_latest_step_and_max_to_keep(setup, tmp_path):
    cfg = setup
    state = make_state(cfg, 0)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    assert ckpt.latest_step() is None
    for step in range(1, 5):
        perturb(state, step)
        ckpt.save(step, state)
    ckpt.wait()
    assert ckpt.all_steps() == [3, 4] and ckpt.latest_step() == 4
    fresh = make_state(cfg, 9)
    restored = ckpt.restore(fresh)
    assert restored is fresh and restored.step == state.step == 4
    for (k, a), (_, b) in zip(state.model.state_dict().items(), restored.model.state_dict().items()):
        assert torch.equal(a, b), k
    for k in state.ema_params:
        assert torch.equal(state.ema_params[k], restored.ema_params[k]), k
    so, ro = state.optimizer.optim.state_dict(), restored.optimizer.optim.state_dict()
    assert restored.optimizer.count == state.optimizer.count == 4
    assert so["param_groups"] == ro["param_groups"]
    for i in so["state"]:
        for k, v in so["state"][i].items():
            assert torch.equal(torch.as_tensor(v), torch.as_tensor(ro["state"][i][k])), (i, k)
    # an older step on request; resume_or_load at the newest or not at all
    assert ckpt.restore(make_state(cfg, 9), step=3).step == 3
    st, it = ckpt.resume_or_load(make_state(cfg, 9))
    assert it == 4 and st.step == 4
    st, it = ckpt.resume_or_load(fresh, resume=False)
    assert it == 0 and st is fresh
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(make_state(cfg, 9))


def test_periodic_checkpointer(setup, tmp_path):
    state = make_state(setup, 1, ema=False)
    ckpt = Checkpointer(str(tmp_path), max_to_keep=0)  # keep all
    periodic = PeriodicCheckpointer(ckpt, period=2, max_iter=5)
    for it in range(5):
        state.step = it + 1
        periodic.step(it, state)
    assert ckpt.all_steps() == [2, 4, 5]
    assert ckpt.load(5)["ema_params"] is None


def run_do_test(monkeypatch, cfg, **kw):
    """do_test's result dict and the detection records its evaluator saw (AP
    alone says little on random weights)."""
    seen = []
    build = teval.build_evaluator

    def recording(cfg_, name):
        seen.append(build(cfg_, name))
        return seen[-1]

    monkeypatch.setattr(teval, "build_evaluator", recording)
    results = teval.do_test(cfg, device="cpu", **kw)
    monkeypatch.setattr(teval, "build_evaluator", build)
    return results, [ev._predictions for ev in seen]


def test_do_test_takes_ema_first(setup, monkeypatch):
    cfg = setup
    state = make_state(cfg, 2)
    perturb(state, 7)
    for v in state.ema_params.values():  # an EMA far enough away to change detections
        v.mul_(1.5)
    got, got_dets = run_do_test(monkeypatch, cfg, state=state)
    # the same weights as the model's own parameters, without an EMA copy
    ema_model = make_state(cfg, 3, ema=False)
    ema_model.model.load_state_dict(state.model.state_dict())
    with torch.no_grad():
        for k, p in ema_model.model.named_parameters():
            p.copy_(state.ema_params[k])
    want, want_dets = run_do_test(monkeypatch, cfg, state=ema_model)
    plain = state.ema_params
    state.ema_params = None
    _, without_dets = run_do_test(monkeypatch, cfg, state=state)
    state.ema_params = plain
    assert len(got_dets[0]) > 10
    assert got_dets == want_dets and got_dets != without_dets
    assert json.dumps(got, sort_keys=True) == json.dumps(want, sort_keys=True)
    # from the newest checkpoint: the same as from the state
    Checkpointer(cfg.OUTPUT_DIR).save(state.step, state)
    from_ckpt, ckpt_dets = run_do_test(monkeypatch, cfg, resume=True)
    assert ckpt_dets == got_dets
    assert json.dumps(from_ckpt, sort_keys=True) == json.dumps(got, sort_keys=True)
    for task in ("bbox", "segm"):
        assert {"AP", "APr", "APc", "APf"} <= set(got[DATASET][task])


def test_do_test_reset_cls_tests(setup, tmp_path, monkeypatch):
    """A zero-shot detector gets an 8-class test vocabulary from a (C, zs_dim)
    file: do_test equals the model swapped by hand through reset_cls_test."""
    cfg = setup.clone()
    cfg.MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS = True
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    zs_dim = cfg.MODEL.ROI_BOX_HEAD.ZEROSHOT_WEIGHT_DIM
    np.save(tmp_path / "zs.npy", np.random.RandomState(4).randn(8, zs_dim).astype(np.float32))
    cfg.MODEL.RESET_CLS_TESTS = True
    cfg.MODEL.TEST_CLASSIFIERS = [str(tmp_path / "zs.npy")]
    cfg.MODEL.TEST_NUM_CLASSES = [8]
    state = make_state(cfg, 5, ema=False)
    got, got_dets = run_do_test(monkeypatch, cfg, state=state)
    model = trcnn.build_model(cfg, input_size=(64, 64))
    model.load_state_dict(state.model.state_dict())
    trcnn.reset_cls_test(model, trcnn.load_zs_weight(tmp_path / "zs.npy", zs_dim=zs_dim))
    assert model.roi_cfg.num_classes == 8
    evaluator = teval.build_evaluator(cfg, DATASET)
    want = teval.inference_on_dataset(model, None, cfg, DATASET, evaluator)
    assert got_dets == [evaluator._predictions]
    cfg.MODEL.RESET_CLS_TESTS = False  # the trained 5-class vocabulary scores otherwise
    assert run_do_test(monkeypatch, cfg, state=state)[1] != got_dets
    assert json.dumps(got[DATASET], sort_keys=True) == json.dumps(want, sort_keys=True)


def test_save_and_restore_over_a_two_by_two_grid(tmp_path):
    """Data 2 × model 2: only the writer's model row (ranks 0 and 1)
    gathers, and it decides as one whether the step exists: a second save
    is skipped without a gather, and so is a save in which rank 1 alone does
    not see the file. The file holds the full tensors of an unsliced model
    (equal bit for bit to the gathered ones); every rank restores its own
    slices of the parameters, moments and EMA copy bit for bit; and the
    file restores at model 1 into the unsliced MLP."""
    ranks = run_ranks(checkpoint_grid, 4, tmp_path, tmp_path)
    first = ranks[0]["gathers"][0]
    assert first > 0 and [r["gathers"] for r in ranks] == [[first, 0, 0]] * 2 + [[0, 0, 0]] * 2
    assert set(ranks[0]["sliced"]) == {"0.weight", "2.weight"}
    for r in ranks:
        for n, v in r["slices"].items():
            assert torch.equal(r["restored"][n], v), n
        for got, want in zip(r["restored_moments"], r["moments"]):
            assert all(torch.equal(got[k], want[k]) for k in want)
    for d in (0, 1):  # the data rows took different rows, the grid one mean gradient
        assert all(torch.equal(ranks[2 * d]["full"][n], ranks[0]["full"][n])
                   for n in ranks[0]["full"])
    raw = Checkpointer(str(tmp_path / "shared")).load(1)
    for n, v in ranks[0]["full"].items():
        assert torch.equal(raw["model"][n], v) and torch.equal(raw["ema_params"][n],
                                                               ranks[0]["ema"][n]), n
    assert not (tmp_path / "own" / "checkpoints" / "step_1.pt").exists()
    model = torch.nn.Sequential(torch.nn.Linear(8, 32), torch.nn.ReLU(), torch.nn.Linear(32, 8))
    state = create_train_state(model, build_optimizer(get_cfg(), model), ema=True)
    Checkpointer(str(tmp_path / "shared")).restore(state)
    assert state.step == 1
    for n, p in model.named_parameters():
        assert torch.equal(p.detach(), ranks[0]["full"][n]), n
        assert torch.equal(state.ema_params[n], ranks[0]["ema"][n]), n
