"""The port's training entry on the CPU: ``engine/events.py`` against the JAX
package's, ``Checkpointer`` with an ``ActiveState``, and ``do_train`` through
``python -m divergen_tpu_torch.train_net``'s ``main`` for both training
configs (``configs/BSGAL_SwinL.yaml``: BSGAL's active step; and
``configs/DiverGen_swinL.yaml``: copy-paste from the pool and self-copy,
remat on, the profiler window over one iteration) at a tiny size (the tiny Swin, 64², float32) on a synthetic
LVIS-format set and pool written under a ``DETECTRON2_DATASETS`` root: two
steps each, then one more with ``--resume``.

Checked: the files (``metrics.json`` with finite values, the checkpoints,
``grad_bank/`` with its newest two saves, the decision log with one line per
pasted file and step), the counters (the step, BSGAL's paste and discard
counts summing to the steps taken, across the resume), that a resume starts
from the newest checkpoint and bank, the in-training ``do_test`` result,
and ``--eval-only``.
"""
import json
import math
import os

import numpy as np
import pytest
import torch

from divergen_tpu.engine import events as jevents
from divergen_tpu_torch import train_net
from divergen_tpu_torch.active.bsgal import init_active_state, push_sim
from divergen_tpu_torch.data import DatasetCatalog, MetadataCatalog
from divergen_tpu_torch.data.datasets.synthetic_lvis import write_training_root
from divergen_tpu_torch.engine import events as tevents
from divergen_tpu_torch.engine.checkpoint import Checkpointer
from divergen_tpu_torch.engine.trainer import do_train
from divergen_tpu_torch.modeling.backbone import swin as tswin
from test_torch_detector import TINY_SWIN

torch.set_num_threads(1)


# -- events ------------------------------------------------------------------------------

def test_events_write_the_same_metrics_json(tmp_path, caplog):
    lines = []
    for mod in (jevents, tevents):
        path = tmp_path / f"{mod.__name__.split('.')[0]}.json"
        storage = mod.EventStorage(start_iter=3, window=4)
        writers = [mod.JSONWriter(str(path)), mod.CommonMetricPrinter(max_iter=50)]
        r = np.random.RandomState(1)
        with caplog.at_level("INFO"):
            for _ in range(6):
                storage.put_scalars(total_loss=r.rand() * 3, loss_cls=np.float32(r.rand()),
                                    data_time=r.rand() * 0.1, time=r.rand(), lr=1e-4)
                for w in writers:
                    w.write(storage)
                storage.step()
        writers[0].close()
        lines.append((path.read_text(), [rec.getMessage() for rec in caplog.records]))
        caplog.clear()
    assert lines[1][0] == lines[0][0] and lines[1][0].count("\n") == 6
    assert lines[1][1] == lines[0][1] and "eta:" in lines[1][1][0]
    assert not hasattr(tevents, "TensorboardWriter")
    hist = tevents.HistoryBuffer(window=3)
    for v in (5.0, 1.0, 3.0, 2.0):
        hist.update(v)
    assert (hist.latest, hist.median(), hist.avg(), hist.global_avg()) == (2.0, 2.0, 2.0, 2.75)


def test_checkpointer_saves_an_active_state(tmp_path):
    params = {"a.weight": torch.randn(3, 2), "b.bias": torch.randn(4)}
    state = init_active_state(params, queue_size=5)
    for k in params:
        state.grad_bank[k].normal_()
    state.bank_initialized.fill_(True)
    state.n_paste.fill_(4)
    state.n_discard.fill_(2)
    push_sim(state, torch.tensor(0.25))
    ckpt = Checkpointer(str(tmp_path), max_to_keep=2)
    for step in (3, 6, 9):
        ckpt.save(step, state)
    assert ckpt.all_steps() == [6, 9]
    fresh = init_active_state(params, queue_size=5)
    out, step = ckpt.resume_or_load(fresh, resume=True)
    assert out is fresh and step == 9
    for k in params:
        assert torch.equal(fresh.grad_bank[k], state.grad_bank[k])
    for k in ("bank_initialized", "sim_queue", "queue_pos", "queue_filled", "n_paste", "n_discard"):
        assert torch.equal(getattr(fresh, k), getattr(state, k)), k
    other = init_active_state({"c": torch.zeros(2)}, queue_size=5)
    with pytest.raises(KeyError, match="other parameters"):
        ckpt.restore(other)


# -- do_train through train_net ----------------------------------------------------------

TINY = ["MODEL.SWIN.SIZE", "tiny", "MODEL.FPN.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
        "MODEL.ROI_MASK_HEAD.CONV_DIM", "16", "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "32",
        "MODEL.CENTERNET.PRE_NMS_TOPK_TRAIN", "32", "MODEL.CENTERNET.POST_NMS_TOPK_TRAIN", "16",
        "MODEL.CENTERNET.PRE_NMS_TOPK_TEST", "32", "MODEL.CENTERNET.POST_NMS_TOPK_TEST", "16",
        "TEST.DETECTIONS_PER_IMAGE", "8", "FP16", "false", "INPUT.TRAIN_SIZE", "64",
        "INPUT.TEST_SIZE", "64", "INPUT.MIN_SIZE_TEST", "64", "INPUT.MAX_SIZE_TEST", "64",
        "DATALOADER.MAX_INSTANCES", "8", "DATALOADER.MAX_PASTES", "3", "DATALOADER.PATCH_SIZE", "16",
        "DATALOADER.NUM_WORKERS", "2", "SOLVER.IMS_PER_BATCH", "2", "SOLVER.CHECKPOINT_PERIOD", "1",
        "MODEL.ACTIVE.BANK_CKPT_PERIOD", "1", "MODEL.ACTIVE.LOG_PERIOD", "1",
        "TEST.EVAL_PERIOD", "2"]


@pytest.fixture()
def tiny_swin(monkeypatch):
    monkeypatch.setitem(tswin.SIZE2CONFIG, "tiny", TINY_SWIN)
    for name in ("lvis_v1_train", "lvis_v1_val", "lvis_v1_train_norare"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)
    yield
    for name in ("lvis_v1_train", "lvis_v1_val", "lvis_v1_train_norare"):
        DatasetCatalog.remove(name)
        MetadataCatalog.remove(name)


def run(config, root, out, *extra, classes):
    files = write_training_root(root, classes, [(64, 48), (48, 64), (50, 33), (80, 54)] * 2,
                                [(64, 48)] * 2, 12, 6, seed=1)
    args = ["--config-file", config, "--device", "cpu", *extra, *files["overrides"], *TINY,
            "OUTPUT_DIR", out]
    return train_net.main(train_net.default_argument_parser().parse_args(args))


def finite_metrics(out):
    lines = [json.loads(x) for x in open(os.path.join(out, "metrics.json")).read().splitlines()]
    assert lines and all(math.isfinite(v) for row in lines for v in row.values())
    return lines


def test_do_train_bsgal_cli(tiny_swin, tmp_path, monkeypatch):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    monkeypatch.setenv("DETECTRON2_DATASETS", root)
    state = run("configs/BSGAL_SwinL.yaml", root, out, "--max-steps", "2", classes=1203)
    first = do_train.last_run
    assert state.step == 2 and first["start_iter"] == 0 and len(first["step_s"]) == 2
    astate = first["active_state"]
    assert int(astate.n_paste) + int(astate.n_discard) == 2
    assert set(first["eval"]["lvis_v1_val"]) == {"bbox", "segm"}
    assert math.isfinite(first["eval"]["lvis_v1_val"]["bbox"]["AP"])
    assert Checkpointer(out).all_steps() == [1, 2]
    assert Checkpointer(os.path.join(out, "grad_bank")).all_steps() == [1, 2]
    log = open(os.path.join(out, "paste_source", "rank_0", "10000.txt")).read().splitlines()
    iters = sorted({int(line.split(" iter: ")[1].split()[0]) for line in log})
    assert iters == [0, 1] and all(" threshold: -0.05" in line for line in log)
    assert [row["iteration"] for row in finite_metrics(out)] == [0]
    bank_saved = Checkpointer(os.path.join(out, "grad_bank")).load(2)["active_state"]

    # DatasetCatalog entries stay registered: the resume finds them
    state = run("configs/BSGAL_SwinL.yaml", root, out, "--max-steps", "1", "--resume",
                classes=1203)
    again = do_train.last_run
    assert state.step == 3 and again["start_iter"] == 2 and again["bank_step"] == 2
    assert sum(again["restored_counts"]) == 2
    assert again["restored_counts"] == (int(bank_saved["n_paste"]), int(bank_saved["n_discard"]))
    astate = again["active_state"]
    assert int(astate.n_paste) + int(astate.n_discard) == 3
    assert Checkpointer(os.path.join(out, "grad_bank")).all_steps() == [2, 3]
    assert [row["iteration"] for row in finite_metrics(out)] == [0, 2]

    # --eval-only evaluates the newest checkpoint
    results = run("configs/BSGAL_SwinL.yaml", root, out, "--eval-only", classes=1203)
    assert math.isfinite(results["lvis_v1_val"]["segm"]["AP"])


def test_do_train_divergen_cli(tiny_swin, tmp_path, monkeypatch):
    root, out = str(tmp_path / "data"), str(tmp_path / "out")
    monkeypatch.setenv("DETECTRON2_DATASETS", root)
    state = run("configs/DiverGen_swinL.yaml", root, out, "--max-steps", "2",
                "MODEL.SWIN.USE_CHECKPOINT", "true", "PROFILE_START_ITER", "1",
                "PROFILE_NUM_ITERS", "1", classes=1453)
    assert state.step == 2 and state.model.bottom_up.remat
    trace = json.load(open(os.path.join(out, "profile", "trace.json")))  # iteration 1 only
    assert trace["traceEvents"]
    assert "active_state" not in do_train.last_run
    assert Checkpointer(out).all_steps() == [1, 2]
    assert not os.path.exists(os.path.join(out, "grad_bank"))
    rows = finite_metrics(out)
    assert "loss_paste_ins_stage0" not in rows[0] and rows[0]["total_loss"] > 0
    state = run("configs/DiverGen_swinL.yaml", root, out, "--max-steps", "1", "--resume",
                classes=1453)
    assert state.step == 3 and do_train.last_run["start_iter"] == 2
    assert state.optimizer.count == 3


def test_train_net_refuses(tmp_path, monkeypatch):
    parse = train_net.default_argument_parser().parse_args
    # --multi-host joins the group torchrun describes; without its environment it raises
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="torchrun"):
        train_net.main(parse(["--multi-host", "--device", "cpu", "OUTPUT_DIR", str(tmp_path)]))
    with pytest.raises(ValueError, match="--dist-backend"):
        train_net.main(parse(["--dist-backend", "gloo", "OUTPUT_DIR", str(tmp_path)]))
    # the data axis takes every rank the model axis leaves: 2 at world size 1
    # raises, and so does a model axis that does not divide the ranks
    cfg = train_net.setup(parse(["OUTPUT_DIR", str(tmp_path), "PARALLEL.DATA_PARALLEL", "2"]))
    with pytest.raises(ValueError, match="DATA_PARALLEL 2"):
        do_train(cfg, device="cpu")
    cfg = train_net.setup(parse(["OUTPUT_DIR", str(tmp_path), "PARALLEL.MODEL_PARALLEL", "2"]))
    with pytest.raises(ValueError, match="MODEL_PARALLEL 2 does not divide the 1 ranks"):
        do_train(cfg, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            do_train(cfg)
    auto = train_net.setup(parse(["--config-file", "configs/BSGAL_SwinL.yaml",
                                  "OUTPUT_DIR", str(tmp_path / "auto")]))
    assert auto.OUTPUT_DIR.endswith("BSGAL_SwinL") and auto.is_frozen()
