"""do_train: the training entry (replaces ``DiverGen/train_net.py:62-304``).

Counterpart of ``divergen_tpu/engine/trainer.py``: ``load_fed_weight``,
``make_paste_train_step`` (compositing (box-frame) → forward → backward →
optimizer → EMA on the device), ``build_train_loader`` and ``do_train`` with
the BSGAL branch (``active/bsgal.py``). The host loader only decodes and
assembles patch stacks (``data/loader.py``); batches reach the card through
``device_prefetch``. The JAX package's ``_init_params`` (flax ``init``) is
``modeling/meta_arch/rcnn.py:detector_init_`` with a generator seeded from
``SEED``.

Over ranks (one rank a card, ``utils/dist.py:init_distributed``) the layout
is the JAX package's, where a process is a host and a chip a device: the
sampler is sharded over the nodes, each node's batch is ``IMS_PER_BATCH``,
and local rank ``l`` of ``L`` maps and trains on rows ``[l·B/L, (l+1)·B/L)``
of it (with BSGAL, its rows of the probe too). Every random draw is taken
at the global batch's shape from the same generator state on every rank
(``ops.losses.RankDraws``), the losses' normalizers and the gradients are
reduced over the ranks, and the parameters start equal (a broadcast from
rank 0), so W ranks compute what one process computes on the global batch.
Checkpoints, ``metrics.json`` and the log are rank 0's; the metrics are
``comm.reduce_dict`` means over the ranks.
"""
from __future__ import annotations

import json
import logging
import math
import os
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn as nn

from ..data import DatasetCatalog
from ..data.copy_paste_mapper import CopyPasteMapper
from ..data.dataset_mapper import DatasetMapper
from ..data.loader import TrainLoader, device_prefetch
from ..data.samplers import (
    MultiDatasetSampler,
    RepeatFactorTrainingSampler,
    TrainingSampler,
    repeat_factors_from_category_frequency,
)
from ..modeling.meta_arch.rcnn import build_model, detector_init_, load_zs_weight, reset_cls_test
from ..ops.copy_paste import normalize_cp_method, paste_instances_boxframe
from ..ops.losses import RankDraws, Rng
from ..parallel.mesh import MODEL_PARALLEL_ITEM, create_mesh, shard_pytree
from ..solver.build import SolverOptimizer, build_optimizer
from ..utils import comm
from ..utils.dist import Layout, entry_device, layout
from ..utils.transfer import to_host
from .checkpoint import Checkpointer, PeriodicCheckpointer
from .events import CommonMetricPrinter, EventStorage, JSONWriter
from .train_loop import TrainState, apply_losses, create_train_state

logger = logging.getLogger(__name__)


def load_fed_weight(cfg, device=None) -> Optional[torch.Tensor]:
    """The federated loss's class weights, ``image_count ** FED_LOSS_FREQ_WEIGHT``
    per class from ``MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH`` (padded with ones to
    the class count), or None when the loss is off or the file is missing."""
    path = cfg.MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH
    if not (cfg.MODEL.ROI_BOX_HEAD.USE_FED_LOSS and path and os.path.exists(path)):
        return None
    with open(path) as f:
        info = sorted(json.load(f), key=lambda c: c["id"])
    counts = np.array([c["image_count"] for c in info], np.float32)
    w = counts ** cfg.MODEL.ROI_BOX_HEAD.FED_LOSS_FREQ_WEIGHT
    n = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    if len(w) < n:
        w = np.concatenate([w, np.ones(n - len(w), np.float32)])
    return torch.from_numpy(w[:n].astype(np.float32)).to(device)


@torch.no_grad()
def composite(batch, mode: str):
    """Paste the batch's patches into its images on the device: ``(images,
    gt)`` with the pasted instances appended to the ground truth."""
    gt = batch["gt"]
    out = paste_instances_boxframe(
        batch["image"], gt["masks"], gt["boxes"], gt["classes"], gt["valid"],
        gt["instance_source"], batch["patches"], batch["patch_boxes"],
        batch["patch_classes"], batch["patch_valid"], batch["patch_flip"], mode=mode,
        patch_angle=batch.get("patch_angle"))
    return out["image"], {k: out[k] for k in ("boxes", "classes", "valid", "masks",
                                              "instance_source")}


def make_paste_train_step(model: nn.Module, optimizer: SolverOptimizer, cfg,
                          group=None) -> Callable:
    """``step(state, batch, rng) -> (state, metrics)`` with the compositing in
    front of the forward. batch: ``image`` (B, H, W, 3), ``image_size`` (B, 2),
    ``gt`` (masks, boxes, classes, valid, instance_source), and with
    ``INPUT.USE_COPY_PASTE`` the patches to paste (``patches`` (B, P, ps, ps,
    4), ``patch_boxes``, ``patch_classes``, ``patch_valid``, ``patch_flip``,
    optionally ``patch_angle``); ``fed_weight`` in the batch overrides the
    file's. The metrics are ``total_loss`` and every loss. ``group``: the
    ranks whose batches make the global batch (``train_loop.make_train_step``)."""
    ema_decay = cfg.MODEL.MODEL_EMA
    mode = normalize_cp_method(cfg.INPUT.CP_METHOD)
    use_paste = cfg.INPUT.USE_COPY_PASTE
    fed_weight = load_fed_weight(cfg)

    def step_fn(state: TrainState, batch, rng: Rng):
        assert state.model is model and state.optimizer is optimizer
        images, gt = composite(batch, mode) if use_paste else (batch["image"], batch["gt"])
        fed = batch.get("fed_weight", fed_weight)
        if fed is not None:
            fed = fed.to(images.device)
        losses = model(images, batch["image_size"], gt=gt, rng=rng, fed_weight=fed, training=True,
                       group=group)
        metrics = apply_losses(state, losses, ema_decay, group=group)
        del metrics["grad_norm"]
        return state, metrics

    return step_fn


def train_rows(cfg, lay: Layout):
    """(rows of each batch, rows of each probe batch) that local rank
    ``lay.local_rank`` of ``lay.local_world`` takes: its contiguous share of
    the node's ``IMS_PER_BATCH`` and, with BSGAL, of the ``PROBE_BATCH``
    first rows of the probe batch. A share that is not whole raises."""
    b, n, l = cfg.SOLVER.IMS_PER_BATCH, lay.local_world, lay.local_rank
    if b % n:
        raise ValueError(f"SOLVER.IMS_PER_BATCH {b} does not split over the {n} ranks of a node")
    probe = min(cfg.MODEL.ACTIVE.PROBE_BATCH, b)
    if cfg.MODEL.ACTIVE.ENABLED and probe % n:
        raise ValueError(f"MODEL.ACTIVE.PROBE_BATCH {probe} does not split over the {n} ranks "
                         "of a node")
    return (l * b // n, (l + 1) * b // n), (l * probe // n, (l + 1) * probe // n)


def build_train_loader(cfg, mapper=None) -> TrainLoader:
    """The train loader of ``cfg``: the records of every ``DATASETS.TRAIN``
    name, the train ``DatasetMapper`` (wrapped in a ``CopyPasteMapper`` with
    ``INPUT.USE_COPY_PASTE``, its self-copy sources set to the records), and
    the sampler: ``MultiDatasetSampler`` over several datasets, repeat-factor
    sampling with ``INPUT.USE_RFS`` or ``RepeatFactorTrainingSampler``, else
    ``TrainingSampler``; seeded from ``SEED`` and sharded over the nodes.
    Over several ranks of a node each maps only its rows (``train_rows``);
    with BSGAL every second batch is a probe. ``WORLD_SIZE`` above 1 without
    a process group raises (``utils/dist.py:layout``)."""
    names = list(cfg.DATASETS.TRAIN)
    dataset = []
    for n in names:
        dataset += DatasetCatalog.get(n)
    if mapper is None:
        base = DatasetMapper(cfg, is_train=True)
        mapper = CopyPasteMapper(base, cfg) if cfg.INPUT.USE_COPY_PASTE else base
        if isinstance(mapper, CopyPasteMapper):
            mapper.set_dataset(dataset)
    lay = layout()
    rank, world = lay.node, lay.nodes
    rows, probe_rows = train_rows(cfg, lay)
    rows = [rows, probe_rows] if cfg.MODEL.ACTIVE.ENABLED and lay.local_world > 1 else [rows]
    use_rfs = cfg.INPUT.USE_RFS or (cfg.DATALOADER.SAMPLER_TRAIN == "RepeatFactorTrainingSampler")
    if len(names) > 1:
        # per-dataset ratio x optional per-dataset RFS
        # (custom_dataset_dataloader.py:88-127)
        sizes = [len(DatasetCatalog.get(n)) for n in names]
        ratios = list(cfg.DATALOADER.DATASET_RATIO)
        if len(ratios) != len(names):
            ratios = [1.0] * len(names)
        rfs_flags = list(cfg.DATALOADER.USE_RFS)
        if len(rfs_flags) != len(names):
            rfs_flags = [False] * len(names)
        rfs_all, ofs = [], 0
        for sz, flag in zip(sizes, rfs_flags):
            rfs_all.append(repeat_factors_from_category_frequency(
                dataset[ofs : ofs + sz], cfg.DATALOADER.REPEAT_THRESHOLD) if flag else np.ones(sz))
            ofs += sz
        sampler = MultiDatasetSampler(sizes, ratios, np.concatenate(rfs_all), seed=cfg.SEED,
                                      rank=rank, world_size=world)
    elif use_rfs:
        rfs = repeat_factors_from_category_frequency(dataset, cfg.DATALOADER.REPEAT_THRESHOLD)
        sampler = RepeatFactorTrainingSampler(rfs, seed=cfg.SEED, rank=rank, world_size=world)
    else:
        sampler = TrainingSampler(len(dataset), seed=cfg.SEED, rank=rank, world_size=world)
    return TrainLoader(dataset, mapper, sampler, batch_size=cfg.SOLVER.IMS_PER_BATCH,
                       num_workers=cfg.DATALOADER.NUM_WORKERS, seed=cfg.SEED, rows=rows)


def _probe_of(probe: Dict, size: int) -> Dict:
    """The first ``size`` images of a real batch: BSGAL's probe
    (ACTIVE_TEST_BATCHSIZE, ref config.py:79)."""
    pb = min(size, probe["image"].shape[0])
    return {"image": probe["image"][:pb], "image_size": probe["image_size"][:pb],
            "gt": {k: v[:pb] for k, v in probe["gt"].items()}}


class _StepClock:
    """Seconds between the ends of consecutive iterations, without a host
    sync: on the card each end is a CUDA event read after the loop, so a
    step's time is the device's (or the host's, where the device waited)."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks = []
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.marks.append(ev)
        else:
            self.marks.append(time.perf_counter())

    def seconds(self):
        if self.cuda:
            torch.cuda.synchronize()
            return [a.elapsed_time(b) / 1e3 for a, b in zip(self.marks, self.marks[1:])]
        return [b - a for a, b in zip(self.marks, self.marks[1:])]


def do_train(cfg, resume: bool = False, max_steps: Optional[int] = None,
             device=None) -> TrainState:
    """Train ``cfg``'s model on ``cfg.DATASETS.TRAIN`` on ``device`` (the card
    unless the caller names another; without a card and without a request it
    raises): the model with float32 parameters and random weights seeded
    from ``SEED``, the train loader, the optimizer and EMA, resumed from
    ``OUTPUT_DIR/checkpoints`` with ``resume``; with ``MODEL.ACTIVE.ENABLED``
    BSGAL's step, its probe the first ``PROBE_BATCH`` images of the loader's
    next batch, its grad bank under ``OUTPUT_DIR/grad_bank`` (the newest two
    kept, saved every ``BANK_CKPT_PERIOD``, restored with ``resume``) and its
    decision logs every ``LOG_PERIOD``. Every 20 iterations (and the first)
    the metrics are checked finite and written (``metrics.json``, the log);
    ``TEST.EVAL_PERIOD`` runs ``do_test`` on the EMA weights;
    ``PROFILE_START_ITER`` traces ``PROFILE_NUM_ITERS`` iterations with
    ``torch.profiler`` into ``OUTPUT_DIR/profile``. ``max_steps`` caps the
    iterations of this call. ``do_train.last_run`` keeps what a caller may
    check: ``start_iter``, the restored bank's step, decision counts and
    norm, ``data_time`` and ``step_s`` per iteration, the last ``do_test``
    result, the ``ActiveState`` and the ``world`` size.

    Over the ranks of an initialized process group (module docstring):
    ``PARALLEL.DATA_PARALLEL`` is -1 or the world size, ``MODEL_PARALLEL``
    above 1 raises, and rank 0 alone writes checkpoints, the grad bank,
    ``metrics.json``, the log and the profile; each rank keeps its decision
    log."""
    dev = entry_device(device)
    lay = layout()
    if cfg.PARALLEL.MODEL_PARALLEL > 1:
        raise NotImplementedError(MODEL_PARALLEL_ITEM)
    if cfg.PARALLEL.DATA_PARALLEL not in (-1, lay.world):
        raise ValueError(f"PARALLEL.DATA_PARALLEL {cfg.PARALLEL.DATA_PARALLEL}: the data axis "
                         f"takes every rank, -1 or the world size {lay.world}")
    mesh = create_mesh(cfg.PARALLEL.DATA_PARALLEL, cfg.PARALLEL.MODEL_PARALLEL, world=lay.world)
    group, main = mesh.group, lay.rank == 0
    out_dir = cfg.OUTPUT_DIR
    os.makedirs(out_dir, exist_ok=True)
    canvas = (cfg.INPUT.TRAIN_SIZE,) * 2
    model = build_model(cfg, input_size=canvas, device=dev, param_dtype=torch.float32)
    detector_init_(model, torch.Generator(device=dev).manual_seed(cfg.SEED))
    zs_path = cfg.MODEL.ROI_BOX_HEAD.ZEROSHOT_WEIGHT_PATH
    if cfg.MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS and zs_path and zs_path != "rand":
        # the CLIP-text classifier (ZeroShotClassifier init); files are stored
        # (C, zs_dim) (modeling/utils.py:40-43)
        reset_cls_test(model, load_zs_weight(zs_path,
                                             zs_dim=cfg.MODEL.ROI_BOX_HEAD.ZEROSHOT_WEIGHT_DIM))
    shard_pytree(model, mesh)  # rank 0's weights on every rank
    logger.info("model parameters: %.2fM", sum(p.numel() for p in model.parameters()) / 1e6)
    loader = build_train_loader(cfg)
    probe_rows = train_rows(cfg, lay)[1]

    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, ema=cfg.MODEL.MODEL_EMA > 0)
    ckpt = Checkpointer(out_dir)
    state, start_iter = ckpt.resume_or_load(state, resume=resume)
    _same_on_every_rank("resumed step", start_iter)
    periodic = PeriodicCheckpointer(ckpt, cfg.SOLVER.CHECKPOINT_PERIOD, cfg.SOLVER.MAX_ITER)
    run: Dict = {"start_iter": start_iter, "eval": None, "world": lay.world}
    do_train.last_run = run

    active = cfg.MODEL.ACTIVE.ENABLED
    if active:
        from ..active.bsgal import (DecisionLogger, init_active_state, make_active_train_step,
                                    paste_ins_rows)

        astate = init_active_state({n: p for n, p in model.named_parameters() if p.requires_grad},
                                   queue_size=cfg.MODEL.ACTIVE.QUEUE_SIZE)
        a_ckpt = Checkpointer(os.path.join(out_dir, "grad_bank"), max_to_keep=2)
        astate, a_it = a_ckpt.resume_or_load(astate, resume=resume)
        _same_on_every_rank("resumed grad-bank step", a_it)
        norm2 = torch.stack([(v.double() ** 2).sum() for v in astate.grad_bank.values()]).sum()
        run.update(active_state=astate, bank_step=a_it,
                   restored_counts=(int(astate.n_paste), int(astate.n_discard)),
                   restored_bank_norm=math.sqrt(float(norm2)))
        step = make_active_train_step(model, optimizer, cfg, group=group)
        # per-rank decision logs in the reference layout (custom_rcnn.py:
        # 610-686: paste_source/rank_*/N0000.txt + paste_ins_loss/rank_*/N0000.txt)
        decision_log = DecisionLogger(out_dir, lay.rank)
    else:
        step = make_paste_train_step(model, optimizer, cfg, group=group)
    storage = EventStorage(start_iter)
    writers = [CommonMetricPrinter(cfg.SOLVER.MAX_ITER),
               JSONWriter(os.path.join(out_dir, "metrics.json"))] if main else []
    rng: Rng = torch.Generator(device=dev).manual_seed(cfg.SEED + 1)
    if group is not None:
        rng = RankDraws(rng, lay.rank, lay.world)
    max_iter = (cfg.SOLVER.MAX_ITER if max_steps is None
                else min(cfg.SOLVER.MAX_ITER, start_iter + max_steps))
    data_iter = device_prefetch(iter(loader), size=cfg.DATALOADER.PREFETCH_TO_DEVICE, device=dev)
    # torch.profiler window over iterations [PROFILE_START_ITER, +PROFILE_NUM_ITERS)
    prof_start = cfg.get("PROFILE_START_ITER", -1) if main else -1
    prof_n = cfg.get("PROFILE_NUM_ITERS", 5)
    prof = None
    eval_model = None
    data_times = []
    clock = _StepClock(dev)
    t_data = time.perf_counter()
    for it in range(start_iter, max_iter):
        if prof_start >= 0 and it == prof_start:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if dev.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        if prof is not None and it == prof_start + prof_n:
            _stop_profile(prof, out_dir)
            prof = None
        batch = next(data_iter)
        batch.pop("tfms", None)
        batch.pop("image_ids", None)
        # host-side provenance (string arrays never reach the device)
        paste_filenames = batch.pop("patch_filenames", None)
        data_times.append(time.perf_counter() - t_data)
        storage.put_scalar("data_time", data_times[-1])
        if active:
            # probe = the next real batch (ACTIVE_TEST 'select' pairing is the
            # mapper's job; any real batch works as the default)
            probe = next(data_iter)
            batch["probe"] = _probe_of(probe, probe_rows[1] - probe_rows[0])
            state, astate, metrics = step(state, astate, batch, rng)
            aux_rows = metrics.pop("aux_paste_rows", None)
            if (it + 1) % max(cfg.MODEL.ACTIVE.LOG_PERIOD, 1) == 0 or it == start_iter:
                h = to_host({"sim": metrics["grad_sim"], "use": metrics["paste_used"],
                             "thr": metrics["threshold"], "num": metrics["paste_num"],
                             **({"cls": batch["patch_classes"]} if "patch_classes" in batch
                                else {})})
                names, sel_classes = [], []
                if paste_filenames is not None and "cls" in h:
                    for f, c in zip(np.asarray(paste_filenames).reshape(-1).tolist(),
                                    h["cls"].reshape(-1).tolist()):
                        if f:
                            names.append(f)
                            sel_classes.append(int(c))
                decision_log.log_decision(it, names or ["<none>"], sel_classes or [-1],
                                          int(h["use"]), float(h["sim"]), float(h["thr"]),
                                          int(h["num"]))
                if aux_rows is not None:
                    rows = paste_ins_rows(to_host(aux_rows), paste_filenames)
                    if rows:
                        decision_log.log_paste_ins(it, rows, int(h["use"]), int(h["num"]))
            if main and (it + 1) % cfg.MODEL.ACTIVE.BANK_CKPT_PERIOD == 0:
                a_ckpt.save(it + 1, astate)
        else:
            state, metrics = step(state, batch, rng)
        if (it + 1) % 20 == 0 or it == start_iter:
            # the mean over the ranks: the global batch's losses
            host = comm.reduce_dict({k: float(v) for k, v in to_host(metrics).items()})
            if not np.isfinite(host["total_loss"]):
                raise FloatingPointError(f"non-finite loss at iter {it}: {host}")
            storage.put_scalars(**host)
            for w in writers:
                w.write(storage)
        if main:
            periodic.step(it, state)
        if cfg.TEST.EVAL_PERIOD > 0 and (it + 1) % cfg.TEST.EVAL_PERIOD == 0:
            from .eval_loop import do_test

            # evaluated in a model of its own: do_test loads the EMA weights
            # into the model it is given
            if eval_model is None:
                eval_model = build_model(cfg, input_size=(cfg.INPUT.TEST_SIZE,) * 2, device=dev)
            run["eval"] = do_test(cfg, model=eval_model, state=state, device=dev, group=group)
        storage.step()
        clock.mark()
        t_data = time.perf_counter()
    if prof is not None:  # the window reached past the last iteration
        _stop_profile(prof, out_dir)
    run.update(data_time=data_times, step_s=clock.seconds())
    for w in writers[1:]:
        w.close()
    loader.stop()
    return state


def _same_on_every_rank(what: str, value) -> None:
    """Raise unless every rank holds ``value``: the ranks must read one
    ``OUTPUT_DIR``."""
    values = comm.all_gather(value)
    if len(set(values)) > 1:
        raise RuntimeError(f"the ranks hold different {what}s {values}: every rank must read "
                           "the same OUTPUT_DIR")


do_train.last_run = None


def _stop_profile(prof, out_dir: str) -> None:
    prof.stop()
    os.makedirs(os.path.join(out_dir, "profile"), exist_ok=True)
    prof.export_chrome_trace(os.path.join(out_dir, "profile", "trace.json"))
