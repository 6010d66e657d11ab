"""do_test: timed inference over the test sets → LVIS/COCO metrics.

Counterpart of ``divergen_tpu/engine/eval_loop.py`` (``build_evaluator``,
``inference_on_dataset``, ``do_test``) on one card or over ranks: the same loop over
batches of mapped samples, the same data / compute timing after ``warmup``
images and the same log line, the EMA weights first, ``RESET_CLS_TESTS``
through ``rcnn.load_zs_weight`` and ``rcnn.reset_cls_test``, one result dict
per ``DATASETS.TEST`` name. The output dict goes to the host in one copy
per batch. ``inference_on_dataset_exp`` is the analysis variant: the model
with ``return_logits``, ``LVISEvaluatorWithLogits``, and a
``det_<image_id>.npz`` of each image's valid boxes, scores, classes and
per-box class scores.

Over the ranks of ``group`` ``inference_on_dataset`` splits each batch as
the JAX loop's ``pmap`` does over its ``dp`` devices: the first ``dp`` ranks
(all of them at ``PARALLEL.DATA_PARALLEL`` -1 or 0), whatever the model
axis, each with the full weights. The batch size is rounded up to a
multiple of ``dp``, and each of those ranks maps and infers only its
contiguous rows (as the train loader maps only a rank's rows); the other
ranks map nothing and take part only in the gathers. The fixed-capacity
detections are all-gathered back into batch order, and so are the samples
without their pixels. Rank 0 alone runs the evaluator; the other ranks
return an empty dict.
"""
from __future__ import annotations

import logging
import time
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..data import DatasetCatalog, MetadataCatalog
from ..data.dataset_mapper import DatasetMapper
from ..evaluation.lvis_evaluator import CustomCOCOEvaluator, LVISEvaluator, OIDEvaluator
from ..modeling.meta_arch.rcnn import build_model
from ..parallel.mesh import model_shards
from ..utils import comm
from ..utils.dist import entry_device
from ..utils.transfer import to_device, to_host
from .checkpoint import Checkpointer
from .train_loop import TrainState

logger = logging.getLogger(__name__)


def build_evaluator(cfg, dataset_name: str):
    etype = MetadataCatalog.get(dataset_name).evaluator_type
    if etype == "lvis":
        return LVISEvaluator(dataset_name)
    if etype in ("coco", "coco_generalized"):
        return CustomCOCOEvaluator(dataset_name)
    if etype == "oid":
        return OIDEvaluator(dataset_name)
    if etype == "lvis_to_coco":
        from ..evaluation.lvis_evaluator import LVISToCOCOEvaluator

        meta = MetadataCatalog.get(dataset_name)
        return LVISToCOCOEvaluator(
            dataset_name,
            mapper_json=getattr(meta, "lvis_to_coco_mapper", None),
            lvis_json=getattr(meta, "lvis_json", None),
        )
    raise NotImplementedError(etype)


def _batches(dataset, mapper, batch_size: int, rows: Optional[slice] = None):
    """(samples, images, sizes) per batch of mapped records, the last batch
    padded with copies of the dataset's last sample. With ``rows`` only
    those rows of each batch are mapped: ``images`` and ``sizes`` are theirs,
    ``samples`` those of them that are not padding. The mapper draws from
    ``default_rng(0)``, as in the JAX loop (the test mapper draws nothing,
    so a rank's rows map as they would in the whole batch)."""
    rng = np.random.default_rng(0)
    rows = rows or slice(0, batch_size)
    n = len(dataset)
    for ofs in range(0, n, batch_size):
        samples = []
        for i in range(ofs + rows.start, min(ofs + rows.stop, n)):
            r = dataset[i]
            s = mapper(r, rng)
            s["orig_height"] = r.get("height")
            s["orig_width"] = r.get("width")
            samples.append(s)
        # every row of a rank past the dataset's end is padding
        last = samples[-1] if samples else mapper(dataset[n - 1], rng)
        pad = rows.stop - rows.start - len(samples)
        images = np.stack([s["image"] for s in samples] + [last["image"]] * pad)
        sizes = np.stack([s["image_size"] for s in samples] + [last["image_size"]] * pad)
        yield samples, images, sizes


def inference_on_dataset(model, params, cfg, dataset_name: str, evaluator,
                         batch_size: int = 8, max_images: Optional[int] = None,
                         group=None) -> Dict:
    """Timed eval loop (divergen/evaluation/evaluator.py:106-216) on the
    model's device. ``params``: a ``state_dict`` to load into ``model`` first,
    or None to run the model as it is (with its full weights). Over the ranks
    of ``group`` (None is one process) each batch is split over the first
    ``PARALLEL.DATA_PARALLEL`` ranks as the module docstring says: -1, 0 or
    more than the ranks takes them all, as the JAX loop takes every device,
    and ``PARALLEL.MODEL_PARALLEL`` plays no part, as in JAX."""
    world, rank = (1, 0) if group is None else (dist.get_world_size(group), dist.get_rank(group))
    dp = cfg.PARALLEL.DATA_PARALLEL
    if dp in (-1, 0) or dp > world:
        dp = world
    # the batch divisible by the data axis, so the shares are even
    batch_size = max(batch_size, dp)
    batch_size += (-batch_size) % dp
    mapping = rank < dp
    rows = slice(rank * batch_size // dp, (rank + 1) * batch_size // dp) if mapping else None
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    device = next(model.parameters()).device
    dataset = DatasetCatalog.get(dataset_name)
    if max_images:
        dataset = dataset[:max_images]
    mapper = DatasetMapper(cfg, is_train=False)

    evaluator.reset()
    n = len(dataset)
    t_data = t_comp = 0.0
    warmup = min(5, n)
    start = time.perf_counter()
    batches = _batches(dataset, mapper, batch_size, rows) if mapping else None
    like = None  # the shapes of a mapping rank's detections, for the others' gathers
    for ofs in range(0, n, batch_size):
        t0 = time.perf_counter()
        samples, images, sizes = next(batches) if mapping else ([], None, None)
        if group is not None:
            # rank 0's evaluator reads each sample's id and transforms, not its pixels
            parts = [None] * world
            dist.all_gather_object(parts, [{k: v for k, v in s.items() if k not in ("image", "gt")}
                                           for s in samples], group=group)
            samples = [s for part in parts for s in part]
        t_data += time.perf_counter() - t0
        t0 = time.perf_counter()
        with torch.no_grad():
            if mapping:
                dev = to_device({"images": images, "sizes": sizes.astype(np.int64)}, device)
                out = model(dev["images"], dev["sizes"], training=False)
            if dp < world:
                if like is None:
                    shapes = [{k: (tuple(v.shape), v.dtype) for k, v in out.items()}
                              if rank == 0 else None]
                    dist.broadcast_object_list(shapes, src=dist.get_global_rank(group, 0),
                                               group=group)
                    like = shapes[0]
                if not mapping:
                    out = {k: torch.zeros(shape, dtype=dtype, device=device)
                           for k, (shape, dtype) in like.items()}
            out = {k: comm.all_gather_rows(v, group)[:batch_size] for k, v in out.items()}
        if rank == 0:
            out = to_host(out)
        if ofs >= warmup:
            t_comp += time.perf_counter() - t0
        if rank == 0:
            evaluator.process(samples, out)
    total = time.perf_counter() - start
    logger.info(
        "inference on %s: %d imgs, %.4f s/img total (data %.4f, compute %.4f)",
        dataset_name, n, total / max(n, 1), t_data / max(n, 1), t_comp / max(n - warmup, 1),
    )
    inference_on_dataset.last_timing = {
        "images": n, "total_s_per_image": total / max(n, 1),
        "data_s_per_image": t_data / max(n, 1),
        "compute_s_per_image": t_comp / max(n - warmup, 1)}
    return evaluator.evaluate() if rank == 0 else {}


inference_on_dataset.last_timing = None


def _load_weights(model, model_state: Dict[str, torch.Tensor],
                  ema_params: Optional[Dict[str, torch.Tensor]]) -> None:
    """The model's state, then the EMA copy over its parameters (EMA-eval,
    train_net.py:63-64); dtypes and devices follow the model."""
    model.load_state_dict(model_state)
    if ema_params is not None:
        params = dict(model.named_parameters())
        with torch.no_grad():
            for k, v in ema_params.items():
                params[k].copy_(v)


def do_test(cfg, model=None, state: Optional[TrainState] = None, resume: bool = True,
            max_images: Optional[int] = None, device=None, group=None) -> Dict:
    """One result dict per ``cfg.DATASETS.TEST`` name, from ``state`` (its EMA
    weights when it has them) or, without one, from the newest checkpoint
    under ``cfg.OUTPUT_DIR`` (its EMA weights first). ``model``: the module
    to evaluate in (default: built for the test canvas on ``device``, the
    card unless the caller names another); with ``MODEL.RESET_CLS_TESTS``
    the second and later test sets get a new one. A ``state`` whose model is
    held as slices over the model group is gathered first (every rank of the
    group calls this)."""
    dev = entry_device(device)
    canvas = cfg.INPUT.TEST_SIZE
    shards = model_shards(state.model) if state is not None else None
    if shards is not None:
        # the full weights of a model held as slices over the model group
        model_state, ema = shards.state_dict(), shards.full_tree(state.ema_params or {}) or None
    elif state is None:
        ckpt = Checkpointer(cfg.OUTPUT_DIR)
        step = ckpt.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {cfg.OUTPUT_DIR}")
        raw = ckpt.load(step)
        model_state, ema = raw["model"], raw["ema_params"]
    else:
        model_state, ema = state.model.state_dict(), state.ema_params

    results = {}
    for d, name in enumerate(cfg.DATASETS.TEST):
        # a vocabulary swap changes the classifier's shape, so each test set
        # then takes a model of its own
        if model is None or (cfg.MODEL.RESET_CLS_TESTS and d > 0):
            model = build_model(cfg, input_size=(canvas, canvas), device=dev)
        eval_model = model
        _load_weights(eval_model, model_state, ema)
        if cfg.MODEL.RESET_CLS_TESTS:
            # swap the zero-shot classifier vocabulary per test set
            # (ref train_net.py:89-93 reset_cls_test); files are stored
            # (C, zs_dim) and transposed on load (modeling/utils.py:40-43)
            from ..modeling.meta_arch.rcnn import load_zs_weight, reset_cls_test

            w = load_zs_weight(
                cfg.MODEL.TEST_CLASSIFIERS[d],
                zs_dim=cfg.MODEL.ROI_BOX_HEAD.ZEROSHOT_WEIGHT_DIM,
            )
            n_cls = int(cfg.MODEL.TEST_NUM_CLASSES[d]) if cfg.MODEL.TEST_NUM_CLASSES else w.shape[1]
            assert w.shape[1] == n_cls, (w.shape, n_cls)
            reset_cls_test(eval_model, w)
        evaluator = build_evaluator(cfg, name)
        results[name] = inference_on_dataset(
            eval_model, None, cfg, name, evaluator, max_images=max_images, group=group
        )
        logger.info("results[%s] = %s", name, results[name])
    return results


def inference_on_dataset_exp(model, params, cfg, dataset_name: str, out_dir: str,
                             batch_size: int = 8, max_images: Optional[int] = None) -> Dict:
    """The analysis variant of ``inference_on_dataset``
    (divergen/evaluation/evaluator.py:221-380): the model with
    ``return_logits``, evaluated by ``LVISEvaluatorWithLogits`` (which also
    writes ``<image_id>.npz`` of the logits), and per image
    ``out_dir/det_<image_id>.npz`` holding the valid ``boxes``, ``scores``,
    ``classes`` and ``logits`` (each box's class-score vector). ``params``
    as in ``inference_on_dataset``; the model runs on its own device."""
    import os

    from ..evaluation.lvis_evaluator import LVISEvaluatorWithLogits

    os.makedirs(out_dir, exist_ok=True)
    if params is not None:
        model.load_state_dict(params)
    model.eval()
    device = next(model.parameters()).device
    dataset = DatasetCatalog.get(dataset_name)
    if max_images:
        dataset = dataset[:max_images]
    mapper = DatasetMapper(cfg, is_train=False)
    evaluator = LVISEvaluatorWithLogits(dataset_name, logits_dir=out_dir)
    for samples, images, sizes in _batches(dataset, mapper, batch_size):
        dev = to_device({"images": images, "sizes": sizes.astype(np.int64)}, device)
        with torch.no_grad():
            out = to_host(model(dev["images"], dev["sizes"], training=False,
                                return_logits=True))
        evaluator.process(samples, out)
        for b, s in enumerate(samples):
            valid = np.asarray(out["valid"][b])
            arrays = {
                "boxes": np.asarray(out["boxes"][b])[valid],
                "scores": np.asarray(out["scores"][b])[valid],
                "classes": np.asarray(out["classes"][b])[valid],
            }
            if "logits" in out:  # per-box class-score vectors, as documented
                arrays["logits"] = np.asarray(out["logits"][b])[valid]
            np.savez_compressed(
                os.path.join(out_dir, f"det_{int(s['image_id'])}.npz"), **arrays
            )
    return evaluator.evaluate()
