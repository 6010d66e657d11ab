"""Inference predictors + visualization demo.

Counterpart of ``divergen_tpu/predictor.py`` (``Predictor``,
``BatchPredictor``, ``AsyncPredictor``, ``VisualizationDemo``), with the same
host pre- and post-processing. The JAX package jits the forward and relies on
XLA's asynchronous dispatch; here the forward runs eagerly on the card (or
the CPU when asked), with one host-to-device copy of the canvas and its size
and one device-to-host copy of the output dict per call
(``utils/transfer.py``). The forward synchronizes with the host once per NMS
fixpoint iteration (``ops/nms.py``, ``nms_mask.host_syncs``), so a
``BatchPredictor`` overlaps less of the host's work with the card's than
the JAX one; it counts those syncs per batch (``host_syncs``).
``AsyncPredictor`` runs worker threads on the one card, each with a model of
its own and its own CUDA stream.
"""
from __future__ import annotations

import contextlib
import time
from collections import deque
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from .data.dataset_mapper import DatasetMapper
from .evaluation.lvis_evaluator import paste_mask_np
from .modeling.meta_arch.rcnn import build_model
from .ops.nms import nms_mask
from .utils.dist import entry_device
from .utils.transfer import to_device, to_host
from .utils.visualizer import draw_instance_predictions


class Predictor:
    """DefaultPredictor equivalent: __call__(rgb image) → detections.

    ``params`` is the port model's ``state_dict``, copied into the model
    (strictly; no reference is kept). The model is built for the test canvas (``INPUT.TEST_SIZE``) on ``device``:
    the card unless the caller names another (``device="cpu"``); without a
    card and without a request it raises. ``last_timing`` holds the host
    seconds of the last call's parts: ``preprocess_s`` (resize, canvas),
    ``forward_s`` (copies and forward, ending in the copy to the host) and
    ``postprocess_s`` (threshold, inverse transform, mask paste)."""

    def __init__(self, cfg, params, score_thresh: float = 0.3, device=None):
        self.cfg = cfg
        self.device = entry_device(device)
        self.mapper = DatasetMapper(cfg, is_train=False)
        canvas = self.mapper.canvas
        self.model = build_model(cfg, input_size=(canvas, canvas), device=self.device)
        self.model.load_state_dict(params)
        self.model.eval()
        self.score_thresh = score_thresh
        self.last_timing: Dict[str, float] = {}

    def _infer(self, images: np.ndarray, sizes: np.ndarray) -> Dict[str, torch.Tensor]:
        """(B, C, C, 3) float32 canvases and (B, 2) sizes → the padded output
        dict, left on the device."""
        dev = to_device({"images": images, "sizes": sizes.astype(np.int64)}, self.device)
        with torch.no_grad():
            return self.model(dev["images"], dev["sizes"], training=False)

    def preprocess(self, image_rgb: np.ndarray):
        from .data.transforms import apply_augmentations

        img, tfms = apply_augmentations(self.mapper.augs, image_rgb, np.random.default_rng(0))
        canvas = self.mapper.canvas
        out = np.zeros((canvas, canvas, 3), np.float32)
        h, w = img.shape[:2]
        out[: min(h, canvas), : min(w, canvas)] = img[:canvas, :canvas]
        return out, np.array([min(h, canvas), min(w, canvas)], np.int32), tfms

    def __call__(self, image_rgb: np.ndarray) -> Dict[str, np.ndarray]:
        t0 = time.perf_counter()
        x, size, tfms = self.preprocess(image_rgb)
        t1 = time.perf_counter()
        out = to_host(self._infer(x[None], size[None]))
        t2 = time.perf_counter()
        out = {k: v[0] for k, v in out.items()}
        keep = out["valid"] & (out["scores"] >= self.score_thresh)
        boxes = tfms.inverse_apply_box(out["boxes"][keep])
        h, w = image_rgb.shape[:2]
        boxes[:, [0, 2]] = np.clip(boxes[:, [0, 2]], 0, w)
        boxes[:, [1, 3]] = np.clip(boxes[:, [1, 3]], 0, h)
        masks = None
        if "mask_logits" in out:
            probs = 1 / (1 + np.exp(-out["mask_logits"][keep]))
            masks = np.stack(
                [paste_mask_np(p, b, h, w) for p, b in zip(probs, boxes)]
            ) if len(boxes) else np.zeros((0, h, w), bool)
        self.last_timing = {"preprocess_s": t1 - t0, "forward_s": t2 - t1,
                            "postprocess_s": time.perf_counter() - t2}
        return {
            "boxes": boxes,
            "scores": out["scores"][keep],
            "classes": out["classes"][keep],
            "masks": masks,
        }


class BatchPredictor:
    """Pipelined batch inference (AsyncPredictor counterpart): keep up to
    ``depth`` batches in flight; a batch's outputs stay on the device until
    ``flush_one`` copies them to the host. ``host_syncs`` lists the NMS host
    synchronizations of each batch's forward."""

    def __init__(self, predictor: Predictor, batch_size: int = 8, depth: int = 2):
        self.p = predictor
        self.batch_size = batch_size
        self.depth = depth
        self.host_syncs: List[int] = []

    def __call__(self, images: Sequence[np.ndarray]) -> Iterator[Dict]:
        pending: deque = deque()
        metas: deque = deque()

        def flush_one():
            out, metalist = pending.popleft(), metas.popleft()
            host = to_host(out)
            for b, (tfms, hw) in enumerate(metalist):
                keep = host["valid"][b] & (host["scores"][b] >= self.p.score_thresh)
                boxes = tfms.inverse_apply_box(host["boxes"][b][keep])
                yield {
                    "boxes": boxes,
                    "scores": host["scores"][b][keep],
                    "classes": host["classes"][b][keep],
                }

        for ofs in range(0, len(images), self.batch_size):
            chunk = images[ofs : ofs + self.batch_size]
            xs, sizes, meta = [], [], []
            for img in chunk:
                x, size, tfms = self.p.preprocess(img)
                xs.append(x)
                sizes.append(size)
                meta.append((tfms, img.shape[:2]))
            pad = self.batch_size - len(xs)
            xs += [xs[-1]] * pad
            sizes += [sizes[-1]] * pad
            syncs = nms_mask.host_syncs
            out = self.p._infer(np.stack(xs), np.stack(sizes))
            self.host_syncs.append(nms_mask.host_syncs - syncs)
            pending.append(out)
            metas.append(meta)
            if len(pending) > self.depth:
                yield from flush_one()
        while pending:
            yield from flush_one()


def worker_devices(device: torch.device, num_workers: int) -> List[torch.device]:
    """The device of each ``AsyncPredictor`` worker: ``cuda:(wid % n)`` over
    the ``n`` local cards for a CUDA device without an index (the JAX class's
    ``devices[wid % len(devices)]``), else ``device`` for every worker."""
    if device.type == "cuda" and device.index is None:
        n = max(torch.cuda.device_count(), 1)
        return [torch.device("cuda", wid % n) for wid in range(num_workers)]
    return [device] * num_workers


class AsyncPredictor:
    """Asynchronous multi-worker predictor (divergen/predictor.py:164-253
    API parity: put/get in request order, __call__, __len__, shutdown,
    default_buffer_size).

    Worker threads spread over the local cards as the JAX class spreads them
    over ``jax.local_devices()``: ``num_workers`` defaults to the number of
    local CUDA devices (1 on the CPU), and worker ``wid`` runs on
    ``cuda:(wid % n)`` (``worker_devices``), where a device without an index
    is asked for; a device with an index, or the CPU, takes every worker.
    Each builds its own ``Predictor`` from ``cfg`` and ``params`` and runs it
    on a CUDA stream of its own. The workers' Python (the launch-bound
    forward, the mask paste) shares the interpreter lock, so one worker's
    host work overlaps another's device work only where it waits on the card
    or runs outside the lock. The kernel wrappers launch on the current
    stream. Their launch counters are plain ints, not meant to be read while
    workers run."""

    class _StopToken:
        pass

    def __init__(self, cfg, params, num_workers: Optional[int] = None,
                 score_thresh: float = 0.3, device=None):
        import atexit
        import queue
        import threading

        device = entry_device(device)
        if num_workers is None:
            num_workers = torch.cuda.device_count() if device.type == "cuda" else 1
        num_workers = max(num_workers, 1)
        self.devices = worker_devices(device, num_workers)
        self.task_queue: "queue.Queue" = queue.Queue(maxsize=num_workers * 3)
        self.result_queue: "queue.Queue" = queue.Queue()
        self._threads = []
        self._ready = threading.Barrier(num_workers + 1)
        self._errors: List[Exception] = []
        for dev in self.devices:
            t = threading.Thread(
                target=self._worker, args=(cfg, params, dev, score_thresh),
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        self._ready.wait()  # every worker has built its model (or failed)
        if self._errors:
            self.shutdown()
            raise RuntimeError("an AsyncPredictor worker failed to start") from self._errors[0]
        self.put_idx = 0
        self.get_idx = 0
        self.result_rank: List[int] = []
        self.result_data: List[Dict] = []
        atexit.register(self.shutdown)

    def _worker(self, cfg, params, device, score_thresh):
        try:
            stream = None
            if device.type == "cuda":
                # a runtime call first makes the card's context current in
                # this thread (the kernels encode TMA maps through the driver)
                torch.cuda.set_device(device)
                stream = torch.cuda.Stream(device)
            with _on(stream):
                predictor = Predictor(cfg, params, score_thresh=score_thresh, device=device)
        except Exception as e:  # reported by the constructor
            self._errors.append(e)
            self._ready.wait()
            return
        self._ready.wait()
        while True:
            task = self.task_queue.get()
            if isinstance(task, AsyncPredictor._StopToken):
                break
            idx, image = task
            try:
                with _on(stream):
                    res = predictor(image)
            except Exception as e:  # handed to get(), which raises it
                res = e
            self.result_queue.put((idx, res))

    def put(self, image: np.ndarray) -> None:
        self.put_idx += 1
        self.task_queue.put((self.put_idx, image))

    def get(self) -> Dict[str, np.ndarray]:
        import bisect

        self.get_idx += 1
        if self.result_rank and self.result_rank[0] == self.get_idx:
            res = self.result_data[0]
            del self.result_data[0], self.result_rank[0]
            return _raise_or(res)
        while True:
            idx, res = self.result_queue.get()
            if idx == self.get_idx:
                return _raise_or(res)
            insert = bisect.bisect(self.result_rank, idx)
            self.result_rank.insert(insert, idx)
            self.result_data.insert(insert, res)

    def __len__(self) -> int:
        return self.put_idx - self.get_idx

    def __call__(self, image: np.ndarray) -> Dict[str, np.ndarray]:
        self.put(image)
        return self.get()

    def shutdown(self) -> None:
        for t in self._threads:
            if t.is_alive():
                self.task_queue.put(AsyncPredictor._StopToken())
        for t in self._threads:
            t.join()

    @property
    def default_buffer_size(self) -> int:
        return len(self._threads) * 5


def _on(stream):
    return torch.cuda.stream(stream) if stream is not None else contextlib.nullcontext()


def _raise_or(res):
    if isinstance(res, Exception):
        raise RuntimeError("an AsyncPredictor worker failed") from res
    return res


class VisualizationDemo:
    """run_on_image: predict + draw (divergen/predictor.py VisualizationDemo)."""

    def __init__(self, predictor: Predictor, class_names: Optional[Sequence[str]] = None):
        self.predictor = predictor
        self.class_names = class_names

    def run_on_image(self, image_rgb: np.ndarray):
        preds = self.predictor(image_rgb)
        vis = draw_instance_predictions(
            image_rgb.astype(np.uint8),
            preds["boxes"],
            preds["scores"],
            preds["classes"],
            preds["masks"],
            self.class_names,
        )
        return preds, vis
