"""EventStorage-equivalent metrics store + writers.

A copy of ``divergen_tpu/engine/events.py`` without ``TensorboardWriter``
(it needs tensorflow; ``do_train`` never builds it). Counterpart of
detectron2 ``utils/events.py`` (EventStorage with median smoothing,
``CommonMetricPrinter``, ``JSONWriter`` → metrics.json, flushed every 20
iters per ``DiverGen/train_net.py:154-162,300-303``). Host-side only —
scalars arrive as Python floats or numpy values.
"""
from __future__ import annotations

import json
import logging
import os
from collections import defaultdict, deque
from typing import Dict

logger = logging.getLogger(__name__)


class HistoryBuffer:
    """Windowed scalar history with median/latest (fvcore HistoryBuffer)."""

    def __init__(self, window: int = 20):
        self._window = window
        self._values: deque = deque(maxlen=window)
        self._latest: float = float("nan")
        self._count = 0
        self._global_sum = 0.0

    def update(self, value: float):
        self._values.append(value)
        self._latest = value
        self._count += 1
        self._global_sum += value

    @property
    def latest(self) -> float:
        return self._latest

    def median(self) -> float:
        vals = sorted(self._values)
        return vals[len(vals) // 2] if vals else float("nan")

    def avg(self) -> float:
        return sum(self._values) / max(len(self._values), 1)

    def global_avg(self) -> float:
        return self._global_sum / max(self._count, 1)


class EventStorage:
    def __init__(self, start_iter: int = 0, window: int = 20):
        self.iter = start_iter
        self._window = window
        self._histories: Dict[str, HistoryBuffer] = defaultdict(lambda: HistoryBuffer(window))

    def put_scalar(self, name: str, value) -> None:
        self._histories[name].update(float(value))

    def put_scalars(self, **kwargs) -> None:
        for k, v in kwargs.items():
            self.put_scalar(k, v)

    def histories(self) -> Dict[str, HistoryBuffer]:
        return dict(self._histories)

    def step(self) -> None:
        self.iter += 1


class JSONWriter:
    """metrics.json line writer (detectron2 utils/events.py JSONWriter)."""

    def __init__(self, path: str):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._f = open(path, "a")

    def write(self, storage: EventStorage) -> None:
        row = {"iteration": storage.iter}
        for k, h in storage.histories().items():
            row[k] = h.median()
        self._f.write(json.dumps(row) + "\n")
        self._f.flush()

    def close(self):
        self._f.close()


class CommonMetricPrinter:
    """Log-line writer: eta, iter, losses, time, lr (utils/events.py)."""

    def __init__(self, max_iter: int):
        self._max_iter = max_iter
        self._last = None  # (iter, time)

    def write(self, storage: EventStorage) -> None:
        it = storage.iter
        h = storage.histories()
        data_t = h["data_time"].avg() if "data_time" in h else None
        step_t = h["time"].median() if "time" in h else None
        lr = h["lr"].latest if "lr" in h else None
        eta = ""
        if step_t is not None:
            sec = step_t * (self._max_iter - it)
            eta = f"eta: {int(sec // 3600)}:{int(sec % 3600 // 60):02d}:{int(sec % 60):02d}  "
        losses = "  ".join(
            f"{k}: {v.median():.4g}" for k, v in h.items() if "loss" in k
        )
        parts = [f"{eta}iter: {it}", losses]
        if step_t is not None:
            parts.append(f"time: {step_t:.4f}")
        if data_t is not None:
            parts.append(f"data_time: {data_t:.4f}")
        if lr is not None:
            parts.append(f"lr: {lr:.3g}")
        logger.info("  ".join(p for p in parts if p))
