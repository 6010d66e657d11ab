"""Checkpointing of a ``TrainState``: model, EMA, optimizer and step.

Counterpart of ``divergen_tpu/engine/checkpoint.py`` with its API (``save``,
``wait``, ``latest_step``, ``restore``, ``resume_or_load``, ``max_to_keep``;
``PeriodicCheckpointer``). The JAX package writes orbax checkpoints; here a
step is one ``torch.save`` file, ``<output_dir>/checkpoints/step_<N>.pt``,
of ``{"step", "model" (state_dict), "ema_params", "optimizer"}``, read back
with ``torch.load(weights_only=True)``. orbax checkpoints are not read (that
needs JAX); JAX weights come in through ``utils/convert.py:params_from_jax``.
Saves are synchronous, so ``wait`` has nothing to wait for.
"""
from __future__ import annotations

import logging
import os
import re
from typing import Any, Dict, List, Optional

import torch

from .train_loop import TrainState

logger = logging.getLogger(__name__)

_NAME = re.compile(r"^step_(\d+)\.pt$")


def _cpu(tree):
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    if isinstance(tree, dict):
        return {k: _cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_cpu(v) for v in tree)
    return tree


class Checkpointer:
    def __init__(self, output_dir: str, max_to_keep: int = 5):
        self.dir = os.path.abspath(os.path.join(output_dir, "checkpoints"))
        os.makedirs(self.dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{int(step)}.pt")

    def all_steps(self) -> List[int]:
        return sorted(int(m.group(1)) for m in map(_NAME.match, os.listdir(self.dir)) if m)

    def save(self, step: int, state: TrainState, force: bool = False) -> None:
        """Write ``state`` as step ``step`` (``force`` overwrites an existing
        step), then keep the newest ``max_to_keep`` steps."""
        path = self.path(step)
        if os.path.exists(path) and not force:
            logger.info("checkpoint step %d exists; not overwritten", step)
            return
        opt = state.optimizer
        payload = {
            "step": int(state.step),
            "model": _cpu(state.model.state_dict()),
            "ema_params": _cpu(state.ema_params) if state.ema_params is not None else None,
            "optimizer": (None if opt is None else
                          {"optim": _cpu(opt.optim.state_dict()), "count": int(opt.count)}),
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)  # atomic: a reader never sees a partial file
        if self.max_to_keep:
            for old in self.all_steps()[:-self.max_to_keep]:
                os.remove(self.path(old))

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX package's API."""

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def load(self, step: Optional[int] = None) -> Dict[str, Any]:
        """The raw checkpoint dict of ``step`` (default: the newest)."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint in {self.dir}")
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, state_template: TrainState, step: Optional[int] = None) -> TrainState:
        """Load step ``step`` (default: the newest) into the template's model,
        EMA copy and optimizer, in place, and return it."""
        raw = self.load(step)
        state_template.model.load_state_dict(raw["model"])
        if state_template.ema_params is not None and raw["ema_params"] is not None:
            for k, v in raw["ema_params"].items():
                state_template.ema_params[k].copy_(v)
        opt = state_template.optimizer
        if opt is not None and raw["optimizer"] is not None:
            opt.optim.load_state_dict(raw["optimizer"]["optim"])
            opt.count = raw["optimizer"]["count"]
        state_template.step = raw["step"]
        return state_template

    def resume_or_load(self, state_template: TrainState, resume: bool = True):
        """(state, start_iter): resume from latest if present, else the
        template unchanged at iter 0 (DetectionCheckpointer.resume_or_load)."""
        step = self.latest_step()
        if resume and step is not None:
            logger.info("resuming from checkpoint step %d", step)
            return self.restore(state_template, step), step
        return state_template, 0


class PeriodicCheckpointer:
    """Save every ``period`` iters + at max_iter (detectron2 semantics)."""

    def __init__(self, checkpointer: Checkpointer, period: int, max_iter: int):
        self.ckpt = checkpointer
        self.period = max(int(period), 1)
        self.max_iter = max_iter

    def step(self, iteration: int, state: TrainState) -> None:
        it = int(iteration)
        if (it + 1) % self.period == 0 or (it + 1) >= self.max_iter:
            self.ckpt.save(it + 1, state)
