"""Train step and ``TrainState``.

Counterpart of ``divergen_tpu/engine/train_loop.py``: forward → sum of the
loss dict → backward → optimizer update → EMA update, returned as
``step(state, batch, rng) -> (state, metrics)``. The JAX step is a pure
function of an immutable state; here the model, the optimizer state and the
EMA copy are updated in place and the same ``TrainState`` comes back with its
counter raised. bfloat16 compute lives in the model (float32 parameters cast
at apply time); there is no loss scaling.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..ops.losses import Rng
from ..solver.build import SolverOptimizer, ema_update


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: SolverOptimizer
    ema_params: Optional[Dict[str, torch.Tensor]] = None  # None disables EMA

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())


def create_train_state(model: nn.Module, optimizer: SolverOptimizer, ema: bool) -> TrainState:
    """Step 0 with, if ``ema``, a float32 copy of every parameter."""
    ema_params = None
    if ema:
        ema_params = {k: p.detach().to(torch.float32, copy=True)
                      for k, p in model.named_parameters()}
    return TrainState(step=0, model=model, optimizer=optimizer, ema_params=ema_params)


def apply_losses(state: TrainState, losses: Dict[str, torch.Tensor], ema_decay: float,
                 loss_weights: Optional[Dict[str, float]] = None) -> Dict[str, torch.Tensor]:
    """The second half of a step: weighted sum of the scalar losses (keys
    ``aux_*`` are per-row outputs, not losses), backward, optimizer, EMA.
    Returns the metrics: ``total_loss``, every loss, ``grad_norm``."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(losses.values())).device)
    for k, v in losses.items():
        if not k.startswith("aux_"):
            total = total + (loss_weights or {}).get(k, 1.0) * v.float()
    state.optimizer.zero_grad()
    total.backward()
    grad_norm = state.optimizer.step()
    if state.ema_params is not None:
        ema_update(state.ema_params, state.params, ema_decay)
    state.step += 1
    metrics = {"total_loss": total.detach()}
    metrics.update({k: v.detach().float() for k, v in losses.items()})
    metrics["grad_norm"] = grad_norm
    return metrics


def make_train_step(model: nn.Module, optimizer: SolverOptimizer, ema_decay: float = 0.0,
                    loss_weights: Optional[Dict[str, float]] = None) -> Callable:
    """``step(state, batch, rng) -> (state, metrics)`` with batch
    ``{"images": (B, H, W, 3), "image_sizes": (B, 2), "gt": {...}`` and
    optionally ``"fed_weight"``}; ``rng`` is a ``torch.Generator`` on the
    batch's device or a mapping of named draws (``ops.losses.uniform_draw``).
    ``state`` must hold ``model`` and ``optimizer``."""

    def step_fn(state: TrainState, batch, rng: Rng):
        assert state.model is model and state.optimizer is optimizer
        losses = model(batch["images"], batch["image_sizes"], gt=batch["gt"], rng=rng,
                       fed_weight=batch.get("fed_weight"), training=True)
        return state, apply_losses(state, losses, ema_decay, loss_weights)

    return step_fn
