"""Train step and ``TrainState``.

Counterpart of ``divergen_tpu/engine/train_loop.py``: forward → sum of the
loss dict → backward → optimizer update → EMA update, returned as
``step(state, batch, rng) -> (state, metrics)``. The JAX step is a pure
function of an immutable state; here the model, the optimizer state and the
EMA copy are updated in place and the same ``TrainState`` comes back with its
counter raised. bfloat16 compute lives in the model (float32 parameters cast
at apply time); there is no loss scaling.

Over ranks (``group``): each rank's forward reduces its losses' normalizers
over the group, and between the backward and the optimizer the gradients are
averaged over it (``utils/comm.py:all_reduce_grads``), so the clip inside
``optimizer.step`` sees the global norm, as the JAX optax chain does on the
GSPMD gradients of the global batch. At a model axis above 1 ``group`` is the
data axis of a ``parallel.mesh.Mesh``; the leaves held as slices
(``ModelShards``) take their slice of the gradient from the backward, and the
optimizer's ``shards`` sums the slices' squares over the model group for the
clip.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch
import torch.nn as nn

from ..ops.losses import Rng
from ..parallel.mesh import Mesh
from ..solver.build import SolverOptimizer, ema_update
from ..utils.comm import all_reduce_grads


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


def reduce_grads_(optimizer: SolverOptimizer, group) -> None:
    """Each gradient of ``optimizer``'s parameters replaced by its mean over
    the ranks of ``group`` (a missing one counted as zeros); nothing with
    ``group`` None."""
    if group is None:
        return
    params = optimizer.parameters()
    for p, g in zip(params, all_reduce_grads([p.grad for p in params], group, like=params)):
        p.grad = g


def apply_losses(state: TrainState, losses: Dict[str, torch.Tensor], ema_decay: float,
                 loss_weights: Optional[Dict[str, float]] = None,
                 group=None) -> Dict[str, torch.Tensor]:
    """The second half of a step: weighted sum of the scalar losses (keys
    ``aux_*`` are per-row outputs, not losses), backward, the gradients'
    mean over the ranks of ``group``, optimizer, EMA. Returns the metrics:
    ``total_loss``, every loss, ``grad_norm`` (this rank's losses; their
    mean over the ranks is the global batch's)."""
    total = torch.zeros((), dtype=torch.float32, device=next(iter(losses.values())).device)
    for k, v in losses.items():
        if not k.startswith("aux_"):
            total = total + (loss_weights or {}).get(k, 1.0) * v.float()
    state.optimizer.zero_grad()
    total.backward()
    reduce_grads_(state.optimizer, group)
    grad_norm = state.optimizer.step()
    if state.ema_params is not None:
        ema_update(state.ema_params, state.params, ema_decay)
    state.step += 1
    metrics = {"total_loss": total.detach()}
    metrics.update({k: v.detach().float() for k, v in losses.items()})
    metrics["grad_norm"] = grad_norm
    return metrics


def make_train_step(model: nn.Module, optimizer: SolverOptimizer, ema_decay: float = 0.0,
                    loss_weights: Optional[Dict[str, float]] = None, group=None) -> Callable:
    """``step(state, batch, rng) -> (state, metrics)`` with batch
    ``{"images": (B, H, W, 3), "image_sizes": (B, 2), "gt": {...}`` and
    optionally ``"fed_weight"``}; ``rng`` is a ``torch.Generator`` on the
    batch's device, ``ops.losses.RankDraws`` over ranks, or a mapping of named
    draws (``ops.losses.uniform_draw``). ``state`` must hold ``model`` and
    ``optimizer``. ``group``: a process group, or a ``parallel.mesh.Mesh``
    (its data axis); the batch is then this rank's rows of the global
    batch, and the step computes what one process computes on the global
    batch."""
    if isinstance(group, Mesh):
        group = group.group

    def step_fn(state: TrainState, batch, rng: Rng):
        assert state.model is model and state.optimizer is optimizer
        losses = model(batch["images"], batch["image_sizes"], gt=batch["gt"], rng=rng,
                       fed_weight=batch.get("fed_weight"), training=True, group=group)
        return state, apply_losses(state, losses, ema_decay, loss_weights, group)

    return step_fn
