"""Optimizer and learning-rate schedule builders.

Counterpart of ``divergen_tpu/solver/build.py`` (optax there, ``torch.optim``
here): ``WarmupCosineLR`` / ``WarmupMultiStepLR`` schedules, per-parameter
learning-rate groups (the backbone multiplier, custom keyword multipliers),
AdamW or SGD with momentum, full-model gradient clipping, and the EMA update.

One step moves every parameter as the optax chain does:

- the schedule is evaluated at the count of steps taken so far (0 at the first
  step) and multiplied by the group's multiplier;
- clipping is ``optax.clip_by_global_norm``: gradients are left alone while
  their global norm is below the limit and scaled by ``limit / norm`` otherwise
  (``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``);
- ``torch.optim.AdamW`` multiplies a parameter by ``1 − lr·wd`` and
  ``optax.adamw`` adds ``wd·p`` to the Adam direction: the same update to
  rounding, eps 1e-8 outside the root in both;
- a parameter that took no part in the loss has a zero gradient in JAX and so
  still decays; its ``None`` gradient becomes zeros here.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, Optional, Sequence

import torch
import torch.nn as nn

from ..parallel.mesh import model_shards


def warmup_cosine_lr(base_lr: float, max_iter: int, warmup_iters: int,
                     warmup_factor: float = 1e-3) -> Callable[[int], float]:
    """Linear warm-up from ``base_lr · warmup_factor``, then cosine decay to 0
    over ``max_iter``."""

    def schedule(step: int) -> float:
        if step < warmup_iters:
            alpha = step / max(warmup_iters, 1)
            return base_lr * (warmup_factor * (1 - alpha) + alpha)
        return base_lr * 0.5 * (1.0 + math.cos(math.pi * step / max(max_iter, 1)))

    return schedule


def warmup_multistep_lr(base_lr: float, steps: Sequence[int], gamma: float = 0.1,
                        warmup_iters: int = 1000,
                        warmup_factor: float = 1e-3) -> Callable[[int], float]:
    """Staircase decay by ``gamma`` at each milestone, after a linear warm-up."""
    milestones = tuple(steps)

    def schedule(step: int) -> float:
        warmup = 1.0
        if step < warmup_iters:
            alpha = step / max(warmup_iters, 1)
            warmup = warmup_factor * (1 - alpha) + alpha
        return base_lr * warmup * gamma ** sum(step >= m for m in milestones)

    return schedule


def build_lr_schedule(cfg) -> Callable[[int], float]:
    name = cfg.SOLVER.LR_SCHEDULER_NAME
    if name == "WarmupCosineLR":
        return warmup_cosine_lr(cfg.SOLVER.BASE_LR, cfg.SOLVER.MAX_ITER, cfg.SOLVER.WARMUP_ITERS,
                                cfg.SOLVER.WARMUP_FACTOR)
    if name == "WarmupMultiStepLR":
        return warmup_multistep_lr(cfg.SOLVER.BASE_LR, cfg.SOLVER.STEPS, cfg.SOLVER.GAMMA,
                                   cfg.SOLVER.WARMUP_ITERS, cfg.SOLVER.WARMUP_FACTOR)
    raise ValueError(f"unknown LR scheduler {name}")


def _lr_multiplier_labels(names: Iterable[str], backbone_prefix: str,
                          custom_multipliers: Dict[str, float]) -> Dict[str, str]:
    """The learning-rate group of each parameter name: a custom keyword in the
    name → ``custom:<keyword>``; the backbone's scope in it → ``backbone``;
    else ``default``. A name is matched as its ``/``-joined path, as the JAX
    package matches its tree paths."""

    def label_for(name: str) -> str:
        keys = name.replace(".", "/")
        for kw in custom_multipliers:
            if kw in keys:
                return f"custom:{kw}"
        if backbone_prefix and backbone_prefix in keys:
            return "backbone"
        return "default"

    return {name: label_for(name) for name in names}


class SolverOptimizer:
    """A ``torch.optim`` optimizer with its schedule, its groups' multipliers
    and the clipping limit; ``count`` is the number of steps taken.
    ``shards``: the ``parallel.mesh.ModelShards`` of a model whose leaves are
    held as slices over the model group, whose squares the global norm sums
    over that group."""

    def __init__(self, optim: torch.optim.Optimizer, schedule: Callable[[int], float],
                 clip_value: Optional[float]):
        self.optim, self.schedule, self.clip_value = optim, schedule, clip_value
        self.count = 0
        self.shards = None

    def parameters(self):
        return [p for group in self.optim.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.optim.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Clip, set each group's learning rate for this step, update. Returns
        the global norm of the gradients before clipping (float32 scalar)."""
        params = self.parameters()
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        # float64 sums: the CPU's float32 norm of a 12.8 M-element weight
        # drifts by 7e-4 (ResNet-18's box-head fc1), where XLA's stays exact
        norms = torch.stack(torch._foreach_norm(grads, 2, dtype=torch.float64)) if grads \
            else torch.zeros((1,), dtype=torch.float64)
        if self.shards is None:
            norm = torch.linalg.vector_norm(norms).float()
        else:
            held = self.shards.held()
            norm = self.shards.global_sum(norms.square(), [id(p) in held for p in params]
                                          ).sqrt().float()
        if self.clip_value is not None:
            scale = torch.where(norm < self.clip_value, torch.ones_like(norm),
                                self.clip_value / norm)
            torch._foreach_mul_(grads, scale.to(grads[0].dtype))
        lr = self.schedule(self.count)
        for group in self.optim.param_groups:
            group["lr"] = lr * group["multiplier"]
        self.optim.step()
        self.count += 1
        return norm


def build_optimizer(cfg, model: nn.Module) -> SolverOptimizer:
    """AdamW or SGD with momentum over ``model``'s parameters, with the
    schedule, the per-group multipliers (``SOLVER.BACKBONE_MULTIPLIER`` for
    names under ``bottom_up``, ``SOLVER.CUSTOM_MULTIPLIER`` for names holding a
    ``SOLVER.CUSTOM_MULTIPLIER_NAME`` keyword) and full-model gradient
    clipping. Over a model whose leaves ``parallel.mesh.shard_pytree`` cut to
    slices, the norm sums the slices' squares over the model group."""
    custom = {name: cfg.SOLVER.CUSTOM_MULTIPLIER for name in cfg.SOLVER.CUSTOM_MULTIPLIER_NAME}
    multipliers = {"default": 1.0, "backbone": cfg.SOLVER.BACKBONE_MULTIPLIER,
                   **{f"custom:{name}": mult for name, mult in custom.items()}}
    named = dict(model.named_parameters())
    labels = _lr_multiplier_labels(named, "bottom_up", custom)
    groups = [{"params": [p for n, p in named.items() if labels[n] == label],
               "multiplier": mult, "name": label} for label, mult in multipliers.items()]
    groups = [g for g in groups if g["params"]]
    wd = cfg.SOLVER.WEIGHT_DECAY
    opt_name = cfg.SOLVER.OPTIMIZER.upper()
    if opt_name == "ADAMW":
        optim = torch.optim.AdamW(groups, lr=cfg.SOLVER.BASE_LR, betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=wd, foreach=True)
    elif opt_name == "SGD":
        optim = torch.optim.SGD(groups, lr=cfg.SOLVER.BASE_LR, momentum=cfg.SOLVER.MOMENTUM,
                                weight_decay=wd, foreach=True)
    else:
        raise ValueError(f"unknown optimizer {opt_name}")
    clip = cfg.SOLVER.CLIP_GRADIENTS
    opt = SolverOptimizer(optim, build_lr_schedule(cfg), clip.CLIP_VALUE if clip.ENABLED else None)
    opt.shards = model_shards(model)
    return opt


@torch.no_grad()
def ema_update(ema_params: Dict[str, torch.Tensor], params: Dict[str, torch.Tensor],
               decay: float) -> Dict[str, torch.Tensor]:
    """``ema = decay · ema + (1 − decay) · p`` for every name, in place on the
    (float32) EMA tensors, which are also returned."""
    ema = list(ema_params.values())
    torch._foreach_mul_(ema, decay)
    torch._foreach_add_(ema, [params[k].detach().to(e.dtype) for k, e in ema_params.items()],
                        alpha=1.0 - decay)
    return ema_params
