"""The training entry's step: on-device copy-paste, then the train step.

Counterpart of ``divergen_tpu/engine/trainer.py`` for ``load_fed_weight`` and
``make_paste_train_step``: compositing (box-frame) → forward → backward →
optimizer → EMA on the device. ``do_train`` with its data loader,
checkpointing and evaluation is not ported yet.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn as nn

from ..ops.copy_paste import normalize_cp_method, paste_instances_boxframe
from ..ops.losses import Rng
from ..solver.build import SolverOptimizer
from .train_loop import TrainState, apply_losses


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


def make_paste_train_step(model: nn.Module, optimizer: SolverOptimizer, cfg) -> Callable:
    """``step(state, batch, rng) -> (state, metrics)`` with the compositing in
    front of the forward. batch: ``image`` (B, H, W, 3), ``image_size`` (B, 2),
    ``gt`` (masks, boxes, classes, valid, instance_source), and with
    ``INPUT.USE_COPY_PASTE`` the patches to paste (``patches`` (B, P, ps, ps,
    4), ``patch_boxes``, ``patch_classes``, ``patch_valid``, ``patch_flip``,
    optionally ``patch_angle``); ``fed_weight`` in the batch overrides the
    file's. The metrics are ``total_loss`` and every loss."""
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
        losses = model(images, batch["image_size"], gt=gt, rng=rng, fed_weight=fed, training=True)
        metrics = apply_losses(state, losses, ema_decay)
        del metrics["grad_norm"]
        return state, metrics

    return step_fn
