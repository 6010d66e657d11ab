"""Entry points of the detector: configs, a ready-to-call inference model and
a ready-to-call train step.

Counterpart of ``__graft_entry__.py`` (``_small_cfg``, ``_synth_gt``,
``_fast_init``, ``entry``, ``dryrun_train`` for the one-device part of
``dryrun_multichip``, and ``dryrun_multichip`` over gloo processes on the
CPU), plus ``flagship_cfg`` for ``configs/DiverGen_swinL.yaml``.

    model, (images, image_sizes) = entry()          # on the card
    dets = model(images, image_sizes)               # padded detections
    model, args = entry(device="cpu")               # the same on the CPU
    model, args = flagship_entry()                  # Swin-L at 896², B = 2, bfloat16
    step, (state, batch, rng) = train_entry()       # copy-paste + train step
    state, metrics = step(state, batch, rng)
    step, args = flagship_train_entry()             # the same at full width
    dryrun_train()                                  # one checked step (ResNet-18)
    dryrun_multichip(4)                             # the same over 4 gloo ranks
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Tuple

import numpy as np
import torch
import torch.nn as nn

from .config import ConfigNode, get_cfg
from .engine.train_loop import TrainState, create_train_state, make_train_step
from .engine.trainer import make_paste_train_step
from .modeling.layers import BatchNorm, FrozenBatchNorm, Scale
from .modeling.meta_arch.rcnn import CustomRCNN, build_model
from .solver.build import build_optimizer
from .utils.dist import entry_device


def _small_cfg(num_classes: int = 8, backbone: str = "resnet", swin_size: str = "T",
               levels=None) -> ConfigNode:
    """The JAX package's small detector config: few classes, few proposals
    and detections, float32; ResNet-18 + FPN (the default backbone
    ``"resnet"``, as the JAX ``dryrun_multichip`` builds it) or, with
    ``backbone="swin"``, Swin of ``swin_size`` (the JAX ``entry()``'s).
    ``levels`` keeps that many proposal levels."""
    cfg = get_cfg()
    if levels:
        cn = cfg.MODEL.CENTERNET
        cn.IN_FEATURES, cn.FPN_STRIDES = cn.IN_FEATURES[:levels], cn.FPN_STRIDES[:levels]
        cn.SOI = cn.SOI[:levels - 1] + [[cn.SOI[levels - 1][0], 10000000]]
    cfg.MODEL.CENTERNET.NUM_CLASSES = num_classes
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = num_classes
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 64
    cfg.MODEL.CENTERNET.PRE_NMS_TOPK_TRAIN = 64
    cfg.MODEL.CENTERNET.POST_NMS_TOPK_TRAIN = 32
    cfg.MODEL.CENTERNET.PRE_NMS_TOPK_TEST = 64
    cfg.MODEL.CENTERNET.POST_NMS_TOPK_TEST = 32
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.TEST.DETECTIONS_PER_IMAGE = 16
    cfg.FP16 = False
    if backbone == "swin":
        cfg.MODEL.BACKBONE.NAME = "build_swintransformer_fpn_backbone"
        cfg.MODEL.SWIN.SIZE = swin_size
    return cfg


def flagship_cfg() -> ConfigNode:
    """``get_cfg()`` with what ``configs/DiverGen_swinL.yaml`` over
    ``configs/Base-C2_L_R5021k_640b64_4x.yaml`` sets for the model and the
    test path: Swin-L-22k-384 + FPN, CenterNet2 proposals, the three-stage
    Detic cascade over 1453 classes, the mask head, 896², bfloat16; and for
    the train step: AdamW at 1e-4 under a warm-up cosine schedule, full-model
    gradient clipping, EMA 0.999, the federated loss, 4000 / 2000 training
    proposals, copy-paste with the ``basic`` blend, rematerialized Swin
    blocks."""
    cfg = get_cfg()
    cfg.merge_from_list([
        "MODEL.BACKBONE.NAME", "build_swintransformer_fpn_backbone",
        "MODEL.SWIN.SIZE", "L-22k-384",
        "MODEL.SWIN.USE_CHECKPOINT", "true",
        "MODEL.SWIN.FUSED_ATTN", "true",
        "MODEL.FPN.IN_FEATURES", "['s3', 's4', 's5']",
        "MODEL.WEIGHTS", "models/swin_large_patch4_window12_384_22k.pkl",
        "MODEL.ROI_HEADS.NUM_CLASSES", "1453",
        "MODEL.ROI_HEADS.IOU_THRESHOLDS", "[0.6]",
        "MODEL.ROI_BOX_CASCADE_HEAD.IOUS", "[0.6, 0.7, 0.8]",
        "MODEL.ROI_BOX_HEAD.USE_ZEROSHOT_CLS", "false",
        "MODEL.ROI_BOX_HEAD.CAT_FREQ_PATH",
        "datasets/metadata/ImageNet2012_filtered04_lvis_v1_train_cat_info_250.json",
        "MODEL.CENTERNET.NUM_CLASSES", "1453",
        "MODEL.CENTERNET.POS_WEIGHT", "0.5",
        "MODEL.CENTERNET.NEG_WEIGHT", "0.5",
        "MODEL.CENTERNET.REG_WEIGHT", "1.0",
        "MODEL.MODEL_EMA", "0.999",
        "TEST.DETECTIONS_PER_IMAGE", "300",
        "TEST.EVAL_PERIOD", "10000",
        "INPUT.TRAIN_SIZE", "896",
        "INPUT.TEST_SIZE", "896",
        "INPUT.USE_COPY_PASTE", "true",
        "INPUT.INST_POOL_PATH", "LVIS_instance_pools.json",
        "SOLVER.MAX_ITER", "180000",
        "SOLVER.WARMUP_FACTOR", "0.0001",
        "SOLVER.CLIP_GRADIENTS.ENABLED", "true",
        "DATALOADER.SAMPLER_TRAIN", "RepeatFactorTrainingSampler",
        "DATALOADER.NUM_WORKERS", "16",
        "DATASETS.TRAIN", "['lvis_v1_train']",
        "DATASETS.TEST", "['lvis_v1_val']",
        "OUTPUT_DIR", "./output/auto",
        "FP16", "true",
    ])
    return cfg


@torch.no_grad()
def fast_init_(module: nn.Module, gen: torch.Generator) -> nn.Module:
    """Seeded random weights under the conventions of the JAX package's
    ``_fast_init``: norm and ``Scale`` scales at 1, biases at 0, every other
    parameter normal with std 1/√fan_in (fan-in as flax counts it: inputs ×
    kernel area of a dense or conv kernel, rows of a table, 1 for a vector).
    Drawn on the CPU from ``gen`` and copied, so a seed gives the same weights
    on any device."""
    scale_like = (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm, BatchNorm, Scale)
    for mod in module.modules():
        for name, p in mod.named_parameters(recurse=False):
            if name == "weight" and isinstance(mod, scale_like):
                p.fill_(1.0)
            elif name == "bias":
                p.zero_()
            else:
                if isinstance(mod, nn.ConvTranspose2d):
                    fan_in = p[:, 0].numel()  # (in, out, kh, kw)
                elif isinstance(mod, (nn.Linear, nn.Conv2d)):
                    fan_in = p[0].numel()  # (out, in[, kh, kw])
                else:
                    fan_in = p.shape[0] if p.dim() >= 2 else 1
                draw = torch.empty(p.shape, dtype=torch.float32).normal_(
                    0.0, math.sqrt(1.0 / max(fan_in, 1)), generator=gen)
                p.copy_(draw)
    return module


SEED = 0  # of the random weights and example images


def entry(device=None) -> Tuple[CustomRCNN, Tuple[torch.Tensor, torch.Tensor]]:
    """``(model, (images, image_sizes))``: the small Swin detector with seeded
    random weights and one 128 × 128 example image, ready for
    ``model(images, image_sizes)``. Runs on the card unless ``device`` names
    another one; without a card and without a request it raises. It computes
    in float32 on any device, as the JAX package's ``entry()`` does (the
    window-attention kernels take float32 on the card)."""
    dev = entry_device(device)
    cfg = _small_cfg(backbone="swin")
    model = build_model(cfg, input_size=(128, 128), device=dev)
    gen = torch.Generator().manual_seed(SEED)
    fast_init_(model, gen).eval()
    images = (torch.rand(1, 128, 128, 3, generator=gen) * 255).to(dev)
    image_sizes = torch.tensor([[128, 128]], device=dev)
    return model, (images, image_sizes)


def flagship_entry(device=None) -> Tuple[CustomRCNN, Tuple[torch.Tensor, torch.Tensor]]:
    """``(model, (images, image_sizes))`` for the flagship detector
    (``flagship_cfg``: Swin-L + FPN + CenterNet2 + Detic cascade + mask head,
    bfloat16) with seeded random weights (``fast_init_``: no checkpoint is
    read) and two random canvases of ``INPUT.TEST_SIZE`` (896) a side, the
    second image smaller than its canvas. For smoke runs, timing and
    profiling; the device rule is ``entry``'s."""
    dev = entry_device(device)
    cfg = flagship_cfg()
    size = cfg.INPUT.TEST_SIZE
    model = build_model(cfg, device=dev)
    gen = torch.Generator().manual_seed(SEED)
    fast_init_(model, gen).eval()
    images = (torch.rand(2, size, size, 3, generator=gen) * 255).to(dev)
    sizes = [[size, size], [size - size // 8, size - size // 4]]
    return model, (images, torch.tensor(sizes, device=dev))


def _synth_gt(rng: np.random.RandomState, b: int, n: int, num_classes: int, img: int = 128,
              device=None) -> Dict[str, torch.Tensor]:
    """Synthetic ground truth as the JAX package's ``_synth_gt`` draws it:
    ``n`` boxes per image of which the first three are valid, random classes
    and random 28 × 28 box-frame masks."""
    xy = rng.rand(b, n, 2) * (img - 40)
    wh = rng.rand(b, n, 2) * 30 + 8
    boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
    classes = rng.randint(0, num_classes, (b, n))
    masks = (rng.rand(b, n, 28, 28) > 0.4).astype(np.float32)
    valid = np.broadcast_to(np.arange(n)[None] < 3, (b, n)).copy()
    gt = {"boxes": torch.from_numpy(boxes), "classes": torch.from_numpy(classes).long(),
          "valid": torch.from_numpy(valid), "masks": torch.from_numpy(masks),
          "instance_source": torch.zeros((b, n), dtype=torch.long)}
    return {k: v.to(device) for k, v in gt.items()}


def _train_parts(cfg: ConfigNode, dev: torch.device, size: int, batch: int, gt_valid: int,
                 input_size) -> Tuple[Callable, Tuple[TrainState, Dict, torch.Generator]]:
    """A model with float32 parameters, its optimizer and state, the
    copy-paste train step, one seeded batch and the generator of the step's
    draws, all on ``dev``."""
    model = build_model(cfg, input_size=input_size, device=dev, param_dtype=torch.float32)
    gen = torch.Generator().manual_seed(SEED)
    fast_init_(model, gen)
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, ema=cfg.MODEL.MODEL_EMA > 0)
    step = make_paste_train_step(model, optimizer, cfg)

    rng = np.random.RandomState(SEED)
    n, p, ps = cfg.DATALOADER.MAX_INSTANCES, cfg.DATALOADER.MAX_PASTES, cfg.DATALOADER.PATCH_SIZE
    classes = cfg.MODEL.ROI_HEADS.NUM_CLASSES
    gt = _synth_gt(rng, batch, n, classes, img=size)
    gt["valid"] = torch.arange(n)[None].expand(batch, n) < gt_valid
    # boxes as large, relative to the canvas, as _synth_gt's are at 128 px
    xy, wh = gt["boxes"][..., :2], (gt["boxes"][..., 2:] - gt["boxes"][..., :2]) * (size / 128.0)
    gt["boxes"] = torch.cat([xy, (xy + wh).clamp(max=float(size))], dim=-1)
    xy = rng.rand(batch, p, 2) * (size * 0.6)
    wh = rng.rand(batch, p, 2) * (size * 0.2) + size * 0.08
    batch_dict = {
        "image": torch.from_numpy((rng.rand(batch, size, size, 3) * 255).astype(np.float32)),
        "image_size": torch.tensor([[size, size]] * batch),
        "gt": gt,
        "patches": torch.from_numpy(np.concatenate(
            [rng.rand(batch, p, ps, ps, 3) * 255, rng.rand(batch, p, ps, ps, 1) > 0.3],
            -1).astype(np.float32)),
        "patch_boxes": torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(np.float32)),
        "patch_classes": torch.from_numpy(rng.randint(0, classes, (batch, p))).long(),
        "patch_valid": torch.arange(p)[None].expand(batch, p) < max(p // 2, 1),
        "patch_flip": torch.from_numpy(rng.rand(batch, p) > 0.5),
        # a synthetic class-frequency vector: the file the config names is not in the repository
        "fed_weight": torch.from_numpy((rng.rand(classes) * 100 + 1).astype(np.float32) ** 0.5),
    }
    to_dev = lambda v: {k: to_dev(x) for k, x in v.items()} if isinstance(v, dict) else v.to(dev)
    return step, (state, to_dev(batch_dict), torch.Generator(device=dev).manual_seed(SEED))


def train_entry(device=None):
    """``(step, (state, batch, rng))``: the small Swin detector with float32
    parameters and seeded random weights, AdamW with gradient clipping, EMA,
    the copy-paste train step (``engine.trainer.make_paste_train_step``) and
    one seeded 128 × 128 batch of two images with patches to paste;
    ``state, metrics = step(state, batch, rng)``. The device rule is
    ``entry``'s: float32 on the card and on the CPU, as the JAX
    ``_small_cfg()``. The Swin-T model is this entry's own: the JAX package
    has no train entry."""
    dev = entry_device(device)
    cfg = _small_cfg(backbone="swin")
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    cfg.MODEL.MODEL_EMA = 0.999
    cfg.INPUT.USE_COPY_PASTE = True
    cfg.MODEL.ROI_BOX_HEAD.FED_LOSS_NUM_CAT = 4  # of the small config's 8 classes
    cfg.DATALOADER.MAX_INSTANCES = 8
    cfg.DATALOADER.MAX_PASTES = 4
    cfg.DATALOADER.PATCH_SIZE = 32
    return _train_parts(cfg, dev, 128, 2, 3, (128, 128))


def flagship_train_entry(device=None, remat: bool = True):
    """``train_entry`` at full width: ``flagship_cfg`` (Swin-L, 1453 classes,
    896², bfloat16 compute over float32 parameters, AdamW, clipping, EMA, the
    federated loss, copy-paste), two images, 100 ground-truth slots of which
    20 are valid and 8 patch slots of 128 px of which 4 are valid per image.
    ``remat=False`` turns the config's ``MODEL.SWIN.USE_CHECKPOINT`` off."""
    dev = entry_device(device)
    cfg = flagship_cfg()
    cfg.MODEL.SWIN.USE_CHECKPOINT = bool(remat)
    return _train_parts(cfg, dev, cfg.INPUT.TRAIN_SIZE, 2, 20, None)


def _dryrun_cfg() -> ConfigNode:
    """The JAX dryrun's ResNet-18 + FPN at 64², with clipping."""
    cfg = _small_cfg()
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 32
    cfg.MODEL.CENTERNET.PRE_NMS_TOPK_TRAIN = 32
    cfg.MODEL.CENTERNET.POST_NMS_TOPK_TRAIN = 16
    cfg.SOLVER.CLIP_GRADIENTS.ENABLED = True
    return cfg


def dryrun_train(device=None) -> Dict[str, float]:
    """One train step on the JAX dryrun's model, ResNet-18 + FPN
    (``_small_cfg()``), at 64 × 64 with clipping and EMA on (the one-device
    part of the JAX package's ``dryrun_multichip``), in float32 on any device
    as the JAX ``_small_cfg()``: checks that the step
    counter is 1 and every metric is finite, prints and returns the metrics.
    Weights, batch and the step's uniform draws come from CPU generators and
    numpy seeds, so the card and the CPU take the same step."""
    dev = entry_device(device)
    cfg = _dryrun_cfg()
    model = build_model(cfg, input_size=(64, 64), device=dev, param_dtype=torch.float32)
    fast_init_(model, torch.Generator().manual_seed(SEED))
    optimizer = build_optimizer(cfg, model)
    state = create_train_state(model, optimizer, ema=True)
    rng = np.random.RandomState(SEED)
    batch = {"images": torch.from_numpy(rng.rand(1, 64, 64, 3).astype(np.float32) * 255).to(dev),
             "image_sizes": torch.tensor([[64, 64]], device=dev),
             "gt": _synth_gt(rng, 1, 8, 8, img=64, device=dev)}
    step = make_train_step(model, optimizer, ema_decay=0.999)
    state, metrics = step(state, batch, torch.Generator().manual_seed(2))
    out = {k: float(v) for k, v in metrics.items()}
    assert state.step == 1
    for k, v in out.items():
        assert math.isfinite(v), f"{k} not finite"
    print(f"dryrun_train OK: device={dev}, total_loss={out['total_loss']:.4f}")
    return out


def _dryrun_rank(rank: int, n: int, store: str, out: str) -> None:
    """One rank of ``dryrun_multichip``: its image of the global batch."""
    import json

    import torch.distributed as dist

    from .ops.losses import RankDraws
    from .parallel.mesh import batch_sharding, create_mesh, shard_pytree
    from .utils import comm

    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, n), rank=rank, world_size=n)
    try:
        mesh = create_mesh(data=-1, model=1)
        cfg = _dryrun_cfg()
        model = build_model(cfg, input_size=(64, 64), device="cpu", param_dtype=torch.float32)
        fast_init_(model, torch.Generator().manual_seed(SEED + rank))  # rank 0's win
        shard_pytree(model, mesh)
        optimizer = build_optimizer(cfg, model)
        state = create_train_state(model, optimizer, ema=True)
        rng = np.random.RandomState(0)
        b = mesh.shape["data"]  # one image a rank, as the JAX dryrun
        batch = batch_sharding(mesh)({
            "images": torch.from_numpy(rng.rand(b, 64, 64, 3).astype(np.float32) * 255),
            "image_sizes": torch.tensor([[64, 64]] * b), "gt": _synth_gt(rng, b, 8, 8, img=64)})
        step = make_train_step(model, optimizer, ema_decay=0.999, group=mesh)
        state, metrics = step(state, batch, RankDraws(torch.Generator().manual_seed(2), rank, b))
        metrics = comm.reduce_dict({k: float(v) for k, v in metrics.items()})
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"step": state.step, "metrics": metrics}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int) -> Dict[str, float]:
    """``dryrun_train`` over ``n_devices`` ranks: gloo processes on the CPU
    (``torch.multiprocessing.spawn``, a ``FileStore`` rendezvous), one image a
    rank, the model axis 1 (the JAX dryrun's ``model = 2`` layout is not
    ported: ROADMAP.md §1, item 4). Checks that the step counter is 1 and
    every metric (the mean over the ranks) is finite; prints and returns the
    metrics."""
    import json
    import os
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "metrics.json")
        mp.spawn(_dryrun_rank, args=(n_devices, os.path.join(tmp, "store"), out),
                 nprocs=n_devices)
        with open(out) as f:
            res = json.load(f)
    assert res["step"] == 1
    for k, v in res["metrics"].items():
        assert math.isfinite(v), f"{k} not finite"
    print(f"dryrun_multichip OK: mesh=({n_devices}x1), batch={n_devices}, "
          f"total_loss={res['metrics']['total_loss']:.4f}")
    return res["metrics"]
