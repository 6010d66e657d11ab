"""Entry points of the detector: configs and a ready-to-call inference model.

Counterpart of ``__graft_entry__.py`` (``_small_cfg``, ``_fast_init``,
``entry``) for the inference forward, plus ``flagship_cfg`` for the model of
``configs/DiverGen_swinL.yaml``. ``dryrun_multichip`` (the sharded training
step) belongs to the training slice and is not ported yet.

    model, (images, image_sizes) = entry()          # on the card
    dets = model(images, image_sizes)               # padded detections
    model, args = entry(device="cpu")               # the same on the CPU
    model, args = flagship_entry()                  # Swin-L at 896², B = 2, bfloat16
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from .config import ConfigNode, get_cfg
from .modeling.layers import FrozenBatchNorm, Scale
from .modeling.meta_arch.rcnn import CustomRCNN, build_model
from .utils.dist import entry_device


def _small_cfg(num_classes: int = 8, swin_size: str = "T") -> ConfigNode:
    """The small Swin detector of the JAX package's ``entry()``: few classes,
    few proposals and detections, float32."""
    cfg = get_cfg()
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
    cfg.MODEL.BACKBONE.NAME = "build_swintransformer_fpn_backbone"
    cfg.MODEL.SWIN.SIZE = swin_size
    return cfg


def flagship_cfg() -> ConfigNode:
    """``get_cfg()`` with what ``configs/DiverGen_swinL.yaml`` over
    ``configs/Base-C2_L_R5021k_640b64_4x.yaml`` sets for the model and the
    test path: Swin-L-22k-384 + FPN, CenterNet2 proposals, the three-stage
    Detic cascade over 1453 classes, the mask head, 896², bfloat16. Keys of
    the solver, the data loader and the copy-paste input are left at their
    defaults (merge the YAML file for those)."""
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
    scale_like = (nn.LayerNorm, nn.GroupNorm, FrozenBatchNorm, Scale)
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
    another one; without a card and without a request it raises.
    On a CUDA device the model computes in bfloat16 (``cfg.FP16``), the only
    dtype the window-attention kernels take; on the CPU in float32, as the
    JAX package's ``entry()``."""
    dev = entry_device(device)
    cfg = _small_cfg()
    cfg.FP16 = dev.type == "cuda"
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
