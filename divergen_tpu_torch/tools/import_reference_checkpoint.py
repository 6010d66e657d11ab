"""Convert a reference detector checkpoint (``.pth`` / ``.pkl``) into a
port checkpoint that ``train_net --eval-only`` and ``--resume`` read.

Counterpart of ``tools/import_reference_checkpoint.py``: the model is built
from the config on the CPU (no card is needed for a conversion), filled by
``utils/torch_weights.py:load_d2_detector_into``, and written by the port's
``Checkpointer`` as a full ``TrainState``: the model, a fresh optimizer from
``solver/build.py``, the EMA slot with ``--ema`` or ``MODEL.MODEL_EMA > 0``,
at step ``--step``. A Swin backbone's block counts come from
``MODEL.SWIN.SIZE`` (every published detector is Swin-L, whose counts the
JAX tool assumes).

Usage:
  python -m divergen_tpu_torch.tools.import_reference_checkpoint \\
      --config-file configs/DiverGen_swinL.yaml \\
      --checkpoint models/divergen_swinL_1200k_gdde.pth \\
      --output output/divergen_swinL [--step 0] [--ema] [opts ...]

Writes ``OUTPUT/checkpoints/step_<step>.pt``.
"""
from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, List, Optional

import torch


def main(argv: Optional[List[str]] = None) -> Dict[str, Any]:
    """Convert. Returns the checkpoint file written (``path``), the model's
    ``state_dict`` names (``entries``), those the reference checkpoint
    filled (``loaded``) and its entries that did not fit (``skipped``)."""
    from ..config import get_cfg
    from ..engine.checkpoint import Checkpointer
    from ..engine.train_loop import create_train_state
    from ..modeling.backbone.swin import SIZE2CONFIG
    from ..modeling.meta_arch.rcnn import build_model
    from ..solver.build import build_optimizer
    from ..utils.torch_weights import load_d2_detector_into

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--config-file", required=True)
    ap.add_argument("--checkpoint", required=True)
    ap.add_argument("--output", default=None, help="default: cfg.OUTPUT_DIR")
    ap.add_argument("--step", type=int, default=0)
    ap.add_argument("--ema", action="store_true",
                    help="also seed the EMA slot with the loaded weights")
    ap.add_argument("opts", nargs="*")
    args = ap.parse_args(argv)

    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    # as do_train builds it: float32 parameters, the training canvas
    model = build_model(cfg, input_size=(cfg.INPUT.TRAIN_SIZE,) * 2, device="cpu",
                        param_dtype=torch.float32)
    kw = {"fpn_in_features": model.fpn_in_features}
    if model.backbone_name == "swin":  # the JAX tool takes the default, Swin-S/B/L's depths
        kw["swin_depths"] = SIZE2CONFIG[cfg.MODEL.SWIN.SIZE][1]
    loaded, skipped = load_d2_detector_into(model, args.checkpoint, cfg, **kw)
    state = create_train_state(model, build_optimizer(cfg, model),
                               ema=args.ema or cfg.MODEL.MODEL_EMA > 0)
    state.step = args.step
    out_dir = args.output or cfg.OUTPUT_DIR
    ckpt = Checkpointer(out_dir)
    ckpt.save(args.step, state, force=True)
    n_params = sum(p.numel() for p in model.parameters())
    entries = sorted(model.state_dict())
    print(f"imported {args.checkpoint} -> {ckpt.path(args.step)} ({n_params / 1e6:.1f}M params; "
          f"{len(loaded)} of {len(entries)} entries filled, {len(skipped)} skipped)")
    return {"path": ckpt.path(args.step), "entries": entries, "loaded": loaded,
            "skipped": skipped}


if __name__ == "__main__":
    main(sys.argv[1:])
