"""Export a trained detector as a ``torch.export`` deployment artifact.

Counterpart of ``tools/export_model.py`` (which writes a StableHLO module):
the artifact is ``divergen_tpu_torch/export.py``'s, one program per device.
The weights come from the port's ``Checkpointer`` under ``--checkpoint-dir``
(default ``OUTPUT_DIR``), the EMA copy with ``--ema``; with no checkpoint the
tool says so and exports seeded random weights (a shape and trace check).

Usage:
  python -m divergen_tpu_torch.tools.export_model --config-file configs/... \\
      --output /tmp/model.pt2z [--height 896 --width 896] [--batch 1] \\
      [--bake-params] [--checkpoint-dir OUT_DIR] [--ema] \\
      [--platforms cuda cpu] [--run-sample] [--device cpu] [opts ...]

It runs on the card unless ``--device`` names another device
(``utils/dist.py:entry_device``).
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config-file", default="")
    p.add_argument("--output", required=True)
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--height", type=int, default=0,
                   help="input canvas height (default: cfg INPUT.TEST_SIZE)")
    p.add_argument("--width", type=int, default=0)
    p.add_argument("--checkpoint-dir", default="",
                   help="checkpoint root (default: cfg.OUTPUT_DIR); seeded random weights "
                        "when it holds none (a shape and trace check)")
    p.add_argument("--ema", action="store_true",
                   help="export the EMA weights (the eval default, do_test)")
    p.add_argument("--bake-params", action="store_true")
    p.add_argument("--platforms", nargs="*", default=None,
                   help="device types to export a program for (default: --device's)")
    p.add_argument("--run-sample", action="store_true",
                   help="load the artifact and run one zero-image batch through it")
    p.add_argument("--device", default=None,
                   help="device to build and export on (default: the card)")
    return p.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> Dict[str, torch.Tensor]:
    """Export; with ``--run-sample`` return the sample run's outputs."""
    from ..config import get_cfg
    from ..engine.checkpoint import Checkpointer
    from ..export import export_inference, load_exported, save_exported
    from ..graft_entry import fast_init_
    from ..modeling.meta_arch.rcnn import build_model
    from ..utils.dist import entry_device

    args = parse_args(argv)
    dev = entry_device(args.device)
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    size = int(cfg.INPUT.get("TEST_SIZE", 0) or cfg.INPUT.MIN_SIZE_TEST or 896)
    h, w = args.height or size, args.width or size

    model = build_model(cfg, input_size=(h, w), device=dev).eval()
    ckpt_dir = args.checkpoint_dir or cfg.OUTPUT_DIR
    ck = Checkpointer(ckpt_dir) if ckpt_dir else None
    if ck is not None and ck.latest_step() is not None:
        raw = ck.load()
        model.load_state_dict(raw["model"])
        if args.ema:
            if raw["ema_params"] is None:
                raise ValueError(f"--ema: the checkpoint under {ckpt_dir!r} has no EMA weights")
            params = dict(model.named_parameters())
            with torch.no_grad():
                for k, v in raw["ema_params"].items():
                    params[k].copy_(v)
        print(f"loaded step-{raw['step']} {'EMA ' if args.ema else ''}params from {ckpt_dir}")
    else:
        print(f"no checkpoint under {ckpt_dir!r}; exporting random init")
        fast_init_(model, torch.Generator().manual_seed(0))

    exp = export_inference(model, model.state_dict(), batch=args.batch, height=h, width=w,
                           platforms=args.platforms, bake_params=args.bake_params)
    path = save_exported(exp, args.output)
    loaded = load_exported(path)
    print(f"exported {path} platforms={loaded.platforms} inputs={len(loaded.in_avals)} "
          f"(images {tuple(loaded.in_avals[-2].shape)}, sizes {tuple(loaded.in_avals[-1].shape)})")
    if not args.run_sample:
        return {}
    imgs = torch.zeros((args.batch, h, w, 3), dtype=torch.float32, device=dev)
    sizes = torch.tensor([[h, w]] * args.batch, dtype=torch.int32, device=dev)
    out = loaded(imgs, sizes) if loaded.baked else loaded(model.state_dict(), imgs, sizes)
    bad = [k for k, v in out.items() if v.is_floating_point() and not torch.isfinite(v).all()]
    if bad:
        raise RuntimeError(f"sample run: non-finite values in {bad}")
    print("sample run OK:", {k: tuple(v.shape) for k, v in out.items()})
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
