"""Cut a 1453-way classifier (1203 LVIS + 250 ImageNet, GDDE mode) back to
1203 + background, in a port checkpoint.

Counterpart of ``tools/convert_imgnet_model_to_lvis.py``: every entry under
a ``box_predictor*`` whose name holds ``cls_score`` has its class axis cut
to the first ``--output_num_category`` classes plus the trailing background
slot (or, at length ``--input_num_category``, to the first classes), in both
``model`` and ``ema_params``. A torch linear weight is (out, in), so the
class axis is dim 0 of the weight as of the bias (flax's Dense kernel has it
last). A zero-shot ``zs_weight`` (zs_dim, C) is not under ``cls_score`` and
is left as it is, as in the JAX tool. The optimizer state is dropped: its
moments of the cut entries no longer fit, so a resume starts a fresh one.

Usage:
  python -m divergen_tpu_torch.tools.convert_imgnet_model_to_lvis \\
      --input_dir OUT_1453 --output_dir OUT_1203 \\
      [--input_num_category 1453] [--output_num_category 1203]
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional

import torch


def truncate(state: Dict[str, torch.Tensor], n_in: int, n_out: int) -> Dict[str, torch.Tensor]:
    """``state`` with its ``box_predictor*`` ``cls_score`` entries cut along
    dim 0 from ``n_in`` (+ 1) classes to ``n_out`` (+ 1)."""
    out = {}
    for name, t in state.items():
        if "box_predictor" in name and "cls_score" in name and t.dim() >= 1:
            if t.shape[0] == n_in + 1:
                t = torch.cat([t[:n_out], t[-1:]])
            elif t.shape[0] == n_in:  # freq-style entries
                t = t[:n_out]
        out[name] = t
    return out


def main(argv: Optional[List[str]] = None) -> int:
    from ..engine.checkpoint import Checkpointer

    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--input_dir", required=True, help="checkpoint root (OUTPUT_DIR)")
    p.add_argument("--output_dir", required=True)
    p.add_argument("--input_num_category", type=int, default=1453)
    p.add_argument("--output_num_category", type=int, default=1203)
    args = p.parse_args(argv)

    src = Checkpointer(args.input_dir)
    step = src.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {args.input_dir}")
    raw = src.load(step)
    n_in, n_out = args.input_num_category, args.output_num_category
    raw["model"] = truncate(raw["model"], n_in, n_out)
    if raw.get("ema_params") is not None:
        raw["ema_params"] = truncate(raw["ema_params"], n_in, n_out)
    raw["optimizer"] = None
    dst = Checkpointer(args.output_dir)
    path = dst.path(step)
    torch.save(raw, path)
    print(f"truncated {n_in}->{n_out} @ step {step} -> {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
