"""Relative gaps between ``dryrun_train``'s step on the card and the same
step on the CPU, metric by metric, over several seeds of the weights and the
batch (``graft_entry.SEED``) and several runs of each seed on the card: the
readings behind ``chip_smoke.py``'s ``DRYRUN_BOUNDS``. Float32 on both sides,
TF32 off, as the smoke runs it. Needs a CUDA device.

    python3 tools/dryrun_loss_gaps.py [--seeds 0 1 2 3 4 5 6 7] [--repeats 2]

Prints one line per seed and run (the largest loss gap and its loss, the
``grad_norm`` gap), then the largest gap of every metric over all of them.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from divergen_tpu_torch import graft_entry  # noqa: E402


def step_metrics(device: str, seed: int) -> dict:
    """``dryrun_train(device)``'s metrics with ``graft_entry.SEED = seed``."""
    saved = graft_entry.SEED
    graft_entry.SEED = seed
    try:
        return graft_entry.dryrun_train(device=device)
    finally:
        graft_entry.SEED = saved


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(8)))
    ap.add_argument("--repeats", type=int, default=2, help="card runs of each seed")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dryrun_loss_gaps: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card_line = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True,
                               text=True).stdout.strip()
    worst = {}
    for seed in args.seeds:
        ref = step_metrics("cpu", seed)
        for run in range(args.repeats):
            got = step_metrics("cuda", seed)
            gaps = {k: abs(got[k] - want) / abs(want) if want else abs(got[k])
                    for k, want in ref.items()}
            for k, g in gaps.items():
                worst[k] = max(worst.get(k, 0.0), g)
            loss = max((k for k in gaps if k != "grad_norm"), key=gaps.get)
            print(f"seed {seed} run {run}: largest loss gap {gaps[loss]:.3e} ({loss}, CPU "
                  f"{ref[loss]:.8f}); grad_norm gap {gaps['grad_norm']:.3e}", flush=True)
    losses = {k: g for k, g in worst.items() if k != "grad_norm"}
    print(f"largest relative gap over {len(args.seeds)} seeds x {args.repeats} card runs "
          f"[{card_line}]:")
    for k in sorted(worst, key=worst.get, reverse=True):
        print(f"  {k}: {worst[k]:.3e}")
    print(f"every loss: {max(losses.values()):.3e}; grad_norm: {worst['grad_norm']:.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
