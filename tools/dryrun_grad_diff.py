"""Per-parameter gradients of ``dryrun_train``'s step on the card against the
CPU step's: the same weights, batch and draws, float32 on both sides.

``graft_entry.dryrun_train`` reports one global ``grad_norm``; this prints,
for each parameter, the relative L2 distance of the card's gradient (before
the step's clipping) from the CPU's, the worst ``--top`` of them, and the
sum of squared differences by module prefix, to show where the two steps'
gradients part. Needs a CUDA device.

    python3 tools/dryrun_grad_diff.py [--top 15] [--depth 3]
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from divergen_tpu_torch import graft_entry  # noqa: E402
from divergen_tpu_torch.engine import train_loop  # noqa: E402


def step_grads(device: str) -> dict:
    """``dryrun_train(device)``'s gradients before clipping, by parameter
    name, copied to the CPU."""
    grads = {}
    apply = train_loop.apply_losses

    def recording(state, losses, ema_decay, loss_weights=None):
        step = state.optimizer.step

        def recording_step(*a, **kw):  # before the step clips the gradients
            grads.update({n: p.grad.detach().cpu().clone()
                          for n, p in state.model.named_parameters() if p.grad is not None})
            return step(*a, **kw)

        state.optimizer.step = recording_step
        try:
            return apply(state, losses, ema_decay, loss_weights)
        finally:
            state.optimizer.step = step

    train_loop.apply_losses = recording
    try:
        graft_entry.dryrun_train(device=device)
    finally:
        train_loop.apply_losses = apply
    return grads


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--depth", type=int, default=3, help="name parts of a module prefix")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dryrun_grad_diff: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card, cpu = step_grads("cuda"), step_grads("cpu")
    if card.keys() != cpu.keys():
        print(f"parameters with a gradient differ: {sorted(card.keys() ^ cpu.keys())}")
        return 1
    rows, by_prefix = [], collections.Counter()
    total_sq = sum(float(g.double().pow(2).sum()) for g in cpu.values())
    for name in cpu:
        diff = float((card[name].double() - cpu[name].double()).pow(2).sum())
        ref = float(cpu[name].double().pow(2).sum())
        rows.append(((diff / ref) ** 0.5 if ref else float("inf") if diff else 0.0, diff, name))
        by_prefix[".".join(name.split(".")[:args.depth])] += diff
    card_sq = sum(float(g.double().pow(2).sum()) for g in card.values())
    print(f"{len(rows)} parameters; gradient norm card {card_sq ** 0.5:.6f}, CPU "
          f"{total_sq ** 0.5:.6f}; |card - CPU| {sum(r[1] for r in rows) ** 0.5:.6g}")
    print(f"worst {args.top} by relative L2 (relative L2, share of the squared difference):")
    all_diff = sum(r[1] for r in rows) or 1.0
    for rel, diff, name in sorted(rows, reverse=True)[:args.top]:
        print(f"  {name}: {rel:.3e}, {diff / all_diff:.3f}")
    print("squared difference by module prefix (share):")
    for prefix, diff in by_prefix.most_common(args.top):
        print(f"  {prefix}: {diff / all_diff:.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
