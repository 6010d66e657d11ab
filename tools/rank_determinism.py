"""Whether the BSGAL run of ``chip_smoke.py`` slice 15 (a) is bit reproducible.

(a) holds ``train_net --multi-host`` at NCCL world size 1 against the same
BSGAL run without a process group, bit for bit, on PyTorch's default
kernels. This script runs that pair and a second run without a group, and
prints for the group against no group, and for no group against itself,
the first step whose parameter checksum differs ("none": every step and the
final SHA-256 equal).

    python3 tools/rank_determinism.py

On one H100, about 3 minutes: three full-width runs of ``RANK_STEPS`` steps at
B = 2, each a fresh process.
"""
from __future__ import annotations

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def first_gap(x: dict, y: dict) -> str:
    """The first step whose checksum differs, and by how much, or 'none'."""
    for step, (u, v) in enumerate(zip(x["sums"], y["sums"])):
        if u != v:
            return f"step {step} ({u!r} / {v!r}, gap {abs(u - v):.3g})"
    return "none" if x["sha256"] == y["sha256"] else "only in the final SHA-256"


def main() -> int:
    import torch

    from divergen_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("rank_determinism: no CUDA device", file=sys.stderr)
        return 1
    card = cs.card_line()
    _build.build()
    with tempfile.TemporaryDirectory() as tmp:
        files = cs.ranks_training_root(tmp)
        files["root"] = os.path.join(tmp, "ranks_data")
        runs = {}
        for name, nproc, extra in (("nccl_world_1", 1, ["--multi-host"]), ("no_group", 0, []),
                                   ("no_group_again", 0, [])):
            runs[name] = cs.rank_command(
                {"name": name, "kind": "train_net", "root": files["root"],
                 "args": cs.train_net_args(files, os.path.join(tmp, name), False, *extra)},
                tmp, nproc)["ranks"][0]
        print(f"NCCL world 1 against no group: first gap "
              f"{first_gap(runs['nccl_world_1'], runs['no_group'])}; no group against itself: "
              f"first gap {first_gap(runs['no_group'], runs['no_group_again'])} [{card}]")
    return 0


if __name__ == "__main__":
    sys.exit(main())
