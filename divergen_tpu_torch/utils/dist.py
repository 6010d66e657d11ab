"""Rank, world size and device of an entry point."""
from __future__ import annotations

import os
from typing import Tuple

import torch


def rank_world(dist: bool = False) -> Tuple[int, int]:
    """(rank, world size): from an initialized ``torch.distributed`` with
    ``dist``, else from ``RANK`` / ``WORLD_SIZE`` (default 0 of 1)."""
    if dist:
        import torch.distributed as td

        return td.get_rank(), td.get_world_size()
    return int(os.environ.get("RANK", 0)), int(os.environ.get("WORLD_SIZE", 1))


def entry_device(requested=None) -> torch.device:
    """The device an entry point runs on: ``requested`` when the caller names
    one (``--device cpu``, ``device="cpu"``), else the card. Without a visible
    card and without a request it raises: nothing falls back to the CPU."""
    if requested:
        return torch.device(requested)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible; pass --device cpu (device='cpu') "
                           "to run on the CPU")
    return torch.device("cuda")
