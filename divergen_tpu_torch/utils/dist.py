"""Rank, world size and device of an entry point, and the process group.

``init_distributed`` starts ``torch.distributed`` from the environment
``torchrun`` sets (the counterpart of ``jax.distributed.initialize()`` in the
JAX ``train_net --multi-host``); ``layout`` says which rows of the data a
rank takes. One rank is one card.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Optional, Tuple

import torch

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


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


def init_distributed(backend: Optional[str] = None, device=None) -> torch.device:
    """Join the process group ``torchrun`` describes (``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``GROUP_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) and return this rank's device: ``cuda:LOCAL_RANK``
    (made current) unless the caller names another (``device="cpu"``). The
    backend is ``backend`` if given, else NCCL on the card and gloo on the
    CPU. A backend that cannot start raises; NCCL is never replaced by gloo
    unless the caller names gloo. Without the torchrun environment it
    raises."""
    import torch.distributed as dist

    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        raise RuntimeError(f"init_distributed reads the environment torchrun sets; {missing} "
                           "are not set: launch with torchrun --nproc_per_node=N -m "
                           "divergen_tpu_torch.train_net --multi-host ...")
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = entry_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    if not dist.is_initialized():
        # naming the device makes NCCL start its communicator now, so a fault shows here
        extra = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, init_method="env://", rank=rank, world_size=world,
                                **extra)
    return dev


@dataclasses.dataclass(frozen=True)
class Layout:
    """Where this process sits: its global ``rank`` of ``world``, its
    ``local_rank`` of the ``local_world`` ranks of its node, and the node's
    index ``node`` of ``nodes``."""

    rank: int = 0
    world: int = 1
    local_rank: int = 0
    local_world: int = 1
    node: int = 0
    nodes: int = 1


def layout() -> Layout:
    """This process's ``Layout``: from the initialized process group (the
    local and node indices from torchrun's ``LOCAL_RANK``,
    ``LOCAL_WORLD_SIZE`` and ``GROUP_RANK``, else one node), or one process.
    ``WORLD_SIZE`` above 1 without an initialized group raises: each process
    would train alone on its own stride of the data."""
    from . import comm

    if not comm._initialized():
        env_world = int(os.environ.get("WORLD_SIZE", 1))
        if env_world > 1:
            raise RuntimeError(
                f"WORLD_SIZE={env_world} in the environment, but no process group is "
                "initialized: each process would train alone. Launch with torchrun ... "
                "-m divergen_tpu_torch.train_net --multi-host, or call init_distributed()")
        return Layout()
    rank, world = comm.get_rank(), comm.get_world_size()
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % local_world:
        raise ValueError(f"WORLD_SIZE {world} is not a multiple of LOCAL_WORLD_SIZE {local_world}")
    return Layout(rank, world, int(os.environ.get("LOCAL_RANK", rank % local_world)),
                  local_world, int(os.environ.get("GROUP_RANK", rank // local_world)),
                  world // local_world)
