"""The ranks as a ("data", "model") grid, and the data layout over it.

Counterpart of ``divergen_tpu/parallel/mesh.py``. The JAX package lays its
chips out as a 2-D ``Mesh`` and lets GSPMD shard the batch on ``data``; here
one rank is one card, the grid is a plain array of ranks, a rank takes its
contiguous rows of the global batch (``batch_slice``), parameters are
replicated, and ``shard_pytree`` makes them equal on every rank by a
broadcast from rank 0. The tensor-parallel ``model`` axis above 1 is not
ported (ROADMAP.md §1, item 4: ``MODEL_PARALLEL > 1``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..utils import comm

MODEL_PARALLEL_ITEM = ("MODEL_PARALLEL > 1 (the tensor-parallel layout of the model axis) is "
                       "not ported: ROADMAP.md §1, item 4")


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``ranks`` (data, model) of ``comm.get_world_size()`` ranks, axes named
    ``("data", "model")``."""

    ranks: np.ndarray
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    @property
    def group(self):
        """The process group of the data axis: the default group once one is
        initialized (at world size 1 too), else None. A model axis above 1
        raises."""
        if self.shape["model"] > 1:
            raise NotImplementedError(MODEL_PARALLEL_ITEM)
        if not comm._initialized():
            return None
        import torch.distributed as dist

        return dist.group.WORLD


def create_mesh(data: int = -1, model: int = 1, world: Optional[int] = None) -> Mesh:
    """The grid of ``world`` ranks (default: the process group's size).
    ``data=-1`` takes every rank left over; ``data * model`` must be the
    world size."""
    n = comm.get_world_size() if world is None else world
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    return Mesh(np.arange(n).reshape(data, model))


def batch_slice(mesh: Mesh, rank: int, batch: int) -> slice:
    """The rows of a global batch of ``batch`` that ``rank`` holds: its data
    index's contiguous share."""
    data = mesh.shape["data"]
    if batch % data:
        raise ValueError(f"a batch of {batch} does not split over {data} ranks")
    index = int(np.argwhere(mesh.ranks == rank)[0, 0])
    per = batch // data
    return slice(index * per, (index + 1) * per)


def batch_sharding(mesh: Mesh, rank: Optional[int] = None) -> Callable[[Any], Any]:
    """A function taking a batch (nested dicts of arrays or tensors with the
    batch leading) to ``rank``'s rows of it (default: this process's rank)."""
    rank = comm.get_rank() if rank is None else rank

    def shard(tree):
        if isinstance(tree, dict):
            return {k: shard(v) for k, v in tree.items()}
        return tree[batch_slice(mesh, rank, tree.shape[0])]

    return shard


def replicated(mesh: Mesh) -> Callable[[Any], Any]:
    """Every rank holds the whole tree: the identity."""
    return lambda tree: tree


def param_sharding_rules(params, mesh: Mesh):
    """Every parameter replicated (data parallelism); a model axis above 1
    raises."""
    if mesh.shape["model"] > 1:
        raise NotImplementedError(MODEL_PARALLEL_ITEM)
    return {name: replicated(mesh) for name in dict(params)}


def shard_pytree(tree, mesh: Mesh, src: int = 0):
    """Make every tensor of ``tree`` (a module, or nested dicts of tensors)
    equal on every rank: a broadcast from rank ``src``, in place. Returns
    ``tree``."""
    group = mesh.group
    if isinstance(tree, torch.nn.Module):
        comm.broadcast_module_(tree, group, src)
        return tree
    leaves = []

    def collect(t):
        if isinstance(t, dict):
            for v in t.values():
                collect(v)
        elif isinstance(t, torch.Tensor):
            leaves.append(t)

    collect(tree)
    comm.broadcast_tensors_(leaves, group, src)
    return tree
