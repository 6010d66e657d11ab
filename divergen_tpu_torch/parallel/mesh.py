"""The ranks as a ("data", "model") grid, and the data and parameter layout over it.

Counterpart of ``divergen_tpu/parallel/mesh.py``. The JAX package lays its
chips out as a 2-D ``Mesh`` and lets GSPMD shard the batch on ``data`` and
the large kernels on ``model``; here one rank is one card and the grid is a
plain array of ranks, ``arange(world).reshape(data, model)`` as JAX reshapes
its devices:

- a rank takes the contiguous rows of the global batch of its data index
  (``batch_slice``), so the model ranks of one data index see the same rows;
- the data group of a rank is its column (the ranks of its model index), over
  which the losses' normalizers and the gradients are reduced; the model
  group is its row (the ranks of its data index);
- ``param_sharding_rules`` is JAX's rule on each parameter's JAX-layout
  shape, and ``shard_pytree`` leaves each model rank its ``1 / model`` slice
  of every leaf the rule shards (``ModelShards``): the parameter the
  optimizer sees, so also its gradient, its AdamW moments and its EMA copy.
  The module reads the gathered full tensor during its forward. Every model
  rank runs the same forward on the same rows, so the gradient of its slice
  is its slice of the full gradient; nothing is summed over the model group.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..utils import comm
from ..utils.convert import jax_last_dim


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``ranks`` (data, model) of ``comm.get_world_size()`` ranks, axes named
    ``("data", "model")``. ``axis_groups``: this rank's (data group, model
    group) at a model axis above 1 under an initialized process group (None
    where an axis holds one rank)."""

    ranks: np.ndarray
    axis_groups: Optional[Tuple[Any, Any]] = dataclasses.field(default=None, compare=False)
    axis_names = ("data", "model")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.ranks.shape))

    def index(self, rank: Optional[int] = None) -> Tuple[int, int]:
        """(data index, model index) of ``rank`` (default: this process)."""
        rank = comm.get_rank() if rank is None else rank
        d, m = np.argwhere(self.ranks == rank)[0]
        return int(d), int(m)

    @property
    def group(self):
        """The process group of the data axis: at model 1 the default group
        once one is initialized (at world size 1 too), else None; above, this
        rank's column, None where it is one rank."""
        if self.shape["model"] == 1:
            return comm.world_group()
        return None if self.axis_groups is None else self.axis_groups[0]

    @property
    def model_group(self):
        """This rank's row of the grid: None at model 1 or without a group."""
        return None if self.axis_groups is None else self.axis_groups[1]


def _axis_groups(ranks: np.ndarray) -> Tuple[Any, Any]:
    """Every rank creates every group, columns then rows, in the same order."""
    import torch.distributed as dist

    me = comm.get_rank()
    data, model = ranks.shape
    mine: List[Any] = [None, None]
    for axis, lines in ((0, ranks.T), (1, ranks)):
        if lines.shape[1] == 1:
            continue
        for line in lines:
            g = dist.new_group([int(r) for r in line])
            if me in line:
                mine[axis] = g
    return mine[0], mine[1]


def create_mesh(data: int = -1, model: int = 1, world: Optional[int] = None) -> Mesh:
    """The grid of ``world`` ranks (default: the process group's size).
    ``data=-1`` takes every rank left over; ``data * model`` must be the
    world size. At a model axis above 1 under an initialized process group
    every rank calls it alike: it creates the groups of both axes."""
    n = comm.get_world_size() if world is None else world
    if data == -1:
        if n % model:
            raise ValueError(f"{n} ranks not divisible by model={model}")
        data = n // model
    if data * model != n:
        raise ValueError(f"mesh {data}x{model} != {n} ranks")
    ranks = np.arange(n).reshape(data, model)
    groups = None
    if model > 1 and comm._initialized() and n == comm.get_world_size():
        groups = _axis_groups(ranks)
    return Mesh(ranks, groups)


def batch_slice(mesh: Mesh, rank: int, batch: int) -> slice:
    """The rows of a global batch of ``batch`` that ``rank`` holds: its data
    index's contiguous share."""
    data = mesh.shape["data"]
    if batch % data:
        raise ValueError(f"a batch of {batch} does not split over {data} ranks")
    index = mesh.index(rank)[0]
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


def param_sharding_rules(params, mesh: Mesh, min_size: int = 2**18) -> Dict[str, Optional[int]]:
    """JAX's tensor-parallel rule: a leaf whose JAX-layout shape has at least
    two axes, at least ``min_size`` elements and a last axis divisible by the
    model size is sharded on that axis over ``model``; every other leaf is
    replicated. ``params``: a module (each parameter's JAX layout follows
    ``utils/convert.py``: a Dense or Conv ``weight`` holds the JAX last axis in
    dim 0) or a mapping of tensors already in the JAX layout. Returns, by
    name, the torch dim sharded over ``model``, or None."""
    size = mesh.shape["model"]
    if isinstance(params, nn.Module):
        named = dict(params.named_parameters())
        last = {k: jax_last_dim(params, k) for k in named}
    else:
        named = dict(params)
        last = {k: v.dim() - 1 for k, v in named.items()}
    out: Dict[str, Optional[int]] = {}
    for k, v in named.items():
        dim = last[k]
        out[k] = dim if (size > 1 and v.dim() >= 2 and v.numel() >= min_size
                         and v.shape[dim] % size == 0) else None
    return out


class _Gather(torch.autograd.Function):
    """The full tensors of the model group's slices; the gradient of a slice
    is its slice of the full gradient (every model rank computes the same
    forward on the same rows)."""

    @staticmethod
    def forward(ctx, shards: "ModelShards", dims: Tuple[int, ...], *slices):
        ctx.shards, ctx.dims = shards, dims
        return tuple(shards.gather(list(slices), list(dims)))

    @staticmethod
    def backward(ctx, *grads):
        return (None, None, *[None if g is None else ctx.shards.local(g, d)
                              for g, d in zip(grads, ctx.dims)])


class ModelShards:
    """The leaves of ``module`` that ``rules`` shards, held as this model
    rank's slices: each ``nn.Parameter`` is replaced by its slice, and a
    forward pre-hook on the module (and on each owner, for a forward that
    runs again outside the module's, as an activation checkpoint's does in
    the backward) sets the gathered full tensors as plain attributes, which a
    module's attribute reads find before its parameters; a forward hook
    removes them. The gathers of one call are one ``all_gather``."""

    def __init__(self, module: nn.Module, rules: Mapping[str, Optional[int]], mesh: Mesh):
        self.group, self.size = mesh.model_group, mesh.shape["model"]
        self.row, self.rank = mesh.index()  # (data index, model index) of this rank
        self.dims = {k: d for k, d in rules.items() if d is not None}
        self._owners: Dict[str, Tuple[nn.Module, str]] = {}
        by_owner: Dict[int, List[str]] = {}
        with torch.no_grad():
            for name, dim in self.dims.items():
                prefix, _, leaf = name.rpartition(".")
                owner = module.get_submodule(prefix)
                full = owner._parameters[leaf]
                owner._parameters[leaf] = nn.Parameter(self.local(full.detach(), dim),
                                                       requires_grad=full.requires_grad)
                self._owners[name] = (owner, leaf)
                by_owner.setdefault(id(owner), []).append(name)
        self._installed: Dict[str, int] = {}  # name → id of the module whose hook set it
        self.module = module
        hooked = [(module, list(self.dims))] + [
            (self._owners[names[0]][0], names) for names in by_owner.values()
            if self._owners[names[0]][0] is not module]
        for m, names in hooked:
            m.register_forward_pre_hook(lambda m, a, names=names: self._install(names, id(m)))
            m.register_forward_hook(lambda m, a, o, names=names: self._remove(names, id(m)),
                                    always_call=True)

    # -- slices and full tensors ---------------------------------------------------------------

    def local(self, full: torch.Tensor, dim: int) -> torch.Tensor:
        """This model rank's slice of ``full`` along ``dim``, contiguous."""
        n = full.shape[dim] // self.size
        return full.narrow(dim, self.rank * n, n).contiguous()

    def gather(self, slices: List[torch.Tensor], dims: List[int]) -> List[torch.Tensor]:
        """The full tensors of the model group's ``slices``, without
        gradient: one ``all_gather`` of the concatenation of each dtype's."""
        import torch.distributed as dist

        out: List[Optional[torch.Tensor]] = [None] * len(slices)
        by_dtype: Dict[torch.dtype, List[int]] = {}
        for i, s in enumerate(slices):
            by_dtype.setdefault(s.dtype, []).append(i)
        for idx in by_dtype.values():
            flat = torch.cat([slices[i].detach().reshape(-1) for i in idx])
            parts = [torch.empty_like(flat) for _ in range(self.size)]
            dist.all_gather(parts, flat, group=self.group)
            per_rank = [p.split([slices[i].numel() for i in idx]) for p in parts]
            for j, i in enumerate(idx):
                out[i] = torch.cat([pr[j].view_as(slices[i]) for pr in per_rank], dim=dims[i])
        return out  # type: ignore[return-value]

    def global_sum(self, values: torch.Tensor, sliced: Sequence[bool]) -> torch.Tensor:
        """Sums over the last dim of ``values``, which holds one term per
        leaf (``sliced``: whether the leaf is held as this rank's slice), as
        over the full tensors: the replicated leaves' terms once, the slices'
        summed over the model group (a collective)."""
        mask = torch.tensor(list(sliced), dtype=torch.bool, device=values.device)
        return values[..., ~mask].sum(-1) + comm.all_reduce_sum(values[..., mask].sum(-1),
                                                                 self.group)

    def full_tree(self, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tree`` (by parameter name) with every sharded leaf gathered."""
        names = [k for k in tree if k in self.dims]
        full = dict(zip(names, self.gather([tree[k] for k in names],
                                           [self.dims[k] for k in names])))
        return {k: full.get(k, v) for k, v in tree.items()}

    def local_tree(self, tree: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``tree`` (full tensors by parameter name) with every sharded leaf
        cut to this rank's slice."""
        return {k: self.local(v, self.dims[k]) if k in self.dims else v for k, v in tree.items()}

    def full_optimizer_state(self, optim: torch.optim.Optimizer) -> Dict[str, Any]:
        """``optim.state_dict()`` with the moments of the sliced parameters
        gathered: the layout of an unsliced model (a collective)."""
        sd = optim.state_dict()  # its per-parameter dicts are the optimizer's own
        sd = dict(sd, state={i: dict(st) for i, st in sd["state"].items()})
        slots = self._moment_slots(optim, sd["state"])
        full = self.gather([sd["state"][i][k] for i, k, _ in slots], [d for _, _, d in slots])
        for (i, k, _), t in zip(slots, full):
            sd["state"][i][k] = t
        return sd

    def local_optimizer_state(self, optim: torch.optim.Optimizer,
                              sd: Dict[str, Any]) -> Dict[str, Any]:
        """A full ``state_dict`` of ``optim`` (an unsliced model's) with the
        moments of the sliced parameters cut to this rank's slices."""
        state = {i: dict(st) for i, st in sd["state"].items()}
        for i, k, d in self._moment_slots(optim, state):
            state[i][k] = self.local(state[i][k], d)
        return dict(sd, state=state)

    def _moment_slots(self, optim, state) -> List[Tuple[Any, str, int]]:
        """(state index, key, dim) of every moment of a sliced parameter."""
        names = {id(p): n for n, p in self.module.named_parameters()}
        params = [p for g in optim.param_groups for p in g["params"]]
        slots = []
        for i, st in sorted(state.items()):
            name = names.get(id(params[int(i)]))
            if name in self.dims:
                slots += [(i, k, self.dims[name]) for k, v in sorted(st.items())
                          if isinstance(v, torch.Tensor) and v.dim() > 0]
        return slots

    @property
    def device(self) -> torch.device:
        """Where the slices live (the device of the model group's collectives)."""
        owner, leaf = next(iter(self._owners.values()))
        return owner._parameters[leaf].device

    def held(self) -> set:
        """The ids of the sliced parameters."""
        return {id(owner._parameters[leaf]) for owner, leaf in self._owners.values()}

    def state_dict(self) -> Dict[str, torch.Tensor]:
        """The module's ``state_dict`` with the full tensors (a collective)."""
        return self.full_tree(self.module.state_dict())

    # -- the forward's view ------------------------------------------------------------------------

    def _install(self, names: List[str], by: int) -> None:
        todo = [k for k in names if k not in self._installed]
        if not todo:
            return
        slices = [self._owners[k][0]._parameters[self._owners[k][1]] for k in todo]
        fulls = _Gather.apply(self, tuple(self.dims[k] for k in todo), *slices)
        for k, full in zip(todo, fulls):
            owner, leaf = self._owners[k]
            owner.__dict__[leaf] = full
            self._installed[k] = by

    def _remove(self, names: List[str], by: int) -> None:
        for k in names:
            if self._installed.get(k) == by:
                del self._installed[k]
                owner, leaf = self._owners[k]
                owner.__dict__.pop(leaf, None)


def shard_pytree(tree, mesh: Mesh, src: int = 0, rules: Optional[Mapping[str, Optional[int]]] = None):
    """Make every tensor of ``tree`` (a module, or nested dicts of tensors)
    equal on every rank: a broadcast from rank ``src``, in place. With
    ``rules`` (``param_sharding_rules``) at a model axis above 1, a module's
    sharded parameters are then cut to this rank's slices (``ModelShards``,
    kept as ``tree.model_shards``). Returns ``tree``."""
    group = comm.world_group()
    if isinstance(tree, torch.nn.Module):
        comm.broadcast_module_(tree, group, src)
        if (rules is not None and mesh.model_group is not None
                and any(d is not None for d in rules.values())):
            tree.model_shards = ModelShards(tree, rules, mesh)
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


def model_shards(module: nn.Module) -> Optional[ModelShards]:
    """The ``ModelShards`` of a module that ``shard_pytree`` cut, else None."""
    return getattr(module, "model_shards", None)
