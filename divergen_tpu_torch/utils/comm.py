"""Communication between ranks: host helpers and the device reductions of a step.

Counterpart of ``divergen_tpu/utils/comm.py`` (detectron2 ``utils/comm.py``):
``get_world_size``, ``get_rank``, ``is_main_process``, ``synchronize``,
``all_gather`` of picklable objects, ``gather`` to ``dst``,
``shared_random_seed`` and ``reduce_dict``, over ``torch.distributed``. With no
process group initialized, or at world size 1, each is the no-op the JAX one
is.

The JAX step gets its reductions over chips from GSPMD: the batch is sharded
on the mesh's ``data`` axis, so every normalizer is the global batch's and
the gradients come out summed. One rank here is one card, so the port makes
them itself, with ``torch.distributed`` collectives called directly (no
``DistributedDataParallel``: its hooks fire only on ``.backward()``, and
BSGAL takes its gradients with ``torch.autograd.grad``):

- ``all_reduce_grads``: the mean over ranks of a list of gradients, in a few
  flat buckets;
- ``global_mean_count``: a count's mean over ranks (``jax.lax.pmean``);
  with ``floor`` the floor applies to the global count, so that a rank's
  ``local sum / global_mean_count(count, floor=1)``, averaged over the ranks
  as the gradients are, is the one-process ``global sum / max(global count,
  1)``;
- ``all_reduce_sum`` / ``all_reduce_max``: a sum over ranks, the union of a
  mask over ranks;
- ``all_gather_rows``: tensors of every rank, concatenated along dim 0 in
  rank order.

The host helpers speak of every process, as the JAX ones do, and take no
group. Every device helper takes the step's ``group``: None means one
process and makes no collective. Gloo moves CUDA tensors through the host
inside its own collectives; NCCL keeps them on the card. Nothing here copies
a tensor to the host under NCCL.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

# a bucket of flat gradients is at most this many bytes: a few all-reduces a
# step, each large enough to keep the link busy
BUCKET_BYTES = 256 << 20


def _initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def get_world_size() -> int:
    return dist.get_world_size() if _initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if _initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def world_group():
    """The default process group once one is initialized, else None."""
    return dist.group.WORLD if _initialized() else None


def synchronize() -> None:
    """A barrier over the ranks (comm.synchronize); a no-op at world size 1."""
    if get_world_size() == 1:
        return
    dist.barrier()


def all_gather(data: Any) -> List[Any]:
    """Picklable ``data`` of every rank, in rank order (comm.all_gather)."""
    world = get_world_size()
    if world == 1:
        return [data]
    out: List[Any] = [None] * world
    dist.all_gather_object(out, data)
    return out


def gather(data: Any, dst: int = 0) -> List[Any]:
    """comm.gather: every rank's ``data`` on ``dst``, an empty list elsewhere."""
    result = all_gather(data)
    return result if get_rank() == dst else []


def shared_random_seed() -> int:
    """One seed all ranks agree on: rank 0's draw (comm.shared_random_seed)."""
    seed = int(np.random.randint(2**31))
    return int(all_gather(seed)[0])


def reduce_dict(d: Dict[str, float], average: bool = True) -> Dict[str, float]:
    """The sum, or with ``average`` the mean, over ranks of a dict of scalars
    (comm.reduce_dict); every rank gets the result."""
    world = get_world_size()
    if world == 1:
        return dict(d)
    gathered = all_gather({k: float(v) for k, v in d.items()})
    return {k: float(np.sum([g[k] for g in gathered])) / (world if average else 1)
            for k in sorted(d)}


# -- device reductions of a step ---------------------------------------------------------------

def all_reduce_grads(grads: Sequence[Optional[torch.Tensor]], group,
                     like: Optional[Sequence[torch.Tensor]] = None) -> List[torch.Tensor]:
    """The mean over the ranks of ``group`` of each gradient, as new tensors
    in the order given. A None gradient (a leaf this rank's loss did not
    reach) takes zeros of ``like[i]``'s shape, so every rank reduces the same
    list in the same order. The gradients are copied into flat buckets of
    one dtype and at most ``BUCKET_BYTES``, one ``all_reduce`` (sum) each,
    divided by the world size. With ``group`` None they are returned as
    they are (the Nones as zeros)."""
    grads = [torch.zeros_like(like[i]) if g is None else g for i, g in enumerate(grads)]
    if group is None:
        return grads
    world = dist.get_world_size(group)
    out: List[Optional[torch.Tensor]] = [None] * len(grads)
    by_dtype: Dict[tuple, List[int]] = {}
    for i, g in enumerate(grads):
        by_dtype.setdefault((g.dtype, g.device), []).append(i)
    for idx in by_dtype.values():
        bucket: List[int] = []
        size = 0
        for i in idx + [None]:
            if i is not None:
                nbytes = grads[i].numel() * grads[i].element_size()
                if not bucket or size + nbytes <= BUCKET_BYTES:
                    bucket.append(i)
                    size += nbytes
                    continue
            flat = torch.cat([grads[j].reshape(-1) for j in bucket])
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
            flat.div_(world)
            for j, part in zip(bucket, flat.split([grads[j].numel() for j in bucket])):
                out[j] = part.view_as(grads[j])
            if i is not None:
                bucket, size = [i], nbytes
    return out  # type: ignore[return-value]


def global_mean_count(x: torch.Tensor, group, floor: Optional[float] = None) -> torch.Tensor:
    """``jax.lax.pmean`` of a count (float32 scalar): its sum over the ranks
    divided by their number. With ``floor``, ``max(sum, floor) / world``: a
    loss's local sum divided by this, averaged over the ranks (as
    ``all_reduce_grads`` averages its gradients), is the global sum divided
    by ``max(global count, floor)``, the one-process value on the global
    batch. With ``group`` None it is ``x`` (floored)."""
    total = all_reduce_sum(x.detach().float(), group)
    if floor is not None:
        total = total.clamp(min=floor)
    return total if group is None else total / dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise sum of ``x`` over the ranks, without gradient; ``x``
    itself with ``group`` None."""
    if group is None:
        return x
    total = x.detach().clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    return total


def all_reduce_max(mask: torch.Tensor, group) -> torch.Tensor:
    """The elementwise union (bool) or maximum (numbers) of ``mask`` over the
    ranks; ``mask`` itself with ``group`` None."""
    if group is None:
        return mask
    flat = mask.to(torch.int32) if mask.dtype == torch.bool else mask.clone()
    dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
    return flat.bool() if mask.dtype == torch.bool else flat


def all_gather_rows(x: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``x`` (equal shapes) concatenated along dim 0 in rank
    order, without gradient; ``x`` with ``group`` None."""
    if group is None:
        return x
    flat = x.to(torch.uint8) if x.dtype == torch.bool else x.contiguous()
    parts = [torch.empty_like(flat) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, flat, group=group)
    out = torch.cat(parts)
    return out.bool() if x.dtype == torch.bool else out


def all_gather_differentiable(x: torch.Tensor, group) -> torch.Tensor:
    """``all_gather_rows`` whose gradient flows back to each rank's own rows:
    ``torch.distributed.nn.functional.all_gather``, whose backward is a
    reduce-scatter (the transpose of ``jax.lax.all_gather``)."""
    if group is None:
        return x
    import warnings

    from torch.distributed.nn.functional import all_gather as ag

    with warnings.catch_warnings():  # newer releases point to a functional variant
        warnings.simplefilter("ignore", FutureWarning)
        return torch.cat(ag(x, group=group))


def broadcast_module_(module: torch.nn.Module, group, src: int = 0) -> None:
    """Every parameter and buffer of ``module`` set to rank ``src``'s
    (``shard_pytree`` of a replicated tree); nothing with ``group`` None."""
    if group is None:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src=src, group=group)


def broadcast_tensors_(tensors: Sequence[torch.Tensor], group, src: int = 0) -> None:
    """Each tensor set in place to rank ``src``'s; nothing with ``group`` None."""
    if group is None:
        return
    for t in tensors:
        dist.broadcast(t, src=src, group=group)
