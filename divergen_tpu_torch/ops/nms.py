"""Fixed-size NMS as a keep mask, without torchvision.

Counterpart of ``divergen_tpu/ops/nms.py``: inputs are padded ``(N,)`` score
and ``(N, 4)`` box tensors with a validity mask, and the result is an ``(N,)``
boolean keep mask in input order, so that a top-k afterwards keeps its
static shape and tensors compare one for one with the JAX package's.

Algorithm: exact greedy NMS. Boxes are sorted by score, their (N, N) overlap
matrix is taken once, and they are processed in tiles of 256. Inside a tile
the greedy recurrence ``keep[i] = alive[i] & !any_{j<i} (keep[j] & iou[j, i]
> t)`` is iterated to its fixpoint, which is unique by induction on the
triangular order and therefore exactly the greedy result;
across tiles, the kept boxes of a tile suppress all later tiles in one
matrix operation. Eagerly, the fixpoint loop asks the host whether the mask
still changed, which synchronizes the stream once per iteration (suppression
chains are rarely deeper than a few boxes): ``nms_mask.host_syncs`` counts
those reads. Under a tracer (``torch.export``, ``torch.compile``) the same
iteration is a ``torch._higher_order_ops.while_loop``, the JAX package's
``lax.while_loop``: the graph holds the loop and no read, and gives the same
keep mask.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch._higher_order_ops import while_loop

from ..structures import boxes as box_ops
from .tracing import tracing

_TILE = 256


def nms_mask(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
             valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Exact greedy NMS. Returns a bool keep mask aligned with input order.
    Invalid rows are never kept and never suppress others."""
    return greedy_nms(boxes, scores, iou_threshold, valid, box_ops.pairwise_iou)


def greedy_nms(boxes: torch.Tensor, scores: torch.Tensor, iou_threshold: float,
               valid: Optional[torch.Tensor], pairwise_iou) -> torch.Tensor:
    """``nms_mask`` over the overlaps ``pairwise_iou(boxes, boxes)`` of any
    box format (``ops/rotated.py:nms_rotated`` passes the rotated IoU); its
    eager fixpoint reads are counted in ``nms_mask.host_syncs`` too, and it
    traces as ``nms_mask`` does."""
    n = boxes.shape[0]
    if n == 0:
        return torch.zeros((0,), dtype=torch.bool, device=boxes.device)
    if valid is None:
        valid = torch.ones((n,), dtype=torch.bool, device=boxes.device)
    tile = min(_TILE, n)
    # sort by score descending (ties in input order); invalid rows sink to the end
    key = torch.where(valid, -scores, torch.full_like(scores, float("inf")))
    order = torch.argsort(key, stable=True)
    sboxes = boxes[order]
    alive = valid[order].clone()
    kept = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    # one (n, n) overlap matrix in score order; [j, i] with j above i counts
    over_all = pairwise_iou(sboxes, sboxes) > iou_threshold
    idx = torch.arange(tile, device=boxes.device)
    tri = idx[:, None] < idx[None, :]  # [j, i]: j strictly above i in score order

    for start in range(0, n, tile):
        stop = min(start + tile, n)
        ta = alive[start:stop]
        m = stop - start
        over = over_all[start:stop, start:stop] & tri[:m, :m]
        fixpoint = _traced_fixpoint if tracing() else _eager_fixpoint
        k = fixpoint(ta, over)
        kept[start:stop] = k
        if stop < n:
            alive[stop:] &= ~(over_all[start:stop, stop:] & k[:, None]).any(dim=0)

    keep = torch.zeros((n,), dtype=torch.bool, device=boxes.device)
    keep[order] = kept
    return keep


nms_mask.host_syncs = 0


def _suppress(ta: torch.Tensor, over: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """One step of the tile's recurrence: the alive boxes that no box of
    ``k`` above them overlaps."""
    return ta & ~(over & k[:, None]).any(dim=0)


def _eager_fixpoint(ta: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    """The tile's fixpoint from ``ta``, asking the host after each step
    whether the mask changed."""
    k = ta
    while True:
        k_new = _suppress(ta, over, k)
        nms_mask.host_syncs += 1
        if torch.equal(k_new, k):
            return k
        k = k_new


def _traced_fixpoint(ta: torch.Tensor, over: torch.Tensor) -> torch.Tensor:
    """The tile's fixpoint as a ``while_loop`` carrying (mask, changed), as
    ``divergen_tpu/ops/nms.py`` iterates it: no host read in the graph."""
    def cond(k, changed):
        return changed.clone()  # a loop's predicate may not alias its carry

    def body(k, changed):
        k_new = _suppress(ta, over, k)
        return k_new, (k_new != k).any()

    k0 = _suppress(ta, over, ta)
    return while_loop(cond, body, (k0, (k0 != ta).any()))[0]


def batched_nms_mask(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor,
                     iou_threshold: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Class-aware NMS by the coordinate-offset trick: boxes of different
    classes are moved to disjoint regions, then plain NMS runs once. The
    offset comes from the largest coordinate of the valid boxes only."""
    if boxes.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.bool, device=boxes.device)
    extent = boxes.max(dim=-1).values
    if valid is not None:
        extent = torch.where(valid, extent, torch.zeros_like(extent))
    max_coord = extent.max() + 1.0
    shifted = boxes + (classes.to(boxes.dtype) * max_coord)[:, None]
    return nms_mask(shifted, scores, iou_threshold, valid)


def top_scoring(boxes: torch.Tensor, scores: torch.Tensor, keep: torch.Tensor, k: int,
                extras: Sequence[torch.Tensor] = ()) -> Tuple:
    """The top-k kept rows as padded tensors plus validity:
    ``(boxes (k, 4), scores (k,), valid (k,), indices (k,), extras)``. With
    fewer than k candidates the candidate set is padded, so the output keeps
    its static shape. Ties go to the lower index; the order among rows that
    are not kept (score -inf, ``valid`` False) is unspecified."""
    masked = torch.where(keep, scores, torch.full_like(scores, float("-inf")))
    n = masked.shape[-1]
    if n < k:
        pad = k - n
        masked = F.pad(masked, (0, pad), value=float("-inf"))
        boxes = F.pad(boxes, (0, 0, 0, pad))
        extras = tuple(F.pad(e, (0, 0) * (e.dim() - 1) + (0, pad)) for e in extras)
    topv, topi = stable_topk(masked, k)
    valid = topv > float("-inf")
    out_scores = torch.where(valid, topv, torch.zeros_like(topv))
    return boxes[topi], out_scores, valid, topi, tuple(e[topi] for e in extras)


def stable_topk(values: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest of a 1-D tensor in descending order, ties to the lower
    index (what ``jax.lax.top_k`` gives; ``torch.topk`` leaves ties open)."""
    order = torch.argsort(values, descending=True, stable=True)[:k]
    return values[order], order
