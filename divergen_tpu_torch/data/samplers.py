"""Index samplers (host-side, rank-sharded infinite streams).

A copy of ``divergen_tpu/data/samplers.py`` (numpy only): for a seed, rank
and world size every stream equals the JAX package's. Its sources:
detectron2 ``data/samplers/distributed_sampler.py`` (``TrainingSampler``,
``RepeatFactorTrainingSampler``, ``InferenceSampler``), the reference's
``MultiDatasetSampler`` (``DiverGen/divergen/data/custom_dataset_dataloader.py:368-438``
— per-dataset ratio × RFS weights, infinite multinomial stream sharded by
rank) and ``repeat_factors_from_tag_frequency`` (:481-503). The rank and
world size are the caller's (``utils/dist.py:rank_world``); the generators
yield plain ints.
"""
from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, Iterator, Optional, Sequence

import numpy as np


class TrainingSampler:
    """Infinite shuffled index stream, deterministic per seed, sharded."""

    def __init__(self, size: int, shuffle: bool = True, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self._size = size
        self._shuffle = shuffle
        self._seed = seed
        self._rank = rank
        self._world = world_size

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self._seed)
        while True:
            order = g.permutation(self._size) if self._shuffle else np.arange(self._size)
            yield from order[self._rank :: self._world].tolist()


def repeat_factors_from_category_frequency(
    dataset_dicts: Sequence[dict], repeat_thresh: float
) -> np.ndarray:
    """RFS v0: rf(img) = max over its cats of max(1, sqrt(t / f(cat)))."""
    counts: Dict[int, int] = defaultdict(int)
    for rec in dataset_dicts:
        for cid in {ann["category_id"] for ann in rec["annotations"]}:
            counts[cid] += 1
    n = len(dataset_dicts)
    cat_rep = {
        cid: max(1.0, math.sqrt(repeat_thresh / (c / n))) for cid, c in counts.items()
    }
    rfs = []
    for rec in dataset_dicts:
        cids = {ann["category_id"] for ann in rec["annotations"]}
        rfs.append(max((cat_rep[c] for c in cids), default=1.0))
    return np.asarray(rfs, np.float64)


def repeat_factors_from_tag_frequency(
    dataset_dicts: Sequence[dict], repeat_thresh: float, tag_key: str = "pos_category_ids"
) -> np.ndarray:
    """RFS from image-level tags (custom_dataset_dataloader.py:481-503)."""
    counts: Dict[int, int] = defaultdict(int)
    for rec in dataset_dicts:
        for cid in rec.get(tag_key, []):
            counts[cid] += 1
    n = len(dataset_dicts)
    cat_rep = {
        cid: max(1.0, math.sqrt(repeat_thresh / (c / n))) for cid, c in counts.items()
    }
    rfs = []
    for rec in dataset_dicts:
        rfs.append(max((cat_rep[c] for c in rec.get(tag_key, [])), default=1.0))
    return np.asarray(rfs, np.float64)


class RepeatFactorTrainingSampler:
    """Per-epoch stochastic rounding of repeat factors, then shuffle."""

    def __init__(self, repeat_factors: np.ndarray, seed: int = 0,
                 rank: int = 0, world_size: int = 1):
        self._int_part = np.floor(repeat_factors).astype(np.int64)
        self._frac_part = repeat_factors - self._int_part
        self._seed = seed
        self._rank = rank
        self._world = world_size

    def _epoch_indices(self, g: np.random.Generator) -> np.ndarray:
        rands = g.random(len(self._frac_part))
        reps = self._int_part + (rands < self._frac_part)
        return np.repeat(np.arange(len(reps)), reps)

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self._seed)
        while True:
            idxs = self._epoch_indices(g)
            order = g.permutation(len(idxs))
            yield from idxs[order][self._rank :: self._world].tolist()


class MultiDatasetSampler:
    """Weighted infinite stream over the concatenation of several datasets:
    weight(img) = dataset_ratio[d] × rfs(img) (custom_dataset_dataloader.py
    :368-438). Samples with replacement per 'epoch' chunk, sharded."""

    def __init__(
        self,
        dataset_sizes: Sequence[int],
        dataset_ratios: Sequence[float],
        repeat_factors: Optional[np.ndarray] = None,
        seed: int = 0,
        rank: int = 0,
        world_size: int = 1,
        chunk: int = 65536,
    ):
        sizes = np.asarray(dataset_sizes)
        total = int(sizes.sum())
        weights = np.ones(total, np.float64)
        if repeat_factors is not None:
            assert len(repeat_factors) == total
            weights *= np.asarray(repeat_factors, np.float64)
        start = 0
        for sz, ratio in zip(sizes, dataset_ratios):
            # ratio normalized per-sample so each dataset contributes
            # ratio-proportional probability mass regardless of its size
            weights[start : start + sz] *= ratio / max(sz, 1)
            start += sz
        self._probs = weights / weights.sum()
        self._seed = seed
        self._rank = rank
        self._world = world_size
        self._chunk = chunk

    def __iter__(self) -> Iterator[int]:
        g = np.random.default_rng(self._seed)
        while True:
            draw = g.choice(len(self._probs), size=self._chunk, p=self._probs)
            yield from draw[self._rank :: self._world].tolist()


class InferenceSampler:
    """Contiguous rank shard covering the dataset exactly once."""

    def __init__(self, size: int, rank: int = 0, world_size: int = 1):
        shard = (size + world_size - 1) // world_size
        self._begin = min(rank * shard, size)
        self._end = min(self._begin + shard, size)

    def __iter__(self) -> Iterator[int]:
        return iter(range(self._begin, self._end))

    def __len__(self) -> int:
        return self._end - self._begin
