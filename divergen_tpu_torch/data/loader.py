"""Train/test loaders: threaded mapping + batching + device prefetch.

Counterpart of ``divergen_tpu/data/loader.py``: ``_stack_samples``,
``TrainLoader`` and ``build_test_loader`` are copies (the same batches in the
same order for a seed: per-sample generator ``seed * 1_000_003 + counter``,
futures consumed in order, a synchronous backfill after a
``FileNotFoundError``); ``device_prefetch`` moves batches to the card from
pinned host memory on a side CUDA stream, ``size`` batches ahead.

The JAX module's sources: ``DiverGen/divergen/data/custom_dataset_dataloader.py:88-127``
(``build_custom_train_loader``) / detectron2 ``build_detection_train_loader``
and BSGAL's ``build_prefetch_train_loader``
(``BSGAL/bsgal/data/custom_dataset_dataloader.py:133-301``). The worker
processes of the torch DataLoader are a thread pool feeding a bounded queue
(the PNG decode and the resizes release the interpreter lock only in part,
so ``data_time`` is worth watching).
"""
from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, List, Sequence, Tuple

import numpy as np
import torch


def _stack_samples(samples: List[dict]) -> Dict[str, np.ndarray]:
    """List of mapper outputs → batch dict of stacked arrays (gt nested)."""
    out: Dict = {}
    keys = [k for k in samples[0] if k not in ("gt", "tfms", "image_id")]
    for k in keys:
        out[k] = np.stack([s[k] for s in samples])
    if "gt" in samples[0]:
        out["gt"] = {
            k: np.stack([s["gt"][k] for s in samples]) for k in samples[0]["gt"]
        }
    out["image_ids"] = np.array([s.get("image_id", -1) for s in samples])
    out["tfms"] = [s.get("tfms") for s in samples]
    return out


class TrainLoader:
    """Infinite batches: sampler indices → mapper (thread pool) → stack.

    ``rows``: the rows ``[lo, hi)`` of each batch this process maps and hands
    out, taken in turn batch by batch (default: every row). The sampler and
    the per-sample seeds advance over the whole batch, so the ranks of a node
    that each take their rows together hand out what one loader hands out.
    A file that cannot be read then raises: the whole-batch loader's backfill
    would move rows from one rank to another."""

    def __init__(
        self,
        dataset: Sequence[dict],
        mapper: Callable,
        sampler,
        batch_size: int,
        num_workers: int = 4,
        queue_size: int = 8,
        seed: int = 0,
        rows: Sequence[Tuple[int, int]] = (),
    ):
        self.dataset = dataset
        self.mapper = mapper
        self.sampler = sampler
        self.batch_size = batch_size
        self.rows = list(rows) or [(0, batch_size)]
        self.num_workers = max(num_workers, 1)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._seed = seed
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._started = False

    def _map_one(self, args):
        idx, sample_seed = args
        rng = np.random.default_rng(sample_seed)
        return self.mapper(self.dataset[idx], rng)

    def _produce(self):
        try:
            self._produce_batches()
        except Exception as e:  # handed to the consumer, which raises it
            self.queue.put(e)

    def _produce_batches(self):
        pool = ThreadPoolExecutor(max_workers=self.num_workers)
        it = iter(self.sampler)
        counter = 0
        batches = 0
        pending: "queue.Queue" = queue.Queue()
        # pipeline: keep 2 batches of futures in flight
        def submit_batch():
            nonlocal counter, batches
            lo, hi = self.rows[batches % len(self.rows)]
            batches += 1
            futs = []
            for row in range(self.batch_size):
                idx = next(it)
                if lo <= row < hi:
                    try:
                        futs.append(pool.submit(self._map_one,
                                                (idx, self._seed * 1_000_003 + counter)))
                    except RuntimeError:
                        # interpreter/pool shutdown raced the daemon producer —
                        # treat as a stop signal instead of dying noisily
                        self._stop.set()
                        return
                counter += 1
            pending.put(futs)

        submit_batch()
        submit_batch()
        while not self._stop.is_set():
            futs = pending.get()
            whole = len(futs) == self.batch_size
            samples = []
            for f in futs:
                try:
                    samples.append(f.result())
                except FileNotFoundError as e:
                    if not whole:
                        raise RuntimeError(f"{e}: a loader that maps some rows of each batch "
                                           "cannot skip a missing file") from e
            # backfill failed decodes synchronously
            while whole and len(samples) < self.batch_size:
                idx = next(it)
                try:
                    samples.append(self._map_one((idx, self._seed * 1_000_003 + counter)))
                except FileNotFoundError:
                    pass
                counter += 1
            submit_batch()
            self.queue.put(_stack_samples(samples))
        pool.shutdown(wait=False)

    def __iter__(self) -> Iterator[Dict]:
        if not self._started:
            self._thread.start()
            self._started = True
        while True:
            item = self.queue.get()
            if isinstance(item, Exception):
                raise item
            yield item

    def stop(self):
        """Stop the producer: set the flag, then take what is queued, so that
        a producer blocked on a full queue puts its batch and sees the flag."""
        self._stop.set()
        while True:
            try:
                self.queue.get_nowait()
            except queue.Empty:
                break


def _to_tensor(x: np.ndarray) -> torch.Tensor:
    """A numeric numpy array as a tensor: integers as int64 (what indexing
    and ``one_hot`` take), everything else in its own dtype."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    return t.long() if x.dtype.kind in "iu" else t


def _map_tree(fn, tree):
    if isinstance(tree, dict):
        return {k: _map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def device_prefetch(batches: Iterator[Dict], size: int = 2, device=None) -> Iterator[Dict]:
    """Move batches to ``device`` ahead of consumption, keeping ``size`` in
    flight. On a CUDA device each numeric array is copied from pinned memory
    on a side stream; the consuming stream waits on that copy's event before
    a batch is handed out, and ``record_stream`` keeps the copies' memory
    alive on it. String and object arrays (filename provenance), the
    transforms and the image ids stay on the host."""
    device = torch.device(device) if device is not None else torch.device("cuda")
    cuda = device.type == "cuda"
    stream = torch.cuda.Stream(device) if cuda else None

    def put(b):
        host = {k: b[k] for k in ("tfms", "image_ids") if k in b}
        body = {k: v for k, v in b.items() if k not in host}

        def move(x):
            if not (isinstance(x, np.ndarray) and x.dtype.kind not in "USO"):
                return x
            t = _to_tensor(x)
            if not cuda:
                return t.to(device)
            return t.pin_memory().to(device, non_blocking=True)

        if not cuda:
            return {**_map_tree(move, body), **host}, None
        with torch.cuda.stream(stream):
            out = _map_tree(move, body)
            event = torch.cuda.Event()
            event.record(stream)
        return {**out, **host}, event

    def hand_out(item):
        out, event = item
        if event is not None:
            current = torch.cuda.current_stream(device)
            current.wait_event(event)
            _map_tree(lambda x: x.record_stream(current) if isinstance(x, torch.Tensor) else x,
                      out)
        return out

    buf: List = []
    it = iter(batches)
    try:
        for _ in range(size):
            buf.append(put(next(it)))
        while True:
            nxt = put(next(it))
            yield hand_out(buf.pop(0))
            buf.append(nxt)
    except StopIteration:
        for item in buf:
            yield hand_out(item)


def build_test_loader(dataset: Sequence[dict], mapper: Callable, batch_size: int = 1,
                      rank: int = 0, world_size: int = 1) -> Iterator[List[dict]]:
    """Finite, ordered, rank-sharded (InferenceSampler path)."""
    from .samplers import InferenceSampler

    for idx in InferenceSampler(len(dataset), rank, world_size):
        yield [mapper(dataset[idx], np.random.default_rng(idx))]
