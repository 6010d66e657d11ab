"""Random-access images inside tar archives (ImageNet-21k-in-tar).

Counterpart of ``divergen_tpu/data/tar_dataset.py``: a per-tar member index
(name, offset, size), optionally saved as ``.npy``, gives O(1) seeks without
extracting; ``DiskTarDataset`` concatenates many tars (one per ImageNet
class). Members are decoded by ``utils/image_io.py`` (baseline JPEG or PNG,
the pixels of ``cv2.imdecode`` + BGR -> RGB) where the JAX package calls
OpenCV. The JAX module's sources: ``DiverGen/divergen/data/tar_dataset.py:18-137``
(``_TarDataset`` / ``DiskTarDataset``), read by ``CustomDatasetMapper``'s
``tar_index`` records.
"""
from __future__ import annotations

import os
import tarfile
from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..utils.image_io import decode_rgb


def build_tar_index(tar_path: str, out_npy: Optional[str] = None) -> np.ndarray:
    """Structured (name, offset, size) index of a tar's regular files."""
    entries: List[Tuple[str, int, int]] = []
    with tarfile.open(tar_path) as tf:
        for m in tf:
            if m.isfile():
                entries.append((m.name, m.offset_data, m.size))
    arr = np.array(entries, dtype=[("name", "U128"), ("offset", "i8"), ("size", "i8")])
    if out_npy:
        np.save(out_npy, arr)
    return arr


class TarDataset:
    """Single tar with a precomputed index; returns decoded RGB arrays."""

    def __init__(self, tar_path: str, index: Optional[np.ndarray] = None,
                 index_npy: Optional[str] = None):
        self.tar_path = tar_path
        if index is None:
            if index_npy and os.path.exists(index_npy):
                index = np.load(index_npy)
            else:
                index = build_tar_index(tar_path)
        self.index = index
        self._fh = None

    def __len__(self) -> int:
        return len(self.index)

    def _file(self):
        if self._fh is None:
            self._fh = open(self.tar_path, "rb")
        return self._fh

    def read_bytes(self, i: int) -> bytes:
        rec = self.index[i]
        f = self._file()
        f.seek(int(rec["offset"]))
        return f.read(int(rec["size"]))

    def __getitem__(self, i: int) -> np.ndarray:
        return decode_rgb(self.read_bytes(i), f"{self.tar_path}:{self.index[i]['name']}")


class DiskTarDataset:
    """Concatenation of many tars (one per ImageNet class, reference
    layout); global index = (tar_id, member_id)."""

    def __init__(self, tar_paths: Sequence[str], index_dir: Optional[str] = None):
        self.datasets = []
        self.offsets = [0]
        for p in tar_paths:
            npy = (
                os.path.join(index_dir, os.path.basename(p) + ".npy") if index_dir else None
            )
            ds = TarDataset(p, index_npy=npy)
            self.datasets.append(ds)
            self.offsets.append(self.offsets[-1] + len(ds))

    def __len__(self) -> int:
        return self.offsets[-1]

    def __getitem__(self, i: int) -> np.ndarray:
        ti = int(np.searchsorted(self.offsets, i, side="right") - 1)
        return self.datasets[ti][i - self.offsets[ti]]
