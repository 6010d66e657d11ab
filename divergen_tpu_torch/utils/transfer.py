"""Dicts of tensors between host and card in one copy each way.

``to_host`` packs every tensor of a dict into one byte buffer on its device,
copies that buffer once and cuts it into numpy arrays of the original dtypes
and shapes (bit for bit). ``to_device`` does the reverse for numpy arrays.
One copy instead of one per key: the detector's output dict has six tensors,
and each copy from the card is a synchronization of its own. Each tensor's
bytes start on an 8-byte boundary of the buffer, so that every dtype can be
viewed in place; bfloat16, which numpy lacks, arrives as float32.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch


def _pack(tensors):
    """One uint8 tensor holding every tensor's bytes, each at an offset
    divisible by 8, and the offsets."""
    parts, offsets, pos = [], [], 0
    for v in tensors:
        raw = v.contiguous().reshape(-1).view(torch.uint8)
        pad = -raw.numel() % 8
        parts.append(raw if not pad else torch.cat([raw, raw.new_zeros(pad)]))
        offsets.append(pos)
        pos += raw.numel() + pad
    return torch.cat(parts), offsets


def _unpack(flat, offsets, like):
    return [flat[pos:pos + v.numel() * v.element_size()].view(v.dtype).reshape(v.shape)
            for pos, v in zip(offsets, like)]


def to_host(tensors: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """{key: tensor} on one device → {key: numpy array}, one device-to-host copy."""
    if not tensors:
        return {}
    values = [v.detach() for v in tensors.values()]
    flat, offsets = _pack(values)
    host = _unpack(flat.cpu(), offsets, values)
    return {k: (v.float() if v.dtype == torch.bfloat16 else v).numpy()
            for k, v in zip(tensors, host)}


def to_device(arrays: Mapping[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    """{key: numpy array} → {key: tensor on ``device``}, one host-to-device copy."""
    values = [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays.values()]
    flat, offsets = _pack(values)
    return dict(zip(arrays, _unpack(flat.to(device), offsets, values)))
