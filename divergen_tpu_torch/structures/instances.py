"""Padded, static-shape ``Instances``.

Counterpart of ``divergen_tpu/structures/instances.py`` (detectron2's
``Instances``): every field is padded to one capacity N along its first
axis and a boolean ``valid`` field marks the real rows. Fields are read and
set as attributes; ``set`` returns a new ``Instances`` (the JAX class is
immutable-first), while attribute assignment changes this one, as in the
JAX class. ``len`` is the capacity, ``num_valid`` the count of real rows;
``gather`` and ``masked`` replace ragged indexing, ``cat`` concatenates
capacities and ``pad_to`` pads or truncates them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
import torch.nn.functional as F


class Instances:
    """A fixed-capacity collection of per-instance fields; ``image_size`` is
    (h, w)."""

    def __init__(self, image_size: Tuple[int, int], **fields: torch.Tensor):
        object.__setattr__(self, "_image_size", tuple(image_size))
        object.__setattr__(self, "_fields", dict(fields))

    @property
    def image_size(self) -> Tuple[int, int]:
        return self._image_size

    def __setattr__(self, name: str, value: Any) -> None:
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self._fields[name] = value

    def __getattr__(self, name: str) -> torch.Tensor:
        if name.startswith("_") or name not in self._fields:
            raise AttributeError(f"Instances has no field '{name}'")
        return self._fields[name]

    def has(self, name: str) -> bool:
        return name in self._fields

    def get(self, name: str) -> torch.Tensor:
        return self._fields[name]

    def set(self, name: str, value: torch.Tensor) -> "Instances":
        """A new ``Instances`` with the field set."""
        return Instances(self._image_size, **{**self._fields, name: value})

    def get_fields(self) -> Dict[str, torch.Tensor]:
        return dict(self._fields)

    def __len__(self) -> int:
        """The capacity (padded N), not the count of real rows."""
        for v in self._fields.values():
            return int(v.shape[0])
        return 0

    def num_valid(self) -> torch.Tensor:
        return self._fields["valid"].sum()

    def gather(self, indices: torch.Tensor) -> "Instances":
        """The rows at ``indices``, every field."""
        return Instances(self._image_size, **{k: v[indices] for k, v in self._fields.items()})

    def masked(self, keep: torch.Tensor) -> "Instances":
        """``valid`` AND ``keep``: a filter that keeps the shapes."""
        return self.set("valid", self._fields["valid"] & keep)

    @staticmethod
    def cat(instance_list) -> "Instances":
        """Concatenation along the capacity axis; every item has the same fields."""
        first = instance_list[0]
        keys = set(first._fields)
        for ins in instance_list[1:]:
            assert set(ins._fields) == keys, "field mismatch in cat"
        return Instances(first._image_size,
                         **{k: torch.cat([ins._fields[k] for ins in instance_list])
                            for k in keys})

    def pad_to(self, capacity: int) -> "Instances":
        """Every field padded with zeros (``valid`` False) or truncated to
        ``capacity`` rows."""
        out = {}
        for k, v in self._fields.items():
            n = v.shape[0]
            out[k] = v[:capacity] if n >= capacity else F.pad(
                v, (0, 0) * (v.dim() - 1) + (0, capacity - n))
        return Instances(self._image_size, **out)

    def __repr__(self) -> str:
        fields = ", ".join(f"{k}:{tuple(v.shape)}" for k, v in self._fields.items())
        return f"Instances(image_size={self._image_size}, {fields})"


def empty_instances(image_size: Tuple[int, int], capacity: int, mask_size=None,
                    with_masks: bool = False, device=None) -> Instances:
    """All-invalid ``Instances`` with the detection fields (boxes, classes,
    scores, valid and, with ``with_masks``, masks of ``mask_size`` or the
    image size)."""
    fields = dict(
        boxes=torch.zeros((capacity, 4), device=device),
        classes=torch.zeros((capacity,), dtype=torch.int32, device=device),
        scores=torch.zeros((capacity,), device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
    if with_masks:
        h, w = mask_size if mask_size is not None else image_size
        fields["masks"] = torch.zeros((capacity, h, w), device=device)
    return Instances(image_size, **fields)
