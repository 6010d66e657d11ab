"""A batch of padded images with each image's true size.

Counterpart of ``divergen_tpu/structures/image_list.py`` (detectron2's
``ImageList``): batches are born padded, ``tensor`` (B, H, W, C) NHWC at a
fixed size and ``image_sizes`` (B, 2) the true (h, w) of each image, for
clipping coordinates and postprocessing.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class ImageList:
    tensor: torch.Tensor  # (B, H, W, C) padded images
    image_sizes: torch.Tensor  # (B, 2) true (h, w)

    def __len__(self) -> int:
        return self.tensor.shape[0]

    @property
    def padded_size(self) -> Tuple[int, int]:
        return self.tensor.shape[1], self.tensor.shape[2]

    def padding_mask(self) -> torch.Tensor:
        """(B, H, W) bool: True on real pixels, False on padding."""
        h, w = self.padded_size
        dev = self.tensor.device
        ys = torch.arange(h, device=dev)[None, :, None]
        xs = torch.arange(w, device=dev)[None, None, :]
        return (ys < self.image_sizes[:, 0, None, None]) & (xs < self.image_sizes[:, 1, None, None])

    @staticmethod
    def from_tensors(tensor: torch.Tensor, image_sizes: torch.Tensor,
                     size_divisibility: int = 0) -> "ImageList":
        """Zero-pad H and W up to a multiple of ``size_divisibility``."""
        if size_divisibility > 1:
            _, h, w, _ = tensor.shape
            s = size_divisibility
            tensor = F.pad(tensor, (0, 0, 0, -(-w // s) * s - w, 0, -(-h // s) * s - h))
        return ImageList(tensor=tensor, image_sizes=image_sizes)
