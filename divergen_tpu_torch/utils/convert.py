"""JAX parameter trees → the port's ``state_dict``.

The port names its submodules after the flax scopes of the JAX package
(``down1_attn0.block0.attn1_qkv``, ``norm1.GroupNorm_0``, ``resblock3.ln_1``,
…), so the mapping is mechanical:

- Dense ``kernel`` (in, out) → ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) → ``weight`` (out, in, kh, kw);
- ConvTranspose ``kernel`` (kh, kw, in, out) → ``weight`` (in, out, kh, kw),
  flipped in both spatial axes: flax computes a fractionally-strided
  convolution without a flip, ``torch.nn.ConvTranspose2d`` scatters. Which
  rank-4 kernels are transposed convolutions is read from the target module's
  type (``params_from_jax(tree, module)``), never guessed from a shape;
- norm ``scale`` → ``weight`` (also ``FrozenBatchNorm``'s vector and
  ``Scale``'s scalar); ``bias`` stays ``bias``;
- ``Embed.embedding`` → ``weight``;
- raw parameters (``positional_embedding``, ``text_projection``,
  ``relative_position_bias_table``, ``zs_weight``, ``bg_bias``, …) as they are.

Real checkpoints (diffusers, HF, openai CLIP, segment-anything, Swin,
detectron2 detectors) load by
composing the numpy converters of ``utils/torch_weights.py`` with
:func:`params_from_jax`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
import torch.nn as nn


def _leaf(name: str, arr: np.ndarray, transposed_conv: bool = False):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4 and transposed_conv:
            return "weight", arr[::-1, ::-1].transpose(2, 3, 0, 1)
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def params_from_jax(tree: Mapping[str, Any],
                    module: Optional[nn.Module] = None) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays (a flax ``init`` tree, with or without the
    top-level ``"params"``) → flat ``{dotted name: tensor}``. ``module`` is
    the port's module the result is meant for; it is needed when the tree
    holds an ``nn.ConvTranspose`` kernel."""
    if set(tree) == {"params"}:
        tree = tree["params"]
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str) -> None:
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{name}.")
                continue
            arr = np.asarray(val)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)  # numpy's bfloat16 has no torch twin
            deconv = module is not None and isinstance(
                module.get_submodule(prefix[:-1]), nn.ConvTranspose2d)
            key, arr = _leaf(name, arr, deconv)
            out[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy

    walk(tree, "")
    return out
