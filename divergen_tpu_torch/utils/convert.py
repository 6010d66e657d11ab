"""JAX parameter trees → the port's ``state_dict``.

The port names its submodules after the flax scopes of the JAX package
(``down1_attn0.block0.attn1_qkv``, ``norm1.GroupNorm_0``, ``resblock3.ln_1``,
…), so the mapping is mechanical:

- Dense ``kernel`` (in, out) → ``weight`` (out, in);
- Conv ``kernel`` (kh, kw, in, out) → ``weight`` (out, in, kh, kw);
- norm ``scale`` → ``weight``; ``bias`` stays ``bias``;
- ``Embed.embedding`` → ``weight``;
- raw parameters (``positional_embedding``, ``text_projection``, …) as they are.

Real diffusers / HF checkpoints load by composing the numpy converters of
``divergen_tpu/utils/torch_weights.py`` (``convert_sdxl_unet``,
``convert_sdxl_vae``, ``convert_hf_clip_text``; jax-free at import) with
:func:`params_from_jax`.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch


def _leaf(name: str, arr: np.ndarray):
    if name == "kernel":
        if arr.ndim == 2:
            return "weight", arr.T
        if arr.ndim == 4:
            return "weight", arr.transpose(3, 2, 0, 1)
        raise ValueError(f"kernel of rank {arr.ndim}")
    if name in ("scale", "embedding"):
        return "weight", arr
    return name, arr


def params_from_jax(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """Nested dicts of arrays (a flax ``init`` tree, with or without the
    top-level ``"params"``) → flat ``{dotted name: tensor}``."""
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
            key, arr = _leaf(name, arr)
            out[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy

    walk(tree, "")
    return out
