"""JAX parameter trees → the port's ``state_dict``, and back for the tests.

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
  ``relative_position_bias_table``, ``zs_weight``, ``bg_bias``, …) as they are;
- flax ``batch_stats`` (``nn.BatchNorm``'s ``mean`` and ``var``) → the
  ``running_mean`` and ``running_var`` buffers of ``layers.BatchNorm``.

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
    top-level ``"params"``, and with its ``"batch_stats"`` beside them) →
    flat ``{dotted name: tensor}``. ``module`` is the port's module the
    result is meant for; it is needed when the tree holds an
    ``nn.ConvTranspose`` kernel."""
    stats = {}
    if "params" in tree and set(tree) <= {"params", "batch_stats"}:
        tree, stats = tree["params"], tree.get("batch_stats", {})
    out: Dict[str, torch.Tensor] = {}

    def walk(node: Mapping[str, Any], prefix: str, leaf) -> None:
        for name, val in node.items():
            if isinstance(val, Mapping):
                walk(val, f"{prefix}{name}.", leaf)
                continue
            arr = np.asarray(val)
            if arr.dtype.name == "bfloat16":
                arr = arr.astype(np.float32)  # numpy's bfloat16 has no torch twin
            deconv = module is not None and isinstance(
                module.get_submodule(prefix[:-1]), nn.ConvTranspose2d)
            key, arr = leaf(name, arr, deconv)
            out[prefix + key] = torch.from_numpy(np.array(arr))  # a writable copy

    walk(tree, "", _leaf)
    walk(stats, "", lambda name, arr, _: (_STATS[name], arr))
    return out


_STATS = {"mean": "running_mean", "var": "running_var"}


def tree_from_module(module: nn.Module, like: Mapping[str, Any], grad: bool = False):
    """The inverse of :func:`params_from_jax`: ``module``'s parameters (or,
    with ``grad``, their gradients, zeros where there is none) as numpy arrays
    under the flax names and layouts of the tree ``like``."""
    if set(like) == {"params"}:
        return {"params": tree_from_module(module, like["params"], grad)}
    named = dict(module.named_parameters())

    def walk(node: Mapping[str, Any], prefix: str):
        out = {}
        for name, val in node.items():
            if isinstance(val, Mapping):
                out[name] = walk(val, f"{prefix}{name}.")
                continue
            ndim = np.ndim(val)
            deconv = isinstance(module.get_submodule(prefix[:-1]), nn.ConvTranspose2d)
            key, _ = _leaf(name, np.empty((0,) * ndim), deconv)
            p = named[prefix + key]
            t = p.grad if grad else p
            arr = (torch.zeros_like(p) if t is None else t).detach().float().cpu().numpy()
            if name == "kernel" and ndim == 2:
                arr = arr.T
            elif name == "kernel" and deconv:
                arr = arr.transpose(2, 3, 0, 1)[::-1, ::-1]
            elif name == "kernel":
                arr = arr.transpose(2, 3, 1, 0)
            out[name] = np.ascontiguousarray(arr).reshape(np.shape(val))
        return out

    return walk(like, "")


@torch.no_grad()
def load_adam_state(optim: torch.optim.Optimizer, module: nn.Module, mu: Mapping[str, Any],
                    nu: Mapping[str, Any], count: int) -> None:
    """Fill a ``torch.optim.Adam``/``AdamW`` state from an optax Adam state:
    the first and second moment trees ``mu`` and ``nu`` (flax names, every
    parameter present) and the step ``count``."""
    first, second = params_from_jax(mu, module), params_from_jax(nu, module)
    for name, p in module.named_parameters():
        optim.state[p] = {
            "step": torch.tensor(float(count)),
            "exp_avg": first[name].to(p.device, p.dtype).contiguous(),
            "exp_avg_sq": second[name].to(p.device, p.dtype).contiguous(),
        }


def jax_last_dim(module: nn.Module, name: str) -> int:
    """The dim of ``module``'s parameter ``name`` that holds the last axis of
    its JAX leaf, by the mapping of :func:`params_from_jax`: dim 0 of a Dense
    or Conv ``weight`` (a flax ``kernel``: (in, out) → (out, in), (kh, kw,
    in, out) → (out, in, kh, kw)), dim 1 of a ``ConvTranspose2d`` weight, and
    the last dim of everything else (embeddings, norm scales, biases, raw
    parameters), which keeps the JAX layout."""
    prefix, _, leaf = name.rpartition(".")
    owner = module.get_submodule(prefix)
    p = getattr(owner, leaf)
    if leaf == "weight" and p.dim() >= 2 and not isinstance(owner, nn.Embedding):
        return 1 if isinstance(owner, nn.ConvTranspose2d) else 0
    return p.dim() - 1
