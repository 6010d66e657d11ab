"""Deployment export through ``torch.export``.

Counterpart of ``divergen_tpu/export.py``, which serializes the inference
graph as StableHLO: here the artifact holds ``torch.export`` programs of
``CustomRCNN.forward(images, image_sizes, training=False)`` at a fixed
``(batch, height, width, 3)`` float32 canvas and an int32 ``(batch, 2)``
size tensor. The whole inference graph is in it, pre- and post-processing
included (the NMS fixpoint as a ``while_loop``), and it loads and runs
without the model-building code: :func:`load_exported` imports
``divergen_tpu_torch.ops`` only, which registers the custom ops the programs
call.

Two layouts, as in the JAX package:

* weights-separate (the default): the program takes ``(params, images,
  image_sizes)``, ``params`` the model's flat ``state_dict`` (applied with
  ``torch.func.functional_call``); the artifact holds no weights, so a
  fine-tuned checkpoint needs no new export;
* baked (``bake_params=True``): the weights are constants of the program, one
  self-contained file.

Platforms. A JAX artifact records several platforms in one module; a
``torch.export`` program holds one device's operators. The artifact therefore
holds one program per device named in ``platforms`` (by default the device
the model is on), each traced with the model on that device, and
``ExportedInference`` runs the one that matches its inputs' device. Which
kernels a program holds follows from the wrappers' rule, a plain version for
a CPU tensor and the kernel for a CUDA one: the ``"cuda"`` program calls
Swin's window attention as the custom op ``divergen::window_attention_packed``
(``ops/window_attention.py``, kernel 5 of ``csrc/window_attention.cu``, or
the float32 body of ``csrc/attention_f32.cu`` for a float32 model), the
detector's only kernel; the ``"cpu"`` program holds its plain torch twin.
Export a card's program from a process with the card.

The artifact is one zip file (stored, not compressed) holding a
``<device>.pt2`` (``torch.export.save``) per platform and ``meta.json``.
"""
from __future__ import annotations

import copy
import io
import json
import os
import zipfile
from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn as nn

from . import ops  # noqa: F401  (registers the custom ops the programs call)

__all__ = ["export_inference", "save_exported", "load_exported", "ExportedInference"]


class _Baked(nn.Module):
    """The inference forward with the model's weights as program state."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images: torch.Tensor, image_sizes: torch.Tensor):
        return self.model(images, image_sizes, training=False)


class _WeightsSeparate(nn.Module):
    """The inference forward with the weights as its first input
    (``torch.func.functional_call``). The model is held outside the module's
    registry, so none of its own weights becomes program state; what the
    flat ``state_dict`` leaves out (non-persistent buffers: Swin's
    relative-position index) is a constant of the program."""

    def __init__(self, model: nn.Module):
        super().__init__()
        object.__setattr__(self, "inner", model)

    def forward(self, params: Dict[str, torch.Tensor], images: torch.Tensor,
                image_sizes: torch.Tensor):
        return torch.func.functional_call(self.inner, params, (images, image_sizes),
                                          {"training": False})


class Aval(NamedTuple):
    """The shape and dtype of one flat input of an exported program."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


class Exported(NamedTuple):
    """What :func:`export_inference` returns: one program per device type,
    and whether the weights are baked in."""
    programs: Dict[str, torch.export.ExportedProgram]
    baked: bool

    @property
    def platforms(self) -> Tuple[str, ...]:
        return tuple(self.programs)


def export_inference(model: nn.Module, params: Mapping[str, torch.Tensor], *, batch: int = 1,
                     height: int, width: int, platforms: Optional[Sequence[str]] = None,
                     bake_params: bool = False) -> Exported:
    """Export ``model(images, image_sizes, training=False)`` at a fixed input
    shape (detection serves padded static canvases, so a fixed
    ``(batch, height, width, 3)`` export is what production runs; each
    image's own size still comes in through ``image_sizes``).

    ``params`` is a flat ``state_dict`` of the model: the input specs of a
    weights-separate program, or the constants of a baked one.
    ``platforms`` names device types (``"cuda"``, ``"cpu"``), by default the
    model's; the model is copied to trace on another device, or to bake
    ``params`` into."""
    own = model.state_dict()
    if set(params) != set(own):
        missing, extra = sorted(set(own) - set(params)), sorted(set(params) - set(own))
        raise ValueError(f"params are not the model's state_dict: missing {missing[:5]}, "
                         f"unexpected {extra[:5]}")
    home = next(model.parameters()).device.type
    programs = {}
    for dev in tuple(platforms or (home,)):
        m = model if dev == home and not bake_params else copy.deepcopy(model).to(dev)
        p = {k: v.to(dev) for k, v in params.items()}
        images = torch.zeros((batch, height, width, 3), dtype=torch.float32, device=dev)
        sizes = torch.tensor([[height, width]] * batch, dtype=torch.int32, device=dev)
        with torch.no_grad():
            if bake_params:
                m.load_state_dict(p)
                ep = torch.export.export(_Baked(m), (images, sizes))
            else:
                ep = torch.export.export(_WeightsSeparate(m), (p, images, sizes))
        ep.example_inputs = None  # else saved with the program: the weights, for this one
        programs[dev] = ep
    return Exported(programs, bake_params)


def save_exported(exp: Exported, path: str) -> str:
    """Write the artifact to ``path`` (by convention ``*.pt2z``)."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED, allowZip64=True) as z:
        z.writestr("meta.json", json.dumps({"platforms": list(exp.platforms),
                                            "baked": exp.baked}))
        for dev, ep in exp.programs.items():
            buf = io.BytesIO()
            torch.export.save(ep, buf)
            z.writestr(f"{dev}.pt2", buf.getvalue())
    return path


class ExportedInference:
    """A loaded artifact. ``__call__`` has the exported signature:
    ``(params, images, image_sizes)`` for a weights-separate export,
    ``(images, image_sizes)`` for a baked one, and runs the program of the
    images' device type. An input of another shape or dtype raises."""

    def __init__(self, exp: Exported):
        self.exported = exp
        self._modules: Dict[str, nn.Module] = {}

    @property
    def platforms(self) -> Tuple[str, ...]:
        return self.exported.platforms

    @property
    def baked(self) -> bool:
        return self.exported.baked

    @property
    def in_avals(self) -> Tuple[Aval, ...]:
        """The flat user inputs of the first platform's program, in call order
        (a weights-separate program's params first, by name)."""
        ep = self.exported.programs[self.platforms[0]]
        specs = {n.name: n.meta["val"] for n in ep.graph.nodes if n.op == "placeholder"}
        return tuple(Aval(tuple(specs[name].shape), specs[name].dtype)
                     for name in ep.graph_signature.user_inputs)

    def _program(self, device_type: str) -> nn.Module:
        if device_type not in self.exported.programs:
            raise ValueError(f"no program for {device_type!r} in this artifact "
                             f"(platforms {self.platforms})")
        if device_type not in self._modules:
            self._modules[device_type] = self.exported.programs[device_type].module()
        return self._modules[device_type]

    def __call__(self, *args) -> Dict[str, torch.Tensor]:
        names = ("images", "image_sizes") if self.baked else ("params", "images", "image_sizes")
        if len(args) != len(names):
            raise TypeError(f"this artifact takes ({', '.join(names)}), got {len(args)} arguments")
        if not self.baked:
            args = (dict(args[0]), *args[1:])  # the traced spec is a dict, not an OrderedDict
        with torch.no_grad():
            return self._program(args[-2].device.type)(*args)


def load_exported(path_or_bytes: Union[str, os.PathLike, bytes, bytearray]) -> ExportedInference:
    """Load an artifact from a path or its bytes; no model code or config is
    needed."""
    src = (io.BytesIO(bytes(path_or_bytes)) if isinstance(path_or_bytes, (bytes, bytearray))
           else path_or_bytes)
    with zipfile.ZipFile(src) as z:
        meta = json.loads(z.read("meta.json"))
        programs = {dev: torch.export.load(io.BytesIO(z.read(f"{dev}.pt2")))
                    for dev in meta["platforms"]}
    return ExportedInference(Exported(programs, bool(meta["baked"])))
