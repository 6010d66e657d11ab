"""``dryrun_train`` and ``train_entry`` compute in float32 on every device.

The JAX ``dryrun_multichip``, whose one-device part ``dryrun_train`` is,
builds ``__graft_entry__._small_cfg()``: ResNet-18 + FPN in float32
(``FP16 = False``); so does the port's ``dryrun_train``, and its
``train_entry`` and ``entry`` (Swin-T) compute in float32 too, on the card as
on the CPU. Checked through the config each builds for a CUDA device (the
model constructor is stopped before it allocates), and by one step on the
CPU. The step's uniform draws come from a CPU generator whatever the device
(``ops/losses.py:uniform_draw`` draws on the generator's device and moves
the draw), so the card and the CPU take the same step:
``chip_smoke.py`` holds the card's metrics against these.
"""
import math

import pytest
import torch

from divergen_tpu_torch import graft_entry
from divergen_tpu_torch.ops.losses import uniform_draw

torch.set_num_threads(1)


class _Built(Exception):
    pass


def _cuda_cfg(monkeypatch, fn, builder):
    seen = {}

    def build(cfg, *args, **kw):
        seen["cfg"] = cfg
        raise _Built

    monkeypatch.setattr(graft_entry, "entry_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(graft_entry, builder, build)
    with pytest.raises(_Built):
        fn()
    return seen["cfg"]


def test_dryrun_train_builds_the_float32_model_for_the_card(monkeypatch):
    import importlib

    cfg = _cuda_cfg(monkeypatch, graft_entry.dryrun_train, "build_model")
    assert cfg.FP16 is False
    # the JAX dryrun's model: _small_cfg()'s ResNet-18 + FPN
    assert cfg.MODEL.BACKBONE.NAME == "build_resnet_fpn_backbone"
    assert cfg.MODEL.RESNETS.DEPTH == 18
    jcfg = importlib.import_module("__graft_entry__")._small_cfg()
    for key in ("MODEL.BACKBONE.NAME", "MODEL.RESNETS.DEPTH", "MODEL.RESNETS.NORM", "FP16"):
        node, jnode = cfg, jcfg
        for part in key.split("."):
            node, jnode = node[part], jnode[part]
        assert node == jnode, key


def test_train_entry_builds_the_float32_model_for_the_card(monkeypatch):
    cfg = _cuda_cfg(monkeypatch, graft_entry.train_entry, "_train_parts")
    assert cfg.FP16 is False
    assert graft_entry.flagship_cfg().FP16 is True  # the flagship keeps its config's bf16


def test_dryrun_train_on_the_cpu_is_one_finite_float32_step(monkeypatch):
    from divergen_tpu_torch.modeling.backbone.resnet import ResNet

    seen = {}
    build = graft_entry.build_model

    def recording(cfg, **kw):
        seen["model"] = build(cfg, **kw)
        return seen["model"]

    monkeypatch.setattr(graft_entry, "build_model", recording)
    out = graft_entry.dryrun_train(device="cpu")
    assert out and all(math.isfinite(v) for v in out.values())
    model = seen["model"]
    assert model.backbone_name == "resnet18" and isinstance(model.bottom_up, ResNet)
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert model.compute_dtype == torch.float32 and len(out) == 12


def test_a_cpu_generator_draws_the_same_numbers_for_any_device():
    want = torch.rand((2, 40), generator=torch.Generator().manual_seed(2))
    got = uniform_draw(torch.Generator().manual_seed(2), "match", (2, 40), "cpu")
    assert torch.equal(got, want)
    moved = uniform_draw(torch.Generator().manual_seed(2), "match", (2, 40), "meta")
    assert moved.device.type == "meta" and moved.shape == (2, 40)
