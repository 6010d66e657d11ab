"""``dryrun_train`` and ``train_entry`` compute in float32 on every device.

The JAX ``dryrun_multichip``, whose one-device part ``dryrun_train`` is,
computes in float32 (``__graft_entry__._small_cfg``: ``FP16 = False``), as
``entry()`` does; so do the port's ``dryrun_train``, ``train_entry`` and
``entry``, on the card as on the CPU. Checked through the config each builds
for a CUDA device (the builder is stopped before it allocates), and by one
step on the CPU. The step's uniform draws come from a CPU generator whatever
the device (``ops/losses.py:uniform_draw`` draws on the generator's device
and moves the draw), so the card and the CPU take the same step:
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
    cfg = _cuda_cfg(monkeypatch, graft_entry.dryrun_train, "build_model")
    assert cfg.FP16 is False


def test_train_entry_builds_the_float32_model_for_the_card(monkeypatch):
    cfg = _cuda_cfg(monkeypatch, graft_entry.train_entry, "_train_parts")
    assert cfg.FP16 is False
    assert graft_entry.flagship_cfg().FP16 is True  # the flagship keeps its config's bf16


def test_dryrun_train_on_the_cpu_is_one_finite_float32_step():
    out = graft_entry.dryrun_train(device="cpu")
    assert out and all(math.isfinite(v) for v in out.values())


def test_a_cpu_generator_draws_the_same_numbers_for_any_device():
    want = torch.rand((2, 40), generator=torch.Generator().manual_seed(2))
    got = uniform_draw(torch.Generator().manual_seed(2), "match", (2, 40), "cpu")
    assert torch.equal(got, want)
    moved = uniform_draw(torch.Generator().manual_seed(2), "match", (2, 40), "meta")
    assert moved.device.type == "meta" and moved.shape == (2, 40)
