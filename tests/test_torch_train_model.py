"""What a model that is to be trained needs from the port's layers, backbone
and entry points.

Parameter storage: a model built for training holds float32 ``Dense`` /
``Conv`` / ``ConvTranspose`` parameters and computes in bfloat16, as flax does
with float32 parameters under a bfloat16 ``dtype``; its forward equals the bfloat16-stored model's
exactly where the float32 weights are the bfloat16 ones widened (the cast at
apply time gives the same bits back), and to bfloat16 rounding (3e-2 relative
L2 over a whole backbone) where they carry more digits. Rematerialization:
``remat=True`` gives the outputs and gradients of ``remat=False`` bit for bit
and calls the window-attention wrapper twice per block. Entry points:
``train_entry`` and ``dryrun_train`` on the CPU, and ``_synth_gt`` against the
JAX package's.
"""
import importlib

import numpy as np
import pytest
import torch

from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling import layers
from divergen_tpu_torch.modeling.backbone import swin as tswin
from divergen_tpu_torch.modeling.layers import Conv, ConvTranspose, Dense, set_param_dtype_
from divergen_tpu_torch.modeling.meta_arch.rcnn import build_model
from divergen_tpu_torch.ops import window_attention as wa
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

BF16, F32 = torch.bfloat16, torch.float32


def make(kind, **kw):
    return {"dense": lambda: Dense(6, 5, **kw), "conv": lambda: Conv(6, 5, 3, **kw),
            "deconv": lambda: ConvTranspose(6, 5, 2, **kw)}[kind]()


def layer_input(kind):
    g = torch.Generator().manual_seed(0)
    return torch.randn((2, 6) if kind == "dense" else (2, 4, 4, 6), generator=g)


@pytest.mark.parametrize("kind", ["dense", "conv", "deconv"])
def test_layers_store_float32_and_compute_in_the_compute_dtype(kind):
    torch.manual_seed(0)
    stored16 = make(kind, dtype=BF16)
    train = set_param_dtype_(make(kind, dtype=BF16), F32)
    assert {p.dtype for p in stored16.parameters()} == {BF16} and stored16.compute_dtype is None
    assert {p.dtype for p in train.parameters()} == {F32} and train.compute_dtype == BF16
    x = layer_input(kind)
    # the same weights, widened: the cast at apply time gives the same bits back
    train.load_state_dict({k: v.float() for k, v in stored16.state_dict().items()})
    y16, y = stored16(x), train(x)
    assert y.dtype == BF16 and torch.equal(y, y16)
    # float32 weights with more digits than bfloat16: equal to rounding, and
    # the gradient arrives in float32
    with torch.no_grad():
        for p in train.parameters():
            p.add_(torch.randn(p.shape, generator=torch.Generator().manual_seed(1)) * 1e-4)
    y = train(x)
    assert (y.float() - y16.float()).abs().max() <= 2e-2 * y16.float().abs().max()
    y.float().sum().backward()
    assert all(p.grad.dtype == F32 and p.grad.abs().max() > 0 for p in train.parameters())
    # stored in the compute dtype: nothing is cast per call
    assert set_param_dtype_(make(kind, dtype=F32), F32).compute_dtype is None
    assert make(kind).compute_dtype is None and make(kind).weight.dtype == F32


def test_set_param_dtype_moves_storage_and_keeps_the_compute_dtype():
    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.a, self.b = Dense(4, 4, dtype=BF16), Conv(4, 4, 1, dtype=F32)
            self.norm = layers.LayerNorm(4)

    net = set_param_dtype_(Net(), F32)
    assert net.a.weight.dtype == F32 and net.a.compute_dtype == BF16
    assert net.b.weight.dtype == F32 and net.b.compute_dtype is None
    assert net.norm.weight.dtype == F32
    assert net.a(torch.ones(1, 4)).dtype == BF16
    back = set_param_dtype_(net, BF16)
    assert back.a.weight.dtype == BF16 and back.a.compute_dtype is None
    assert back.b.weight.dtype == BF16 and back.b.compute_dtype == F32


def narrow_cfg(fp16):
    tswin.SIZE2CONFIG["narrow"] = (32, (2, 1, 1, 1), (1, 2, 4, 8), 4, 0.0)
    cfg = tge._small_cfg(backbone="swin", swin_size="narrow")
    cfg.FP16 = fp16
    return cfg


def test_training_model_holds_float32_and_matches_the_bf16_stored_model():
    cfg = narrow_cfg(True)
    gen = torch.Generator().manual_seed(3)
    train = tge.fast_init_(build_model(cfg, input_size=(64, 64), param_dtype=F32), gen)
    stored = build_model(cfg, input_size=(64, 64))
    assert {p.dtype for p in train.parameters()} == {F32}
    assert BF16 in {p.dtype for p in stored.parameters()}
    assert train.compute_dtype == BF16 and train.bottom_up.patch_embed.compute_dtype == BF16
    stored.load_state_dict(train.state_dict())  # rounds the dense and conv weights to bfloat16
    x = torch.rand((1, 64, 64, 3), generator=gen) * 255
    with torch.no_grad():
        got, want = train.backbone_features(x), stored.backbone_features(x)
    for k in want:
        assert got[k].dtype == BF16
        rel = (got[k].float() - want[k].float()).norm() / want[k].float().norm()
        assert rel <= 3e-2, (k, rel)
    # widened back, the training model repeats the stored model bit for bit
    train.load_state_dict({k: v.float() for k, v in stored.state_dict().items()})
    with torch.no_grad():
        again = train.backbone_features(x)
    assert all(torch.equal(again[k], want[k]) for k in want)


def test_params_from_jax_fills_float32_parameters_without_rounding():
    model = build_model(narrow_cfg(True), input_size=(64, 64), param_dtype=F32)
    value = np.float32(1.0 + 2.0 ** -12)  # bfloat16 keeps 8 bits of it
    tree = {"bottom_up": {"patch_embed": {"kernel": np.full((4, 4, 3, 32), value, np.float32)}}}
    model.load_state_dict(params_from_jax(tree, model), strict=False)
    assert model.bottom_up.patch_embed.weight.dtype == F32
    assert (model.bottom_up.patch_embed.weight == float(value)).all()


def test_remat_equals_no_remat_and_runs_attention_twice_per_block(monkeypatch):
    calls = []
    real = wa.fused_window_attention_packed
    monkeypatch.setattr(tswin, "fused_window_attention_packed",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    kw = dict(embed_dim=32, depths=(2, 1, 2, 1), num_heads=(1, 2, 4, 8), window=4,
              input_size=(64, 64))
    plain = layers.flax_init_(tswin.SwinTransformer(**kw), torch.Generator().manual_seed(5))
    remat = tswin.SwinTransformer(remat=True, **kw)
    remat.load_state_dict(plain.state_dict())
    x = torch.randn((2, 64, 64, 3), generator=torch.Generator().manual_seed(6))
    blocks = sum(kw["depths"])
    results = []
    for model in (plain, remat):
        del calls[:]
        out = model(x)
        assert len(calls) == blocks
        sum(v.square().sum() for v in out.values()).backward()
        assert len(calls) == (2 * blocks if model is remat else blocks)
        results.append((out, [p.grad for p in model.parameters()]))
    for k in results[0][0]:
        assert torch.equal(results[0][0][k], results[1][0][k])
    moved = 0
    for a, b in zip(results[0][1], results[1][1]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
            moved += 1
    assert moved > 50
    del calls[:]
    with torch.no_grad():  # nothing to rematerialize without gradients
        remat(x)
    assert len(calls) == blocks


def test_build_model_reads_use_checkpoint():
    cfg = narrow_cfg(False)
    assert build_model(cfg, input_size=(64, 64)).bottom_up.remat is False
    cfg.MODEL.SWIN.USE_CHECKPOINT = True
    assert build_model(cfg, input_size=(64, 64)).bottom_up.remat is True
    assert tge.flagship_cfg().MODEL.SWIN.USE_CHECKPOINT is True


def test_synth_gt_equals_the_jax_packages():
    jentry = importlib.import_module("__graft_entry__")
    want = jentry._synth_gt(np.random.RandomState(7), 2, 8, 8, img=64)
    got = tge._synth_gt(np.random.RandomState(7), 2, 8, 8, img=64)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["valid"].dtype == torch.bool and got["valid"].sum() == 6


def test_train_entry_on_the_cpu():
    step, (state, batch, rng) = tge.train_entry(device="cpu")
    assert {p.dtype for p in state.model.parameters()} == {F32}
    assert {e.dtype for e in state.ema_params.values()} == {F32}
    before = {k: v.clone() for k, v in state.params.items()}
    ema_before = {k: v.clone() for k, v in state.ema_params.items()}
    totals = []
    for i in range(2):
        state, metrics = step(state, batch, rng)
        assert state.step == i + 1 == state.optimizer.count
        assert all(torch.isfinite(v).all() for v in metrics.values())
        assert set(metrics) >= {"total_loss", "loss_centernet_loc", "loss_cls_stage2", "loss_mask"}
        totals.append(float(metrics["total_loss"]))
    moved = sum(not torch.equal(v, before[k]) for k, v in state.params.items())
    ema_moved = sum(not torch.equal(v, ema_before[k]) for k, v in state.ema_params.items())
    # at the warm-up's first rates a weight moves by 1e-7 and its EMA by a thousandth
    # of that, which float32 keeps only for the smallest values
    assert moved >= len(before) - 12 and 0 < ema_moved <= moved
    for group in state.optimizer.optim.param_groups:
        for p in group["params"]:
            assert state.optimizer.optim.state[p]["exp_avg"].dtype == F32
    # the compositor ran: the ground truth grew by the paste slots
    assert batch["gt"]["boxes"].shape[1] == 8 and batch["patches"].shape[1] == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tge.train_entry()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tge.flagship_train_entry()


def test_dryrun_train_on_the_cpu(capsys):
    out = tge.dryrun_train(device="cpu")
    assert "dryrun_train OK" in capsys.readouterr().out
    assert set(out) >= {"total_loss", "grad_norm", "loss_mask"} and out["grad_norm"] > 0
    assert out == tge.dryrun_train(device="cpu")  # seeded: the same again
