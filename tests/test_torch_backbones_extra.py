"""The port's ConvNeXt, ViTDet (ViT + simple feature pyramid), DLA-34 and
BiFPN against the JAX modules, float32 on the CPU, and ``build_model``'s
parameter names for every backbone the JAX ``build_model`` assembles.

Weights: the flax variable tree traced by ``jax.eval_shape`` and filled by
``test_torch_resnet.perturbed`` (BiFPN's ``batch_stats`` too: means and
variances away from 0 and 1), carried into the port by ``params_from_jax``
with ``strict=True``. Canvases where strides leave remainders: ConvNeXt at
68 × 52 (its "SAME"-padded 2×2/2 downsamples pad a row or column at the
end), ViT at 90 × 70 (the 16×16/16 patch embedding pads 3 + 3 and 5 + 5
pixels), BiFPN with levels 20 × 28 → 1 × 1 (the nearest upsamples go 1 × 1 →
2 × 3 → 5 × 7, the max-pools floor 5 × 7 to 2 × 3). Every output within 1e-4
of its max |reference|.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import bifpn as jbifpn
from divergen_tpu.modeling.backbone import convnext as jconvnext
from divergen_tpu.modeling.backbone import dla as jdla
from divergen_tpu.modeling.backbone import vit as jvit
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling.backbone import bifpn as tbifpn
from divergen_tpu_torch.modeling.backbone import convnext as tconvnext
from divergen_tpu_torch.modeling.backbone import dla as tdla
from divergen_tpu_torch.modeling.backbone import vit as tvit
from divergen_tpu_torch.modeling.layers import BatchNorm, same_pads
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from test_torch_detector import assert_rel_close, assert_same_parameters, t
from test_torch_resnet import assert_maps_close, image, perturbed, port_module

torch.set_num_threads(1)


def traced(module, *args, seed=0, **kwargs):
    return perturbed(jax.eval_shape(lambda k: module.init(k, *args, **kwargs),
                                    jax.random.PRNGKey(0)), seed)


def test_flax_same_padding():
    """flax "SAME": total (ceil(n / s) − 1) · s + k − n, low half first."""
    assert same_pads(68, 4, 4) == (0, 0) and same_pads(17, 2, 2) == (0, 1)
    assert same_pads(90, 16, 16) == (3, 3) and same_pads(70, 16, 16) == (5, 5)
    assert same_pads(9, 3, 1) == (1, 1) and same_pads(10, 3, 1, dilation=3) == (3, 3)


def test_convnext_forward():
    x = image(11, 68, 52)
    depths, dims = (1, 1, 2, 1), (8, 16, 24, 32)
    jm = jconvnext.ConvNeXt(depths=depths, dims=dims)
    variables = traced(jm, jnp.asarray(x), seed=1)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = port_module(tconvnext.ConvNeXt, variables, depths, dims)
    with torch.no_grad():
        got = tm(t(x))
    assert [tuple(v.shape[1:3]) for v in got.values()] == [(17, 13), (9, 7), (5, 4), (3, 2)]
    assert_maps_close(got, want)


# the JAX ``build_model``'s ViT-T (its sizes are local to ``CustomRCNN.setup``)
VIT_T = dict(dim=192, layers=4, heads=3, global_layers=(1, 3), window=4)


@pytest.fixture(scope="module")
def vitdet_case():
    assert trcnn.VIT_SIZES["T"] == VIT_T
    x = image(12, 90, 70)
    jm = jvit.ViTDet(vit=jvit.ViT(**VIT_T), out_channels=32)
    variables = traced(jm, jnp.asarray(x), seed=2)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = port_module(tvit.ViTDet, variables, tvit.ViT(input_hw=(90, 70), **VIT_T), 32)
    return x, variables, want, tm


def test_vitdet_pyramid(vitdet_case):
    x, _, want, tm = vitdet_case
    with torch.no_grad():
        got = tm(t(x))
    assert list(got) == ["p2", "p3", "p4", "p5", "p6", "p7"]
    assert [tuple(v.shape[1:3]) for v in got.values()] == [(24, 20), (12, 10), (6, 5), (3, 2),
                                                           (2, 1), (1, 1)]
    assert_maps_close(got, want)


def test_vit_trunk_and_its_canvas(vitdet_case):
    x, variables, _, tm = vitdet_case
    jm = jvit.ViT(**VIT_T)
    want = jax.jit(jm.apply)({"params": variables["params"]["vit"]}, jnp.asarray(x))
    with torch.no_grad():
        got = tm.vit(t(x))
    assert_rel_close(got.numpy(), want, 1e-4)
    # global layers' tables are sized by the grid (6, 5); window layers by the window
    assert tuple(tm.vit.block1.attn.rel_pos_h.shape) == (11, 64)
    assert tuple(tm.vit.block0.attn.rel_pos_h.shape) == (7, 64)
    with pytest.raises(ValueError, match="input_size"):
        tm.vit(t(image(12, 112, 70)))
    with pytest.raises(ValueError, match="position table"):
        tvit.ViT(input_hw=(1040, 64), **trcnn.VIT_SIZES["T"])


def test_dla34_forward():
    x = image(13, 64, 64)
    jm = jdla.DLA34()
    variables = traced(jm, jnp.asarray(x), seed=3)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = port_module(tdla.DLA34, variables)
    with torch.no_grad():
        got = tm(t(x))
    assert [tuple(v.shape[1:]) for v in got.values()] == [(8, 8, 128), (4, 4, 256), (2, 2, 512)]
    assert_maps_close(got, want)


def test_bifpn_with_batch_stats():
    """Non-zero running statistics reach the port's BatchNorm buffers through
    ``params_from_jax``; the BatchNorm normalizes with them in training too."""
    rng = np.random.RandomState(14)
    feats = {f"res{i + 3}": (rng.randn(2, h, w, c)).astype(np.float32)
             for i, (h, w, c) in enumerate([(20, 28, 24), (10, 14, 40), (5, 7, 48)])}
    jm = jbifpn.BiFPN(out_channels=32, num_layers=2)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    variables = traced(jm, jf, seed=4)
    assert set(variables) == {"params", "batch_stats"}
    want = jax.jit(jm.apply)(variables, jf)
    tm = port_module(tbifpn.BiFPN, variables, list(feats), [24, 40, 48], 32, 2)
    bn = tm.layer1.bu2.conv.bn
    assert isinstance(bn, BatchNorm) and not any(b.requires_grad for b in tm.buffers())
    np.testing.assert_array_equal(
        bn.running_var.numpy(), variables["batch_stats"]["layer1"]["bu2"]["conv"]["bn"]["var"])
    assert not any(n.endswith(("running_mean", "running_var")) for n, _ in tm.named_parameters())
    tm.train()
    got = tm({k: t(v) for k, v in feats.items()})
    assert [tuple(v.shape[1:3]) for v in got.values()] == [(20, 28), (10, 14), (5, 7), (2, 3),
                                                           (1, 1)]
    assert_maps_close(got, want)


# -- build_model: every backbone, its parameter names ----------------------------------

# ResNet-18, Swin + BiFPN: test_torch_detector.py:test_custom_rcnn_not_yet_ported
BACKBONES = {
    "resnet50": (["MODEL.RESNETS.DEPTH", 50], 64),
    "res2net50": (["MODEL.BACKBONE.NAME", "build_res2net_fpn_backbone",
                   "MODEL.RESNETS.DEPTH", 50], 64),
    "convnext": (["MODEL.BACKBONE.NAME", "build_convnext_fpn_backbone"], 64),
    "vitdet": (["MODEL.BACKBONE.NAME", "build_vit_fpn_backbone", "MODEL.VIT_SIZE", "T"], 64),
    "dla34": (["MODEL.BACKBONE.NAME", "build_dla_bifpn_backbone",
               "MODEL.BIFPN.NUM_BIFPN", 2], 128),
}


@pytest.mark.parametrize("name", list(BACKBONES))
def test_build_model_backbone_parameters(name):
    keys, size = BACKBONES[name]
    jentry = importlib.import_module("__graft_entry__")
    jcfg, tcfg = jentry._small_cfg(), tge._small_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_list(keys)
    tm = assert_same_parameters(jcfg, tcfg, size)
    assert tm.backbone_name == name
    assert (tm.fpn is None) == (name == "vitdet")
    assert isinstance(tm.fpn, tbifpn.BiFPN) == (name == "dla34")
