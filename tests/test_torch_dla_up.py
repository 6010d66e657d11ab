"""The port's DLA aggregation (``DeformNode``, ``IDAUp``, ``DLAUp`` of
``modeling/backbone/dla.py``) against the JAX modules, float32 on the CPU.

No `build_model` path reaches these modules in either package, so they are driven as
modules, on tiny DLA-like features dla2..dla5 whose sizes do not halve
evenly (15 × 13 → 8 × 7 → 4 × 4 → 2 × 2): each 2**i upsample overshoots and
``IDAUp`` crops it to the finer map.

Weights: the flax tree traced by ``jax.eval_shape`` and filled by
``test_torch_resnet.perturbed`` (so the offset convs, zero at a real
``init``, predict offsets of about a pixel and the deformable taps move),
carried over by ``params_from_jax``. ``DeformNode``'s raw ``kernel`` (3, 3,
Cin, Cout) maps like any rank-4 flax ``kernel``, to ``weight`` (Cout, Cin,
3, 3), which the node transposes back before ``deform_conv2d``. Outputs
within 1e-4 of max |reference|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import dla as jdla
from divergen_tpu_torch.modeling.backbone import dla as tdla
from divergen_tpu_torch.modeling.layers import resize_bilinear
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_detector import assert_rel_close, t
from test_torch_resnet import perturbed, port_module

torch.set_num_threads(1)

CHANNELS = {"dla2": 6, "dla3": 8, "dla4": 10, "dla5": 12}
SIZES = {"dla2": (15, 13), "dla3": (8, 7), "dla4": (4, 4), "dla5": (2, 2)}


def features(seed=0, b=2):
    rng = np.random.RandomState(seed)
    return {n: rng.randn(b, *SIZES[n], CHANNELS[n]).astype(np.float32) for n in CHANNELS}


def traced(module, *args, seed=0):
    return perturbed(jax.eval_shape(lambda k: module.init(k, *args), jax.random.PRNGKey(0)),
                     seed)


@pytest.mark.parametrize("factor", [2, 4, 8])
def test_resize_bilinear_matches_jax(factor):
    x = np.random.RandomState(factor).randn(2, 5, 3, 4).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, 5 * factor, 3 * factor, 4), "bilinear")
    got = resize_bilinear(t(x), 5 * factor, 3 * factor)
    assert_rel_close(got.numpy(), np.asarray(want), 1e-6)


def test_deform_node_matches_jax():
    x = features(1)["dla3"]
    jm = jdla.DeformNode(7)
    variables = traced(jm, jnp.asarray(x), seed=2)
    kernel = np.asarray(variables["params"]["kernel"])
    tm = port_module(tdla.DeformNode, variables, CHANNELS["dla3"], 7)
    # the raw (3, 3, Cin, Cout) kernel is the (Cout, Cin, 3, 3) weight
    np.testing.assert_array_equal(tm.weight.detach().numpy(), kernel.transpose(3, 2, 0, 1))
    assert float(np.abs(np.asarray(variables["params"]["offset"]["kernel"])).max()) > 0
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    with torch.no_grad():
        got = tm(t(x))
    assert_rel_close(got.numpy(), np.asarray(want), 1e-4)


def test_deform_node_starts_as_a_convolution():
    """At init the offset conv is zero: every tap on its grid point, the
    mask sigmoid(0) = 1/2."""
    x = t(features(3)["dla3"])
    node = tdla.DeformNode(CHANNELS["dla3"], 5, norm="")
    assert not node.offset.weight.any() and not node.offset.bias.any()
    with torch.no_grad():
        got = node(x)
        conv = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), node.weight, padding=1)
    want = torch.relu(0.5 * conv.permute(0, 2, 3, 1))
    assert_rel_close(got.numpy(), want.numpy(), 1e-5)


@pytest.mark.parametrize("node_type", ["conv", "dcn"])
def test_ida_up_matches_jax(node_type):
    feats = features(4)
    layers = [feats[n] for n in sorted(feats)]
    jm = jdla.IDAUp(9, node_type)
    variables = traced(jm, [jnp.asarray(l) for l in layers], seed=5)
    tm = port_module(tdla.IDAUp, variables, [l.shape[-1] for l in layers], 9, node_type)
    want = jax.jit(jm.apply)(variables, [jnp.asarray(l) for l in layers])
    with torch.no_grad():
        got = tm([t(l) for l in layers])
    assert got.shape == want.shape == (2, *SIZES["dla2"], 9)
    assert_rel_close(got.numpy(), np.asarray(want), 1e-4)


@pytest.mark.parametrize("node_type", ["conv", "dcn"])
def test_dla_up_matches_jax(node_type):
    feats = features(6)
    jm = jdla.DLAUp(out_channels=8, node_type=node_type)
    jfeats = {n: jnp.asarray(v) for n, v in feats.items()}
    variables = traced(jm, jfeats, seed=7)
    tm = tdla.DLAUp(CHANNELS, out_channels=8, node_type=node_type)
    tm.load_state_dict(params_from_jax(variables, tm), strict=True)
    want = jax.jit(jm.apply)(variables, jfeats)
    with torch.no_grad():
        got = tm({n: t(v) for n, v in feats.items()})
    assert list(got) == ["dlaup", *feats] and sorted(got) == sorted(want)  # jit sorts keys
    for k in want:
        assert_rel_close(got[k].numpy(), np.asarray(want[k]), 1e-4)
