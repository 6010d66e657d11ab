"""The port's ResNet and Res2Net backbones and the ResNet-18 detector's
training forward against the JAX package, float32 on the CPU.

Weights: the flax tree at narrow widths (``res2_out_channels=32``) traced by
``jax.eval_shape`` and filled from a seeded numpy generator (``perturbed``:
norm scales and biases away from the identity FrozenBN starts at), carried into
the port by ``params_from_jax`` with ``strict=True``. Inputs from numpy, at a
canvas whose sides the strides do not divide. Tolerances: every feature map
within 1e-4 of its max |reference|; the train step's losses within 1e-4
relative (``assert_losses_close``).
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.modeling.backbone import resnet as jresnet
from divergen_tpu.modeling.meta_arch import rcnn as jrcnn
from divergen_tpu_torch import graft_entry as tge
from divergen_tpu_torch.modeling.backbone import resnet as tresnet
from divergen_tpu_torch.modeling.meta_arch import rcnn as trcnn
from divergen_tpu_torch.utils.convert import params_from_jax
from test_torch_detector import assert_rel_close, randomized, shape_init, t
from test_torch_train_losses import (assert_losses_close, detector_batch, jax_draws, jx,
                                     torch_gt, train_cfg)

torch.set_num_threads(1)

FEATURES = ("res2", "res3", "res4", "res5")


def perturbed(tree, seed=0):
    """Values for a flax variable tree (or its ``jax.eval_shape``): norm
    scales around 1, biases, BatchNorm means and (positive) variances, and
    fan-in scaled normal kernels and raw parameters, from ``seed``."""
    rng = np.random.RandomState(seed)

    def mk(path, v):
        name, shape = str(path[-1].key), tuple(v.shape)
        if name == "scale":
            return (1.0 + 0.2 * rng.randn(*shape)).astype(np.float32)
        if name in ("bias", "mean"):
            return (0.1 * rng.randn(*shape)).astype(np.float32)
        if name == "var":
            return (0.5 + rng.rand(*shape)).astype(np.float32)
        fan_in = int(np.prod(shape[:-1])) if len(shape) >= 2 else 1
        return (rng.randn(*shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(mk, tree)


def port_module(cls, variables, *args, **kwargs):
    module = cls(*args, **kwargs)
    module.load_state_dict(params_from_jax(variables, module), strict=True)
    return module.eval()


def image(seed, h=50, w=66, b=2):
    return (np.random.RandomState(seed).rand(b, h, w, 3) * 2 - 1).astype(np.float32)


def assert_maps_close(got, want, tol=1e-4):
    assert list(got) == list(want)
    for k in want:
        assert_rel_close(got[k].detach().numpy(), np.asarray(want[k]), tol)


@pytest.mark.parametrize("depth,norm", [(18, "FrozenBN"), (18, "BN"), (50, "FrozenBN")])
def test_resnet_forward(depth, norm):
    """Depths 18 and 50 both on bottleneck blocks, stride in the 1×1; "BN"
    maps to a GroupNorm in both packages. (At depth 50 the narrow GroupNorms,
    one channel a group over a few pixels, leave the float32 JAX module
    itself 1.2e-4 of max |res5| from a float64 evaluation; depth 18 is
    2e-5.)"""
    x = image(depth)
    jm = jresnet.ResNet(depth=depth, norm=norm, out_features=FEATURES, stem_out_channels=16,
                        res2_out_channels=32)
    variables = perturbed(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), depth)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = port_module(tresnet.ResNet, variables, depth, norm, FEATURES, stem_out_channels=16,
                     res2_out_channels=32)
    with torch.no_grad():
        got = tm(t(x))
    assert [tuple(v.shape[1:3]) for v in got.values()] == [(13, 17), (7, 9), (4, 5), (2, 3)]
    assert_maps_close(got, want)
    if depth == 18:
        assert isinstance(tm.res2_block0, tresnet.Bottleneck)


def test_res2net_forward(norm="FrozenBN"):
    """26w × 4s narrowed to width 8: the deep stem, the chained splits of a
    normal block and the average-pooled last split of a striding one. (With
    "BN", one-channel groups again put the JAX module's own float32 error
    above 1e-4.)"""
    x = image(7)
    jm = jresnet.Res2Net(depth=50, width=8, norm=norm, out_features=FEATURES,
                         res2_out_channels=32)
    variables = perturbed(jax.eval_shape(jm.init, jax.random.PRNGKey(1), jnp.asarray(x)), 3)
    want = jax.jit(jm.apply)(variables, jnp.asarray(x))
    tm = port_module(tresnet.Res2Net, variables, 50, 8, norm=norm, out_features=FEATURES,
                     res2_out_channels=32)
    with torch.no_grad():
        got = tm(t(x))
    assert_maps_close(got, want)


def test_resnet18_detector_train_step_losses():
    """``_small_cfg()`` (ResNet-18 + FPN, the JAX dryrun's model): one float32
    training forward on the same weights, batch and draws."""
    images, sizes, gt, fed = detector_batch(51)
    key = jax.random.PRNGKey(6)
    jentry = importlib.import_module("__graft_entry__")
    jm = jrcnn.build_model(train_cfg(jentry._small_cfg))
    jkw = dict(gt=jx(gt), rng=key, fed_weight=jnp.asarray(fed), training=True)
    params = randomized(shape_init(jm, jnp.asarray(images), jnp.asarray(sizes), **jkw),
                        np.random.RandomState(52))
    want = jax.jit(lambda p: jm.apply(p, jnp.asarray(images), jnp.asarray(sizes), **jkw))(params)
    tm = trcnn.build_model(train_cfg(tge._small_cfg), input_size=(64, 64))
    assert isinstance(tm.bottom_up, tresnet.ResNet) and len(tm.bottom_up.blocks) == 8
    tm.load_state_dict(params_from_jax(params, tm), strict=True)
    tm.train()
    got = tm(t(images), t(sizes), gt=torch_gt(gt), rng=jax_draws(key, 2, 24, 8),
             fed_weight=t(fed), training=True)
    assert len(got) == 10
    assert_losses_close(got, want)
