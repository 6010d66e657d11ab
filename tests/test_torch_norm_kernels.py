"""The port's GroupNorm and LayerNorm kernel modules (their plain versions, on
the CPU) against the JAX package.

Same numpy inputs through both. ``fused_group_norm`` runs the Pallas kernel
in interpret mode (its moments, group combine with the clamped variance, and
apply kernels); ``fused_layer_norm`` runs its reference path, the CPU path of
the JAX function. Tolerances: float32 within 1e-5 of max |reference| (sums in
another order); bf16 in and out within 8e-3 of max |reference| (one bf16 step
of 2⁻⁷ relative is 7.8e-3: two float32 results a rounding apart may round to
neighbouring bf16 values); gradients (the autograd wrappers recompute through
the plain versions, as the JAX ``custom_vjp`` does) within 1e-4 of max
|reference|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import group_norm as jgn
from divergen_tpu.ops.pallas import layer_norm as jln
from divergen_tpu_torch.ops import group_norm as tgn
from divergen_tpu_torch.ops import layer_norm as tln

torch.set_num_threads(1)
TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def assert_rel_close(got, ref, tol):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def _affine(rng, c):
    return ((rng.rand(c) + 0.5).astype(np.float32), (rng.randn(c) * 0.1).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("shape", [(2, 8, 16, 64), (1, 4, 8, 96)])
def test_group_norm_vs_pallas_interpret(shape, silu, dtype):
    rng = np.random.RandomState(0)
    x = (rng.randn(*shape) * 2 + 0.5).astype(np.float32)
    scale, bias = _affine(rng, shape[-1])
    jx = jnp.asarray(x).astype(dtype)
    want = jgn.fused_group_norm(jx, jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6, silu,
                                interpret=True)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tgn.fused_group_norm(tx, torch.from_numpy(scale), torch.from_numpy(bias), 32, 1e-6, silu)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_rel_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), TOL[dtype])


def test_group_norm_clamps_the_variance_like_the_kernel_path():
    """A constant group has E[x²] − E[x]² a rounding below 0: the kernel path
    clamps it and gives bias; the JAX ``_reference`` does not clamp."""
    x = np.full((1, 8, 8, 32), 0.3, np.float32)
    scale, bias = np.ones(32, np.float32), np.linspace(-1, 1, 32).astype(np.float32)
    want = jgn.fused_group_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias), 32, 1e-6,
                                False, interpret=True)
    got = tgn.group_norm_reference(torch.from_numpy(x), torch.from_numpy(scale),
                                   torch.from_numpy(bias), 32, 1e-6)
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


def test_group_norm_gradient_vs_custom_vjp():
    rng = np.random.RandomState(1)
    x = rng.randn(2, 8, 8, 64).astype(np.float32)
    scale, bias = _affine(rng, 64)
    gout = rng.randn(*x.shape).astype(np.float32)

    def loss(a, s, b):
        return jnp.sum(jgn.fused_group_norm(a, s, b, 32, 1e-6, True, interpret=True) * gout)

    want = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (x, scale, bias)))
    tx, ts, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, scale, bias))
    (tgn.fused_group_norm(tx, ts, tb, 32, 1e-6, True) * torch.from_numpy(gout)).sum().backward()
    for g, w in zip((tx.grad, ts.grad, tb.grad), want):
        assert_rel_close(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("rows,c", [(64, 640), (33, 96), (5, 100)])
def test_layer_norm_vs_jax(rows, c, dtype):
    rng = np.random.RandomState(2)
    x = (rng.randn(2, rows, c) * 3 + 1).astype(np.float32)
    gamma, beta = _affine(rng, c)
    jx = jnp.asarray(x).astype(dtype)
    want = jln.fused_layer_norm(jx, jnp.asarray(gamma), jnp.asarray(beta), 1e-5)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(getattr(torch, dtype))
    got = tln.fused_layer_norm(tx, torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    assert_rel_close(got.float().numpy(), np.asarray(want.astype(jnp.float32)), TOL[dtype])


def test_layer_norm_gradient_vs_custom_vjp():
    rng = np.random.RandomState(3)
    x = rng.randn(16, 96).astype(np.float32)
    gamma, beta = _affine(rng, 96)
    gout = rng.randn(16, 96).astype(np.float32)
    want = jax.grad(lambda a, g, b: jnp.sum(jln.fused_layer_norm(a, g, b, 1e-5) * gout),
                    argnums=(0, 1, 2))(*map(jnp.asarray, (x, gamma, beta)))
    tx, tg, tb = (torch.from_numpy(a).requires_grad_(True) for a in (x, gamma, beta))
    (tln.fused_layer_norm(tx, tg, tb, 1e-5) * torch.from_numpy(gout)).sum().backward()
    for g, w in zip((tx.grad, tg.grad, tb.grad), want):
        assert_rel_close(g.numpy(), w, 1e-4)


def test_wrappers_refuse_a_device_without_the_kernel():
    """Only a CPU tensor takes the plain version; a tensor elsewhere reaches
    the kernel's checks and, without CUDA, raises (no fallback)."""
    from divergen_tpu_torch.ops import int8_matmul as ti8

    x = torch.empty((1, 8, 8, 32), device="meta", dtype=torch.bfloat16)
    aff = torch.empty(32, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgn.fused_group_norm(x, aff, aff)
    with pytest.raises(ValueError, match="CUDA"):
        tln.fused_layer_norm(x, aff, aff)
    w_q = torch.empty((32, 16), device="meta", dtype=torch.int8)
    w_s = torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_matmul_fused_quant(x.reshape(64, 32), w_q, w_s)
    with pytest.raises(ValueError, match="CUDA"):
        ti8.int8_matmul_pallas(x.reshape(64, 32).to(torch.int8), torch.empty((64, 1), device="meta"),
                               w_q, w_s)
    assert tgn.fused_group_norm.launches == tln.fused_layer_norm.launches == 0


def test_moment_splits_depend_on_shapes_only():
    """The moments pass's split count (and so the order of its sums) is a
    function of the shapes: two calls, the same bits on the card."""
    for b, hw, c in ((4, 128 * 128, 320), (4, 32 * 32, 1280), (2, 35, 96), (1, 16, 7)):
        splits = tgn.moment_splits(b, hw, c)
        assert splits >= 1 and (splits == 1 or hw // splits >= 64)  # 64 positions a block
    assert tgn.moment_splits(4, 128 * 128, 320) > 1  # the UNet's large maps are split
    assert tgn.moment_splits(1, 16, 7) == 1  # fewer positions than one block's step
