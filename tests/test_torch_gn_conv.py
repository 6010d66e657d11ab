"""The port's fused GroupNorm → SiLU → 3×3 conv (its plain version, on the
CPU) and the fused-ResBlock UNet option against the JAX package.

Same numpy inputs through both. Tolerances: the function within 2e-3 of max
|reference|: both packages round the same f32 operands to bfloat16, so they
differ only by the order of float32 sums and the rare bf16 rounding tie that
order flips. The JAX Pallas kernel (``interpret=True``) rounds x itself to
bfloat16 before the affine, where the CPU path and the port keep f32 x in
f32; it is compared on bf16 x, where the two paths agree. One fused ResBlock
within 1e-2 of max |reference|: a bf16 rounding of y that falls the other way
moves the second conv's input by one bf16 step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas.fused_gn_conv import fused_gn_silu_conv3x3 as jax_fused
from divergen_tpu.pipeline.generation import unet as junet
from divergen_tpu_torch.ops import gn_conv as tgc
from divergen_tpu_torch.pipeline.generation import unet as tunet
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# the shapes of tests/test_fused_gn_conv.py, C = 48 among them: 24 groups (the
# largest divisor of 48 at most 32), where gcd(32, 48) would give 16
SHAPES = [((2, 8, 8, 32), 64, 32), ((1, 16, 12, 64), 32, 32), ((1, 8, 8, 48), 16, 32)]


def _case(shape, co, dtype):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = jnp.asarray(rng.randn(*shape) * 0.5 + 0.2, jnp.float32).astype(dtype)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    gbias = (rng.randn(c) * 0.1).astype(np.float32)
    kernel = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)  # HWIO
    cbias = (rng.randn(co) * 0.1).astype(np.float32)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    targs = (tx, torch.from_numpy(scale), torch.from_numpy(gbias),
             torch.from_numpy(kernel).permute(3, 2, 0, 1), torch.from_numpy(cbias))
    return (x, *map(jnp.asarray, (scale, gbias, kernel, cbias))), targs


def _assert_close(got: torch.Tensor, want, tol: float):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co,groups", SHAPES, ids=["c32", "c64", "c48"])
def test_twin_vs_jax_cpu_path(shape, co, groups, dtype):
    jargs, targs = _case(shape, co, dtype)
    want = jax_fused(*jargs, groups=groups)
    got = tgc.fused_gn_silu_conv3x3(*targs, groups=groups)
    assert got.dtype == targs[0].dtype and got.shape == (*shape[:3], co)
    _assert_close(got, want, 2e-3)


def test_twin_vs_pallas_interpret_and_group_rule():
    jargs, targs = _case((1, 8, 8, 48), 16, "bfloat16")
    want = jax_fused(*jargs, interpret=True)
    _assert_close(tgc.fused_gn_silu_conv3x3(*targs), want, 2e-3)
    assert tgc.group_count(48) == 24 and tgc.group_count(320) == 32 and tgc.group_count(7) == 7


def test_fused_resblock_vs_jax():
    """C_in 32 → C_out 64 (a conv_shortcut), the JAX module's fused path on
    the same ``params_from_jax`` weights, in float32."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 8, 8, 32) * 0.6).astype(np.float32)
    emb = rng.randn(2, 48).astype(np.float32)
    jm = junet.ResBlock(out_channels=64, conv_matmul="fused")
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(emb))
    tm = tunet.ResBlock(32, 64, 48, conv_matmul="fused")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(emb))
    _assert_close(got, want, 1e-2)


def test_wrapper_refuses_a_device_without_the_kernel_and_unported_options():
    x = torch.empty((1, 8, 8, 32), device="meta")
    w = torch.empty((16, 32, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgc.fused_gn_silu_conv3x3(x, x.new_empty(32), x.new_empty(32), w, x.new_empty(16))
    assert tgc.fused_gn_silu_conv3x3.launches == 0
    with pytest.raises(NotImplementedError, match='"fused"'):
        tunet.UNetSDXL.tiny(conv_matmul="im2col")
