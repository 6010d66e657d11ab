"""The port's plain relative-position attention against the JAX package.

On the CPU ``flash_attention_relpos`` runs ``reference_attention_relpos``,
the numerics reference the CUDA kernel is held against on the card. Here it
is compared with the JAX package's Pallas kernel in interpret mode and with
its XLA reference, float32 on the CPU. Tolerance 2e-5 (absolute and
relative), the JAX package's own bound for its kernel against its reference.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import flash_attention as jfa
from divergen_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)


def inputs(bh, hw, d, seed=7):
    h, w = hw
    n = h * w
    rng = np.random.RandomState(seed)
    q, k, v = (rng.randn(bh, n, d).astype(np.float32) for _ in range(3))
    bh_t = (rng.randn(bh, h, n) * 0.3).astype(np.float32)
    bw_t = (rng.randn(bh, w, n) * 0.3).astype(np.float32)
    return q, k, v, bh_t, bw_t


@pytest.mark.parametrize("bh,hw,d,bq", [(2, (8, 8), 32, 128), (1, (16, 16), 16, 128)])
def test_relpos_matches_pallas_interpret(bh, hw, d, bq):
    args = inputs(bh, hw, d)
    want = jfa.flash_attention_relpos(*(jnp.asarray(a) for a in args), hw, block_q=bq,
                                      use_pallas=False, interpret=True)
    got = tfa.flash_attention_relpos(*(torch.from_numpy(a) for a in args), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("bh,hw,d", [(2, (5, 7), 80), (3, (8, 16), 16), (1, (1, 3), 8)])
def test_relpos_matches_jax_reference_ragged(bh, hw, d):
    args = inputs(bh, hw, d, seed=11)
    want = jfa.reference_attention_relpos(*(jnp.asarray(a) for a in args), hw)
    got = tfa.reference_attention_relpos(*(torch.from_numpy(a) for a in args), hw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


def test_relpos_takes_heads_first_views_of_a_fused_projection():
    """(B, heads, N, D) views give the (BH, N, D) result, laid out so that the
    (B, N, C) form is a free reshape."""
    b, heads, hw, d = 2, 3, (4, 5), 8
    n = hw[0] * hw[1]
    rng = np.random.RandomState(3)
    qkv = torch.from_numpy(rng.randn(b, n, 3, heads, d).astype(np.float32))
    q, k, v = (qkv[:, :, i].permute(0, 2, 1, 3) for i in range(3))
    bh_t = torch.from_numpy(rng.randn(b * heads, hw[0], n).astype(np.float32))
    bw_t = torch.from_numpy(rng.randn(b * heads, hw[1], n).astype(np.float32))
    got = tfa.flash_attention_relpos(q, k, v, bh_t, bw_t, hw)
    flat = lambda t: t.reshape(b * heads, n, d)
    want = tfa.reference_attention_relpos(flat(q), flat(k), flat(v), bh_t, bw_t, hw)
    assert got.shape == (b, heads, n, d)
    torch.testing.assert_close(flat(got), want, rtol=0, atol=0)


def test_relpos_rejects_a_wrong_grid():
    q = torch.zeros(1, 12, 8)
    with pytest.raises(ValueError):
        tfa.flash_attention_relpos(q, q, q, torch.zeros(1, 3, 12), torch.zeros(1, 5, 12), (3, 5))


def test_cpu_calls_launch_no_kernel():
    before = tfa.flash_attention_relpos.launches
    args = inputs(1, (2, 2), 8)
    tfa.flash_attention_relpos(*(torch.from_numpy(a) for a in args), (2, 2))
    assert tfa.flash_attention_relpos.launches == before
