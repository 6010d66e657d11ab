"""Kernel 3 at head dim 512 (the VAE's mid attention): the wgmma body's tile
plan, and the plain path against the JAX function on the same numpy inputs.

The plan (``ops/flash_attention.py:bhsd_plan`` / ``packed_plan`` at d = 512)
is what ``csrc/flash_attention_d512.cu`` walks: work items of 64-row q
tiles, taken by a persistent grid of at most one block an SM.
``flash_attention`` is held to the JAX function's XLA path
(``use_pallas=False``) and ``flash_attention_packed`` to its Pallas kernel
in interpret mode. Tolerance: max |Δ| ≤ 1e-5 · max |reference| (float32
sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import flash_attention as jfa
from divergen_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)
TOL = 1e-5
D = 512


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# (layout, batch, heads, rows): the VAE's mid attention at 1024², ragged rows,
# one row, and packed projections
PLANS = [("bhsd", 2, 1, 16384), ("bhsd", 1, 1, 1000), ("bhsd", 3, 1, 1),
         ("packed", 1, 1, 4096), ("packed", 2, 2, 1000)]


@pytest.mark.parametrize("layout,batch,heads,n", PLANS)
@pytest.mark.parametrize("sms", [132, 7])
def test_d512_plan_covers_every_row_once(layout, batch, heads, n, sms):
    """The d = 512 body's work items: every (q tile, head, batch) of 64 rows
    taken by one block exactly once, every q row of every head in exactly one
    q box, head h's q, k and v boxes at its own channels, and the blocks'
    shares differing by at most one item."""
    if layout == "bhsd":
        plan = tfa.bhsd_plan(batch, n, D)
        width, k0, v0, head_c = D, 0, 0, 0
    else:
        plan = tfa.packed_plan(batch, n, heads * D, heads)
        width, k0, v0, head_c = 3 * heads * D, heads * D, 2 * heads * D, D
    assert plan.rows == tfa.D512_TILE == 64
    tiles = -(-n // plan.rows)
    assert plan.items == (tiles, heads, batch) and plan.width == width
    blocks = plan.blocks(sms)
    assert blocks == min(tiles * heads * batch, sms)
    rows = np.zeros((batch, heads, tiles * plan.rows), np.int64)
    seen = {}
    for block, item, (qc, qr, qb), kc, vc in plan.boxes(sms):
        assert 0 <= block < blocks and item not in seen
        seen[item] = block
        t, h, b = item
        assert (qc, qr, qb) == (h * head_c, t * plan.rows, b)
        assert (kc, vc) == (k0 + h * head_c, v0 + h * head_c)
        rows[b, h, qr:qr + plan.rows] += 1
    assert len(seen) == tiles * heads * batch
    assert (rows == 1).all()  # the rows of the last box past n are TMA's zero fill
    counts = np.bincount(list(seen.values()))
    assert counts.max() - counts.min() <= 1


@pytest.mark.parametrize("sq,sk,with_bias", [(64, 64, False), (50, 37, False), (50, 37, True)])
def test_flash_attention_d512_vs_jax(sq, sk, with_bias):
    rng = np.random.RandomState(5)
    q = rng.randn(2, sq, D).astype(np.float32)
    k = rng.randn(2, sk, D).astype(np.float32)
    v = rng.randn(2, sk, D).astype(np.float32)
    bias = rng.randn(2, sq, sk).astype(np.float32) if with_bias else None
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if bias is None else jnp.asarray(bias), use_pallas=False)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              None if bias is None else torch.from_numpy(bias))
    assert got.shape == (2, sq, D)
    assert_rel_close(got.numpy(), want)


def test_flash_attention_packed_d512_vs_pallas_interpret():
    qkv = np.random.RandomState(6).randn(1, 128, 3 * 2 * D).astype(np.float32)
    want = jfa.flash_attention_packed(jnp.asarray(qkv), 2, interpret=True, heads_per_block=2,
                                      softmax_mode="rawmax")
    got = tfa.flash_attention_packed(torch.from_numpy(qkv), 2)
    assert got.shape == (1, 128, 2 * D)
    assert_rel_close(got.numpy(), want)


def test_d512_rejects_what_the_kernel_cannot_take():
    """A d = 512 tensor off the CPU that is no CUDA tensor raises: there is
    no fall back to the plain version."""
    with pytest.raises(ValueError):
        tfa.flash_attention(*(torch.empty(1, 8, D, device="meta") for _ in range(3)))
    with pytest.raises(ValueError):
        tfa.flash_attention_packed(torch.empty(1, 8, 3 * D, device="meta"), 1)
