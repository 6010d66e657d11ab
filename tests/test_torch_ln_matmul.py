"""Kernel 2, ``fused_ln_matmul``: the bf16 GEMM's tile plan and weight boxes,
and the apply pass's plain twin against the JAX function.

The plan (``ops/ln_matmul.py:gemm_plan``) and the weight rows a tile stacks
(``weight_rows``) are what ``csrc/ln_matmul.cu:ln_gemm_kernel`` walks and
loads: 128-row tiles of 160 output columns (80 for GEGLU, whose h and gate
columns share one 160-wide product), row tiles fastest, on a persistent grid
of at most one block an SM. The apply pass writes ``ln_apply_reference``'s
y, held here against the y of the JAX ``_reference`` (its product with the
identity, which is exact) in float32 and bfloat16; the whole function is held
against the JAX reference in both dtypes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import ln_matmul as jln
from divergen_tpu_torch.ops import ln_matmul as tln

torch.set_num_threads(1)

# (M, K, N, geglu): the UNet's two GEGLU shapes of a call, SAM ViT-H's qkv and
# mlp_fc1 at B = 4, a ragged one
SHAPES = [(16384, 640, 5120, True), (4096, 1280, 10240, True), (16384, 1280, 3840, False),
          (16384, 1280, 5120, False), (1000, 640, 3840, False)]


@pytest.mark.parametrize("m,k,n,geglu", SHAPES)
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("group", [tln.GEMM_GROUP, 3, 1000])
def test_gemm_plan_covers_every_tile_once(m, k, n, geglu, sms, group):
    plan = tln.gemm_plan(m, n, geglu, sms)
    plan = plan._replace(group=min(group, plan.tiles_m))  # the kernel clamps it so too
    out_cols = n // 2 if geglu else n
    assert plan.step == (80 if geglu else 160)
    assert plan.tiles_m == -(-m // tln.GEMM_BM) and plan.tiles_n == -(-out_cols // plan.step)
    assert plan.blocks == min(sms, plan.tiles_m * plan.tiles_n)
    seen = {}
    cover = np.zeros((plan.tiles_m * tln.GEMM_BM, plan.tiles_n * plan.step), np.int64)
    for block in range(plan.blocks):
        for tm, tn in plan.tiles(block):
            assert (tm, tn) not in seen
            seen[tm, tn] = block
            cover[tm * tln.GEMM_BM:(tm + 1) * tln.GEMM_BM, tn * plan.step:(tn + 1) * plan.step] += 1
    assert len(seen) == plan.tiles_m * plan.tiles_n
    assert (cover[:m, :out_cols] == 1).all()
    counts = np.bincount(list(seen.values()), minlength=plan.blocks)
    assert counts.max() - counts.min() <= 1


def test_gemm_plan_walks_groups_of_row_tiles():
    """Groups of ``group`` row tiles, each swept over every column tile with
    row tiles fastest; the last group may be shorter."""
    plan = tln.gemm_plan(1000, 3840, False, 7)
    assert (plan.tiles_m, plan.tiles_n, plan.group) == (8, 24, min(tln.GEMM_GROUP, 8))
    plan = plan._replace(group=3)
    assert [plan.tile(t) for t in (0, 1, 2, 3, 71, 72, 143, 144, 145, 146, 191)] == [
        (0, 0), (1, 0), (2, 0), (0, 1), (2, 23), (3, 0), (5, 23), (6, 0), (7, 0), (6, 1),
        (7, 23)]
    assert list(plan.tiles(0))[:3] == [(0, 0), (1, 2), (2, 4)]  # tiles 0, 7, 14
    assert tln.gemm_plan(100, 3840, False, 7).group == 1  # at most tiles_m


@pytest.mark.parametrize("n", [5120, 10240, 160, 176])
def test_geglu_boxes_pair_each_h_column_with_its_gate(n):
    """Each output column c of each tile reads h row c at its place i in the
    stacked tile and gate row c + N/2 at place 80 + i, and every weight row is
    read for exactly one output column."""
    half = n // 2
    tiles = -(-half // tln.WEIGHT_BOX)
    reads = np.zeros(n, np.int64)
    for u in range(tiles):
        rows = tln.weight_rows(u, n, True)
        assert len(rows) == 2 * tln.WEIGHT_BOX
        for i in range(tln.WEIGHT_BOX):
            c = u * tln.WEIGHT_BOX + i
            if c >= half:  # past the output: not stored
                continue
            assert rows[i] == c and rows[tln.WEIGHT_BOX + i] == c + half
            reads[c] += 1
            reads[c + half] += 1
    assert (reads == 1).all()


@pytest.mark.parametrize("n", [3840, 5120, 200])
def test_plain_boxes_read_each_weight_row_once(n):
    reads = np.zeros(n, np.int64)
    for u in range(-(-n // (2 * tln.WEIGHT_BOX))):
        rows = tln.weight_rows(u, n, False)
        for i, r in enumerate(rows):
            assert r == (u * 2 * tln.WEIGHT_BOX + i if u * 2 * tln.WEIGHT_BOX + i < n else -1)
            if r >= 0:
                reads[r] += 1
    assert (reads == 1).all()


def _inputs(m, k, n, seed):
    rng = np.random.RandomState(seed)
    x = (rng.randn(m, k) * 2.0 + 0.5).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    gamma = (rng.rand(k) + 0.5).astype(np.float32)
    beta = (rng.randn(k) * 0.1).astype(np.float32)
    bias = (rng.randn(n) * 0.1).astype(np.float32)
    return x, w, gamma, beta, bias


DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("eps", [1e-5, 1e-6])
def test_apply_twin_matches_the_jax_reference_y(dtype, eps):
    tdt, jdt = DTYPES[dtype]
    k = 96
    x, _, gamma, beta, _ = _inputs(24, k, 8, 3)
    x[3] = 0.25  # a constant row: var clamps at 0
    got = tln.ln_apply_reference(torch.from_numpy(x).to(tdt), torch.from_numpy(gamma),
                                 torch.from_numpy(beta), eps)
    assert got.dtype == tdt
    xj = jnp.asarray(x).astype(jdt)
    want = jln._reference(xj, jnp.eye(k, dtype=jdt), jnp.asarray(gamma), jnp.asarray(beta),
                          eps, None, False)
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:  # f32 sums in another order: at most one bf16 rounding apart
        np.testing.assert_allclose(got, want, rtol=2 ** -8, atol=1e-6)
        assert (got == want).mean() > 0.99


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("geglu,act", [(False, "none"), (False, "gelu"), (True, "none")])
def test_plain_path_matches_the_jax_reference(dtype, geglu, act):
    tdt, jdt = DTYPES[dtype]
    x, w, gamma, beta, bias = _inputs(40, 64, 96, 5)
    got = tln.fused_ln_matmul(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt),
                              torch.from_numpy(gamma), torch.from_numpy(beta), 1e-5,
                              torch.from_numpy(bias), geglu=geglu, act=act)
    assert got.dtype == tdt and got.shape == (40, 48 if geglu else 96)
    want = jln._reference(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt),
                          jnp.asarray(gamma), jnp.asarray(beta), 1e-5, jnp.asarray(bias),
                          geglu, act)
    want = np.asarray(want.astype(jnp.float32))
    tol = 1e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol * np.abs(want).max())


def test_cpu_calls_launch_no_kernel():
    before = tln.fused_ln_matmul.launches
    x, w, gamma, beta, _ = _inputs(8, 16, 32, 1)
    tln.fused_ln_matmul(*map(torch.from_numpy, (x, w, gamma, beta)))
    assert tln.fused_ln_matmul.launches == before
