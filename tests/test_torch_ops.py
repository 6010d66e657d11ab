"""The port's kernel modules (plain torch versions, CPU) against the JAX ops.

Same numpy inputs through both, float32. Where the JAX op reaches a Pallas
kernel it runs in interpret mode: ``flash_attention_packed`` with
``heads_per_block=2, softmax_mode="rawmax"`` runs ``_packed_kernel2`` (the
default CPU path ignores ``softmax_mode``), ``fused_ln_matmul`` runs
``_kernel`` / ``_kernel_geglu`` at K a multiple of 128. ``flash_attention``
is held to its XLA path (``use_pallas=False``). Tolerance: max |Δ| ≤ 1e-5 ·
max |reference| (float32 sums in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import flash_attention as jfa
from divergen_tpu.ops.pallas import ln_matmul as jln
from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import flash_attention as tfa
from divergen_tpu_torch.ops import ln_matmul as tln

torch.set_num_threads(1)
TOL = 1e-5


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


# d = 64 is the head dim of the kernel's wgmma body (SDXL); at N = 72 the JAX
# function cannot tile N and takes its transposed path
@pytest.mark.parametrize("b,n,heads,d", [(2, 128, 4, 16), (1, 256, 2, 32), (1, 128, 2, 64),
                                         (1, 72, 2, 64)])
def test_flash_attention_packed_vs_pallas_interpret(b, n, heads, d):
    qkv = np.random.RandomState(0).randn(b, n, 3 * heads * d).astype(np.float32)
    want = jfa.flash_attention_packed(jnp.asarray(qkv), heads, interpret=True,
                                      heads_per_block=2, softmax_mode="rawmax")
    for mode in ("exact", "rawmax"):
        got = tfa.flash_attention_packed(torch.from_numpy(qkv), heads, softmax_mode=mode)
        assert got.shape == (b, n, heads * d)
        assert_rel_close(got.numpy(), want)


@pytest.mark.parametrize("b,n,c,heads", [(4, 4096, 640, 10), (4, 1024, 1280, 20),
                                         (1, 1000, 640, 10), (2, 1, 128, 2)])
@pytest.mark.parametrize("sms", [132, 7])
def test_packed_plan_covers_every_tile_once(b, n, c, heads, sms):
    """The d = 64 body's work items: every (q tile, head, batch) taken by one
    block exactly once, every q row of every head in exactly one q box, and
    head h's q, k and v boxes at channels h·d, C + h·d and 2C + h·d."""
    plan = tfa.packed_plan(b, n, c, heads)
    d = c // heads
    assert plan.width == 3 * c
    tiles = -(-n // tfa.SM90_TILE)
    assert plan.items == (tiles, heads, b)
    seen = {}
    rows = np.zeros((b, heads, n), np.int64)
    for block, item, (qc, qr, qb), kc, vc in plan.boxes(sms):
        assert 0 <= block < min(sms, tiles * heads * b)
        assert item not in seen
        seen[item] = block
        t, h, bb = item
        assert (qc, qr, qb) == (h * d, t * tfa.SM90_TILE, bb)
        assert (kc, vc) == (c + h * d, 2 * c + h * d)
        rows[bb, h, qr:qr + tfa.SM90_TILE] += 1
    assert len(seen) == tiles * heads * b
    assert (rows == 1).all()
    # the blocks' shares differ by at most one item
    counts = np.bincount(list(seen.values()))
    assert counts.max() - counts.min() <= 1


def test_bhsd_plan_reads_one_head_per_batch_row():
    plan = tfa.bhsd_plan(6, 1000, 64)
    assert plan.items == (-(-1000 // tfa.SM90_TILE), 1, 6) and plan.width == 64
    assert {(qc, kc, vc) for _, _, (qc, _, _), kc, vc in plan.boxes(132)} == {(0, 0, 0)}


def test_flash_attention_packed_rejects_tpu_only_mode():
    with pytest.raises(ValueError):
        tfa.flash_attention_packed(torch.zeros(1, 8, 3 * 64), 1, softmax_mode="bf16exp")


@pytest.mark.parametrize("sq,sk,with_bias", [(64, 64, False), (50, 37, False), (50, 37, True)])
def test_flash_attention_vs_jax(sq, sk, with_bias):
    rng = np.random.RandomState(1)
    q = rng.randn(3, sq, 16).astype(np.float32)
    k = rng.randn(3, sk, 16).astype(np.float32)
    v = rng.randn(3, sk, 16).astype(np.float32)
    bias = rng.randn(3, sq, sk).astype(np.float32) if with_bias else None
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if bias is None else jnp.asarray(bias), use_pallas=False)
    got = tfa.flash_attention(*map(torch.from_numpy, (q, k, v)),
                              None if bias is None else torch.from_numpy(bias))
    assert_rel_close(got.numpy(), want)


@pytest.mark.parametrize("geglu,act", [(False, "none"), (False, "gelu"), (True, "none")])
@pytest.mark.parametrize("with_bias", [False, True])
def test_fused_ln_matmul_vs_pallas_interpret(geglu, act, with_bias):
    m, k, n = 32, 256, 512
    rng = np.random.RandomState(2)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    gamma = (rng.rand(k) + 0.5).astype(np.float32)
    beta = (rng.randn(k) * 0.1).astype(np.float32)
    bias = (rng.randn(n) * 0.1).astype(np.float32) if with_bias else None
    want = jln.fused_ln_matmul(
        jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma), jnp.asarray(beta), 1e-5,
        None if bias is None else jnp.asarray(bias), geglu=geglu, act=act,
        bm=16, bn=128, use_pallas=False, interpret=True)
    got = tln.fused_ln_matmul(
        *map(torch.from_numpy, (x, w, gamma, beta)), 1e-5,
        None if bias is None else torch.from_numpy(bias), geglu=geglu, act=act)
    assert got.shape == (m, n // 2 if geglu else n)
    assert_rel_close(got.numpy(), want)


def test_wrappers_raise_off_cpu_without_cuda():
    """A tensor that is neither on the CPU nor a CUDA tensor the kernel takes
    raises: no silent fall back to the plain version."""
    meta = dict(device="meta")
    with pytest.raises(ValueError):
        tfa.flash_attention(*(torch.empty(1, 8, 64, **meta) for _ in range(3)))
    with pytest.raises(ValueError):
        tfa.flash_attention_packed(torch.empty(1, 8, 3 * 64, **meta), 1)
    with pytest.raises(ValueError):
        tln.fused_ln_matmul(torch.empty(8, 64, **meta), torch.empty(64, 64, **meta),
                            torch.empty(64, **meta), torch.empty(64, **meta))


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build.os, "access", lambda path, mode: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.find_nvcc()


def test_library_name_follows_the_sources(monkeypatch, tmp_path):
    (tmp_path / "k.cu").write_text("// one")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path()
    assert first == _build.library_path()
    (tmp_path / "k.cuh").write_text("// header")
    second = _build.library_path()
    (tmp_path / "k.cu").write_text("// two")
    assert len({first, second, _build.library_path()}) == 3
