"""The bf16 window-attention backward's grid plan and its stated numerics.

``backward_plan`` chunks the windows of each head for the bf16 backward body
(``csrc/window_attention.cu``): block ``i`` takes head ``i % heads`` and the
windows of chunk ``i // heads``. Held here on the CPU with the card's
multiprocessor count monkeypatched (132 as on an H100, and 7): every (head,
window) is covered once, chunks are runs of consecutive windows in window
order, the grid fills the blocks the shared memory leaves resident, and the
scratch of partial bias gradients is (chunks, heads, n, n). The float32
body's ``f32_backward_plan`` is tested in ``test_torch_window_bwd_f32.py``.
Then the target the kernel is held to for dbias: the float32 sum over windows
of the unrounded ds, not of ds rounded to bfloat16 (which feeds its products),
as the Pallas kernel sums it; checked on the plain backward against ds
written out by hand and against ``jax.grad`` of the Pallas kernel in interpret
mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import window_attention as jwa
from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)

# (windows, heads) of Swin-L's four stages at B = 2, 896², then ragged grids
SHAPES = [(722, 6), (200, 12), (50, 24), (18, 48), (8, 3), (1, 1), (3, 200)]


def props(sms):
    class Props:
        multi_processor_count = sms
    return lambda device: Props


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,heads", SHAPES, ids=[f"{b}x{h}" for b, h in SHAPES])
def test_plan_covers_every_head_and_window_once_in_window_order(monkeypatch, sms, batch, heads):
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(sms))
    n = 144
    plan = twa.backward_plan(batch, heads, n, torch.device("cpu"))
    seen = np.zeros((heads, batch), dtype=int)
    for block in range(plan.chunks * heads):
        h, c = block % heads, block // heads
        windows = range(c * plan.per_chunk, min(batch, (c + 1) * plan.per_chunk))
        assert len(windows) >= 1, f"block {block} has no window"
        seen[h, windows.start:windows.stop] += 1
    assert (seen == 1).all()
    # one block an SM at n = 144: no more blocks than the card holds at once,
    # unless the heads alone are more
    assert plan.chunks * heads <= max(sms, heads)
    assert plan.scratch == ((plan.chunks if plan.chunks > 1 else 0), heads, n, n)


def test_plan_at_the_swin_l_stages_on_an_h100(monkeypatch):
    """The grids the card runs in a train step: 132, 132, 120 and 96 blocks."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(132))
    got = [tuple(twa.backward_plan(b, h, 144, torch.device("cpu"))[:2]) for b, h in SHAPES[:4]]
    assert got == [(22, 33), (11, 19), (5, 10), (2, 9)]


@pytest.mark.parametrize("n,resident", [(144, 1), (100, 1), (49, 3), (16, 21)])
def test_plan_fills_the_blocks_the_shared_memory_leaves(monkeypatch, n, resident):
    """Smaller windows take less shared memory, so more blocks are resident on
    a multiprocessor and the plan cuts more chunks (as many as windows allow)."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(132))
    smem = twa.backward_smem(n)
    assert min(twa.SM_SHARED_BYTES // (smem + twa.BLOCK_RESERVED_BYTES),
               twa.SM_WARPS // twa._bwd_tiles(n)) == resident
    chunks = 132 * resident // 6
    plan = twa.backward_plan(10 * chunks, 6, n, torch.device("cpu"))
    assert (plan.chunks, plan.per_chunk) == (chunks, 10)


def test_backward_smem_is_the_kernels_layout():
    """q and do of two windows and k, v of one (64-byte TMA rows), the p and ds
    tiles in bf16 and the ds sum in f32 (rows padded by 8), three mbarriers
    and 512 bytes of alignment; within the 227 KB a block may take."""
    assert twa.backward_smem(144) == 6 * 144 * 64 + 144 * 152 * 8 + 24 + 512 == 230936
    assert twa.backward_smem(49) == twa.backward_smem(64) == 6 * 64 * 64 + 64 * 72 * 8 + 536
    assert twa.backward_smem(1) == twa.backward_smem(16)
    assert max(twa.backward_smem(n) for n in range(1, 145)) <= 232448


def make_inputs(bsz, h, n, d, seed):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(bsz, h, n, d).astype(np.float32) for _ in range(4))
    bias = (rng.randn(h, n, n) * 0.5).astype(np.float32)
    mask = rng.choice([0.0, -100.0], size=(4, n, n), p=[0.7, 0.3]).astype(np.float32)
    return q, k, v, bias, mask, do


def test_dbias_sums_the_unrounded_ds_in_float32():
    """On bfloat16 inputs the plain backward's dbias is the float32 sum of
    ds = p (dp - rowsum(p dp)) with p and dp in float32; ds rounded to
    bfloat16 (the operand of dq and dk) would give measurably other bits."""
    q, k, v, bias, mask, do = make_inputs(8, 2, 16, 32, seed=4)
    half = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    qb, kb, vb, dob = half(q), half(k), half(v), half(do)
    *_, dbias = twa.reference_window_attention_backward(qb, kb, vb, torch.from_numpy(bias),
                                                        torch.from_numpy(mask), dob)
    s = torch.einsum("bhnd,bhmd->bhnm", qb.float(), kb.float()) * 32 ** -0.5 + torch.from_numpy(bias)
    s = (s.reshape(2, 4, 2, 16, 16) + torch.from_numpy(mask)[None, :, None]).reshape(8, 2, 16, 16)
    p = torch.softmax(s, dim=-1)
    dp = torch.einsum("bhnd,bhmd->bhnm", dob.float(), vb.float())
    ds = p * (dp - (p * dp).sum(-1, keepdim=True))
    np.testing.assert_allclose(dbias.numpy(), ds.sum(0).numpy(), rtol=1e-5, atol=1e-6)
    rounded = ds.to(torch.bfloat16).float().sum(0)
    assert (dbias - rounded).abs().max() > 1e-4 * dbias.abs().max()


def test_dbias_of_the_pallas_kernel_is_the_plain_backwards():
    """``jax.grad`` of the Pallas kernel (interpret mode) and the plain backward
    agree on dbias at n = 144 with the shift-like mask, in float32, to the JAX
    tests' bound for gradients."""
    q, k, v, bias, mask, do = make_inputs(4, 1, 144, 32, seed=5)
    jm = jnp.asarray(mask)

    def loss(bias):
        out = jwa.fused_window_attention(*(jnp.asarray(x) for x in (q, k, v)), bias, jm,
                                         interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss)(jnp.asarray(bias))
    *_, got = twa.reference_window_attention_backward(
        *(torch.from_numpy(x) for x in (q, k, v, bias, mask, do)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5, rtol=1e-3)
