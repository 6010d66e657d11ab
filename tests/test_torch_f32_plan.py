"""The float32 bodies' plans and arithmetic, on the CPU.

The float32 attention forward (``csrc/attention_f32.cu:attn_f32_kernel``)
takes its tiles from ``Plan<D>``, mirrored by
``ops/attention_f32.py:TC_PLANS`` (``chip_smoke.py`` holds the library's
``dg_attention_f32_plan`` against it on the card). Held here: every output
element (query row, channel) is stored by exactly one warp of one block; the
d = 512 channel split covers the 512 channels once; P·V's k-slots are a
bijection onto the keys of each 8-key slab, in the order the S accumulator
holds them; a block's shared memory fits. Then the body's arithmetic written
out in float32 (key tiles of the plan, three-pass TF32 products, the scale
and bias by one fused multiply-add, the online softmax with the row sum kept
per thread) against ``reference_attention`` within the float32 bound.

Kernel 2's float32 GEMM walks ``ops/ln_matmul.py:gemm_plan``'s tiles with the
weight rows of ``weight_rows`` (for GEGLU an h row and its gate row N/2
further in one tile): every output column is covered once, and the GEMM
written out tile by tile in three TF32 passes matches
``ln_matmul_reference`` within the float32 bound.
"""
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from divergen_tpu_torch.ops import attention_f32 as af
from divergen_tpu_torch.ops import flash_attention as tfa
from divergen_tpu_torch.ops import ln_matmul as lm
from divergen_tpu_torch.ops import tf32x3

torch.set_num_threads(1)

REL_L2_BOUND, MAX_ABS_BOUND = 1e-5, 1e-4  # chip_smoke.py: F32_BOUNDS
SMEM_LIMIT = 232448  # an H100 block's shared memory


def within(got, ref):
    diff = (got.double() - ref.double())
    rel = (diff.norm() / ref.double().norm()).item()
    mx = diff.abs().max().item() / ref.double().abs().max().item()
    return rel <= REL_L2_BOUND and mx <= MAX_ABS_BOUND, (rel, mx)


@pytest.mark.parametrize("d", af.F32_HEAD_DIMS)
@pytest.mark.parametrize("sq", [1, 15, 64, 144, 1000, 1031])
def test_every_output_element_is_stored_once(d, sq):
    plan = af.TC_PLANS[d]
    blocks, _, _ = af.grid(sq, 3, 2, d)
    seen = np.zeros((sq, d), dtype=np.int64)
    for block in range(blocks):
        for warp in range(plan.warps):
            rows = af.block_rows(block, warp, sq, d)
            for r in rows:
                seen[r, af.warp_channels(warp, d)] += 1
    assert (seen == 1).all()
    assert blocks == -(-sq // plan.rows)


@pytest.mark.parametrize("d", af.F32_HEAD_DIMS)
def test_channel_split_covers_the_head_dim(d):
    plan = af.TC_PLANS[d]
    chans = [af.warp_channels(c, d) for c in range(plan.warps_c)]
    assert sorted(ch for group in chans for ch in group) == list(range(d))
    assert all(len(group) % 8 == 0 for group in chans)  # whole 8-channel fragments
    if d == 512:
        assert plan.warps_c == 8 and all(len(group) == 64 for group in chans)


def test_pv_slots_are_a_bijection_in_accumulator_order():
    keys = [af.pv_slot_key(s) for s in range(8)]
    assert sorted(keys) == list(range(8))
    for t in range(4):  # lane t % 4 holds S columns 2t, 2t + 1; its A slots are t, t + 4
        assert (af.pv_slot_key(t), af.pv_slot_key(t + 4)) == (2 * t, 2 * t + 1)
    with pytest.raises(ValueError):
        af.pv_slot_key(8)


@pytest.mark.parametrize("d", af.F32_HEAD_DIMS)
def test_a_block_fits_the_shared_memory(d):
    plan = af.TC_PLANS[d]
    assert plan.smem(d) <= SMEM_LIMIT
    assert plan.keys % 8 == 0 and plan.stages >= 2  # a tile in flight behind the products
    if d != 512:  # d = 512 gives the third stage's room to Q
        assert plan.stages >= 3


def body(q, k, v, bias, d):
    """The forward as the body computes it for one (batch, head): q (Sq, d),
    k, v (Sk, d), bias (Sq, Sk) or None, in float32."""
    plan = af.TC_PLANS[d]
    sq, sk = q.shape[0], k.shape[0]
    scale = 1.0 / math.sqrt(d)
    m = torch.full((sq, 1), -1e30)
    part_l = torch.zeros((sq, 4))  # a quad's four threads' row sums
    o = torch.zeros((sq, d))
    for k0 in range(0, sk, plan.keys):
        kt, vt = k[k0:k0 + plan.keys], v[k0:k0 + plan.keys]
        s = torch.zeros((sq, kt.shape[0]))
        for group in range(plan.warps_c):  # the warps' shares of S, summed in order
            ch = af.warp_channels(group, d)
            s = s + tf32x3.matmul_3xtf32_reference(q[:, ch].contiguous(), kt[:, ch].T.contiguous())
        b = bias[:, k0:k0 + kt.shape[0]] if bias is not None else torch.zeros_like(s)
        s = torch.addcmul(b, s, torch.full_like(s, scale))  # fmaf per element
        m_new = torch.maximum(m, s.max(dim=1, keepdim=True).values)
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        cols = torch.arange(kt.shape[0])
        owner = (cols % 8) // 2  # the thread of the quad that holds each key
        part_l = part_l * alpha + torch.stack([p[:, owner == t].sum(1) for t in range(4)], 1)
        m = m_new
        o = o * alpha + tf32x3.matmul_3xtf32_reference(p, vt)
    l = part_l.sum(1, keepdim=True).clamp_min(1e-30)
    return o / l


@pytest.mark.parametrize("d,sq,sk,with_bias", [(64, 100, 77, True), (80, 70, 256, False),
                                               (32, 144, 144, True), (512, 40, 50, True)])
def test_body_arithmetic_matches_the_twin(d, sq, sk, with_bias):
    rng = np.random.default_rng(d + sq)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((sq, d), (sk, d), (sk, d)))
    bias = (torch.from_numpy(rng.standard_normal((sq, sk)).astype(np.float32))
            if with_bias else None)
    got = body(q, k, v, bias, d)
    ref = tfa.reference_attention(q[None], k[None], v[None],
                                  None if bias is None else bias[None])[0]
    ok, err = within(got, ref)
    assert ok, err


@pytest.mark.parametrize("m,n,geglu", [(4096, 10240, True), (16384, 5120, True),
                                       (16384, 3840, False), (16384, 5120, False),
                                       (1000, 3840, True), (200, 336, True)])
def test_gemm_plan_covers_every_output_column_once(m, n, geglu):
    plan = lm.gemm_plan(m, n, geglu, 132)
    cols = n // 2 if geglu else n
    seen = np.zeros(cols, dtype=np.int64)
    for u in range(plan.tiles_n):
        rows = lm.weight_rows(u, n, geglu)
        assert len(rows) == 2 * lm.WEIGHT_BOX
        if geglu:  # h row c and its gate row N/2 + c, 80 apart in the tile
            for i in range(lm.WEIGHT_BOX):
                h, gate = rows[i], rows[lm.WEIGHT_BOX + i]
                assert gate == (-1 if h == -1 or h + n // 2 >= n else h + n // 2)
                if 0 <= h < cols:
                    seen[h] += 1
        else:
            for r in rows:
                if r >= 0:
                    seen[r] += 1
    assert (seen == 1).all()


def gemm_by_tiles(x, wt, gamma, beta, eps, bias, geglu, act):
    """The float32 GEMM as the body walks it: the apply pass's y and the
    weight in their TF32 parts, each 128-row tile of y against the weight
    rows of its column tile, three passes, then the epilogue."""
    m, _ = x.shape
    n = wt.shape[0]
    y = lm.ln_apply_reference(x, gamma, beta, eps)
    plan = lm.gemm_plan(m, n, geglu, 7)
    cols = n // 2 if geglu else n
    out = torch.full((m, cols), float("nan"))
    for block in range(plan.blocks):
        for ti, u in plan.tiles(block):
            rows = lm.weight_rows(u, n, geglu)
            w = torch.stack([wt[r] if r >= 0 else torch.zeros(wt.shape[1]) for r in rows])
            bt = torch.tensor([bias[r] if (r >= 0 and bias is not None) else 0.0 for r in rows])
            r0 = ti * lm.GEMM_BM
            acc = tf32x3.matmul_3xtf32_reference(y[r0:r0 + lm.GEMM_BM], w.T.contiguous()) + bt
            if geglu:
                val = acc[:, :lm.WEIGHT_BOX] * F.gelu(acc[:, lm.WEIGHT_BOX:])
                c0 = u * lm.WEIGHT_BOX
            else:
                val = F.gelu(acc) if act == "gelu" else acc
                c0 = u * 2 * lm.WEIGHT_BOX
            width = min(val.shape[1], cols - c0)
            out[r0:r0 + lm.GEMM_BM, c0:c0 + width] = val[:, :width]
    return out


@pytest.mark.parametrize("m,k,n,geglu,act", [(300, 64, 352, True, "none"),
                                              (130, 96, 336, False, "gelu"),
                                              (257, 40, 160, False, "none")])
def test_gemm_by_tiles_matches_the_twin(m, k, n, geglu, act):
    rng = np.random.default_rng(m + n)
    f = lambda *s, sc=1.0: torch.from_numpy((rng.standard_normal(s) * sc).astype(np.float32))
    x, wt = f(m, k, sc=2.0), f(n, k, sc=k ** -0.5)
    gamma, beta, bias = 1.0 + 0.1 * f(k), 0.1 * f(k), 0.1 * f(n)
    got = gemm_by_tiles(x, wt, gamma, beta, 1e-5, bias, geglu, act)
    assert not got.isnan().any()
    ref = lm.ln_matmul_reference(x, wt.T, gamma, beta, 1e-5, bias, geglu, act)
    ok, err = within(got, ref)
    assert ok, err
