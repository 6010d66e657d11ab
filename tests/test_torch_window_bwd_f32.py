"""The float32 window-attention backward body's plan, layout and arithmetic.

``csrc/attention_f32.cu:window_bwd_tc_kernel<NT, D>`` (kernels 5 and 6 on
float32, head dims 32 and 64) runs its five products on the TF32 tensor cores
in three passes. Held here on the CPU, as pure functions of
``ops/window_attention.py`` (``chip_smoke.py`` holds the library's
``dg_window_attention_bwd_f32_smem`` / ``_resident`` against them on the
card): the grid (``f32_backward_plan``) covers every (head, window) once in
chunks of consecutive windows, with partial bias gradients only when a head
has more than one chunk; the shared memory (``f32_backward_layout``) fits a
block's 227 KB with its regions apart, the bias-gradient sum in it where it
fits and else in registers that cover the tile; the operands' swizzle
permutes each row's 4-float chunks and makes the fragment reads the body
takes free of bank conflicts. Then the five products written out with
``tf32x3.matmul_3xtf32_reference`` and the body's split
(``tf32x3.split_tf32_fast``: big rounded, small truncated by the tensor
core, within 2⁻²¹ of x) (S and dp over the channels in one
accumulator; dv, dq and dk over 144 rows in fresh accumulators of 48 added
in float32, as the body) against the float64 backward at n = 144, d = 32 and
64, within ``chip_smoke.py``'s ``F32_BOUNDS``.
"""
import math

import numpy as np
import pytest
import torch

from divergen_tpu_torch.ops import tf32x3
from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)

REL_L2_BOUND, MAX_ABS_BOUND = 1e-5, 1e-4  # chip_smoke.py: F32_BOUNDS
SMEM_LIMIT = 232448  # an H100 block's shared memory
FAST = tf32x3.split_tf32_fast
SHAPES = [(722, 6), (200, 12), (50, 24), (18, 48), (8, 3), (1, 1), (3, 200)]


def props(sms):
    class Props:
        multi_processor_count = sms
    return lambda device: Props


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,heads", SHAPES, ids=[f"{b}x{h}" for b, h in SHAPES])
def test_plan_covers_every_head_and_window_once(monkeypatch, batch, heads, sms, d):
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(sms))
    for n in (144, 49):
        plan = twa.f32_backward_plan(batch, heads, n, d, torch.device("cpu"))
        seen = np.zeros((heads, batch), dtype=int)
        for block in range(plan.chunks * heads):
            h, c = block % heads, block // heads
            windows = range(c * plan.per_chunk, min(batch, (c + 1) * plan.per_chunk))
            assert len(windows) >= 1, f"block {block} has no window"
            seen[h, windows.start:windows.stop] += 1
        assert (seen == 1).all()
        slots = sms * twa.f32_backward_resident(n, d)
        assert plan.chunks * heads <= max(slots, heads)
        assert plan.scratch == ((plan.chunks if plan.chunks > 1 else 0), heads, n, n)


def test_plan_at_the_swin_l_stages_on_an_h100(monkeypatch):
    """One block a multiprocessor at n = 144: 132, 132, 120 and 96 blocks."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(132))
    got = [tuple(twa.f32_backward_plan(b, h, 144, 32, torch.device("cpu"))[:2])
           for b, h in SHAPES[:4]]
    assert got == [(22, 33), (11, 19), (5, 10), (2, 9)]
    assert twa.f32_backward_resident(144, 32) == twa.f32_backward_resident(144, 64) == 1
    assert twa.f32_backward_resident(49, 32) == 3


@pytest.mark.parametrize("d", [32, 64])
def test_layout_fits_and_its_regions_are_apart(d):
    for n in range(1, twa.KERNEL_MAX_TOKENS + 1):
        lay = twa.f32_backward_layout(n, d)
        rows, ld, off = lay["rows"], lay["ld"], lay["offsets"]
        assert rows >= n and rows % 16 == 0 and ld % 32 in (8, 24)
        assert lay["bytes"] <= SMEM_LIMIT
        assert lay["swap"] == (n > 112)
        assert lay["sum_smem"] == (d == 32 or n <= 112)
        spans = sorted({(off[k], off[k] + rows * d) for k in ("q", "k", "do", "v")})
        spans.append((off["tile"], off["tile"] + rows * ld))
        if lay["sum_smem"]:
            spans.append((off["sum"], off["sum"] + rows * rows))
        assert len(spans) == 3 + (not lay["swap"]) + 1 + lay["sum_smem"]
        for (_, end), (start, _) in zip(spans, spans[1:]):
            assert end <= start
        assert spans[-1][1] * 4 == lay["bytes"] == twa.f32_backward_smem(n, d)
        assert (off["v"] == off["q"]) == lay["swap"]
        warps = lay["warps"]
        assert warps == (12 if not lay["sum_smem"] and rows == 144 else rows // 16)
        if not lay["sum_smem"]:  # the sum in registers covers the tile
            assert lay["acc"] * 32 * warps >= rows * rows
    assert twa.f32_backward_layout(144, 64)["acc"] == 54  # twelve warps, not nine (72)
    assert twa.f32_backward_layout(144, 32)["warps"] == 9
    with pytest.raises(ValueError):
        twa.f32_backward_layout(145, 32)
    with pytest.raises(ValueError):
        twa.f32_backward_layout(49, 48)


def banks(addrs):
    """The largest number of distinct 4-byte words one bank serves in one
    access of these float offsets (1: no conflict)."""
    per = {}
    for a in set(addrs):
        per.setdefault(a % 32, set()).add(a)
    return max(len(v) for v in per.values())


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("rows_t", [False, True], ids=["k_v", "q_do"])
def test_swizzle_permutes_chunks_and_its_reads_are_conflict_free(d, rows_t):
    sw = lambda r, c: twa.f32_backward_swizzle(r, c, d, rows_t)
    for r in range(16):
        offs = [sw(r, c) for c in range(d)]
        assert sorted(offs) == list(range(r * d, (r + 1) * d))
        assert all(sw(r, c) + e == sw(r, c + e) for c in range(0, d, 4) for e in range(4))
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    for base in (0, 8, 136):
        for c0 in range(0, d, 8):
            # (rows g, columns t): S's and dp's fragments, both operands
            for dc in (0, 4):
                assert banks([sw(base + g, c0 + t + dc) for g, t in lanes]) == 1
            if rows_t:  # (rows t, t + 4, columns g): dv's and dk's B (do, q)
                for dr in (0, 4):
                    assert banks([sw(base + t + dr, c0 + g) for g, t in lanes]) == 1
            else:  # (rows 2t, 2t + 1, columns g): dq's B, keys in pv_slot_key order (k)
                for dr in (0, 1):
                    assert banks([sw(base + 2 * t + dr, c0 + g) for g, t in lanes]) == 1


@pytest.mark.parametrize("n", [144, 49])
def test_tile_fragment_reads_are_conflict_free(n):
    ld = twa.f32_backward_layout(n, 32)["ld"]
    lanes = [(lane >> 2, lane & 3) for lane in range(32)]
    # P^T / ds^T A fragments (rows t, t + 4, columns g), one float a lane
    for dr in (0, 4):
        assert banks([(8 + t + dr) * ld + 16 + g for g, t in lanes]) == 1
    # P and ds by rows (rows g, columns 2t, 2t + 1): 8-byte accesses, half a warp at a time
    for half in (lanes[:16], lanes[16:]):
        assert banks([(g * ld + 2 * t + e) for g, t in half for e in (0, 1)]) == 1


def grouped(a, b, group=48):
    """a @ b over the inner dim in fresh accumulators of ``group`` rows, each
    in three TF32 passes, added in float32."""
    out = torch.zeros(a.shape[0], b.shape[1])
    for k0 in range(0, a.shape[1], group):
        out = out + tf32x3.matmul_3xtf32_reference(a[:, k0:k0 + group].contiguous(),
                                                   b[k0:k0 + group].contiguous(), FAST)
    return out


def body_backward(q, k, v, do, bias, scale):
    """One window and head as the body computes it, in float32."""
    mm = lambda a, b: tf32x3.matmul_3xtf32_reference(a, b, FAST)
    s = torch.addcmul(bias, mm(q, k.T.contiguous()), torch.full_like(bias, scale))
    p = torch.exp(s - s.max(dim=1, keepdim=True).values)
    p = p * (1.0 / p.sum(dim=1, keepdim=True))
    dv = grouped(p.T.contiguous(), do)
    dp = mm(do, v.T.contiguous())
    ds = p * (dp - (p * dp).sum(dim=1, keepdim=True))
    dq = grouped(ds, k) * scale
    dk = grouped(ds.T.contiguous(), q) * scale
    return dq, dk, dv, ds


def float64_backward(q, k, v, do, bias, scale):
    q, k, v, do, bias = (t.double() for t in (q, k, v, do, bias))
    p = torch.softmax(q @ k.T * scale + bias, dim=1)
    dp = do @ v.T
    ds = p * (dp - (p * dp).sum(dim=1, keepdim=True))
    return ds @ k * scale, ds.T @ q * scale, p.T @ do, ds


@pytest.mark.parametrize("d", [32, 64])
def test_the_five_products_in_three_tf32_passes_are_float32(d):
    n = 144
    rng = np.random.default_rng(d)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
                   for _ in range(4))
    bias = torch.from_numpy((rng.standard_normal((n, n)) * 0.5).astype(np.float32))
    bias = bias + torch.where(torch.from_numpy(rng.random((n, n))) < 0.3, -100.0, 0.0)
    scale = 1.0 / math.sqrt(d)
    for name, got, ref in zip(("dq", "dk", "dv", "ds"), body_backward(q, k, v, do, bias, scale),
                              float64_backward(q, k, v, do, bias, scale)):
        diff = got.double() - ref
        rel = (diff.norm() / ref.norm()).item()
        mx = diff.abs().max().item() / ref.abs().max().item()
        assert rel <= REL_L2_BOUND and mx <= MAX_ABS_BOUND, (name, rel, mx)


def test_the_fast_split_is_within_2_to_the_minus_21():
    """big + small as the tensor core reads them against x: within 2⁻²¹ |x|
    (small = x - big is exact and at most half a TF32 unit of x; truncating
    it drops less than a TF32 unit of itself), where one TF32 pass is off by
    up to 2⁻¹¹."""
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(1 << 16).astype(np.float32))
    x = torch.cat([x, x * 1e-30, x * 1e30])
    big, small = tf32x3.split_tf32_fast(x)
    err = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max().item()
    assert err <= 2.0 ** -21
    assert torch.equal(big, tf32x3.round_tf32(x))
    assert ((tf32x3.round_tf32(x).double() - x.double()).abs() / x.double().abs()).max() > 2.0 ** -13
