"""The bf16 window-attention forward's grid plan, key order and arithmetic.

``forward_plan`` chunks the windows of each head for the bf16 forward body
(``csrc/window_attention.cu:window_attn_fwd_kernel``): block ``i`` takes head
``i % heads`` and the windows of chunk ``i // heads``, in window order
(``forward_walk``). Held here on the CPU with the card's multiprocessor count
monkeypatched (132 as on an H100, and 7): every (head, window) is covered
once, each block's windows are a run in window order, and the grid is one
wave of the blocks the shared memory leaves resident at Swin-L's stages.
Then the body's key order within 16-key slabs (``slot_key``, mirrored here):
a thread's four score slots are four consecutive keys, and each 8 x 8
ldmatrix reads rows on distinct banks. Then the body's arithmetic, written out
in float32 (the head's bias scaled to units of q·kᵀ with keys past n at
-1e30, the mask added by a fused multiply-add, the base-2 softmax, p
normalized and rounded to bfloat16), against ``reference_window_attention``
on the same bfloat16 inputs, within the bound ``chip_smoke.py`` holds the
kernel to.
"""
import math

import numpy as np
import pytest
import torch

from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)

# (windows, heads) of Swin-L's four stages at B = 2, 896², then ragged grids
SHAPES = [(722, 6), (200, 12), (50, 24), (18, 48), (8, 3), (1, 1), (3, 200), (37, 5)]


def props(sms):
    class Props:
        multi_processor_count = sms
    return lambda device: Props


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("n", [144, 49])
@pytest.mark.parametrize("batch,heads", SHAPES, ids=[f"{b}x{h}" for b, h in SHAPES])
def test_plan_covers_every_head_and_window_once_in_window_order(monkeypatch, sms, n, batch,
                                                                heads):
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(sms))
    plan = twa.forward_plan(batch, heads, n, torch.device("cpu"))
    seen = np.zeros((heads, batch), dtype=int)
    order = {h: [] for h in range(heads)}
    for block, head, windows in twa.forward_walk(plan, batch, heads):
        assert windows, f"block {block} has no window"
        assert windows == list(range(windows[0], windows[0] + len(windows)))
        assert len(windows) <= plan.per_chunk
        seen[head, windows] += 1
        order[head] += windows
    assert (seen == 1).all()
    assert all(order[h] == list(range(batch)) for h in range(heads))  # chunk after chunk
    assert plan.chunks == -(-batch // plan.per_chunk)


def test_plan_at_the_swin_l_stages_on_an_h100(monkeypatch):
    """The grids of a Swin-L forward at B = 2, 896²: one wave of one block an
    SM (132, 132, 120 and 96 blocks), the windows of a head split evenly."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(132))
    got = [tuple(twa.forward_plan(b, h, 144, torch.device("cpu"))) for b, h in SHAPES[:4]]
    assert got == [(22, 33), (11, 19), (5, 10), (2, 9)]
    assert all(c * h <= 132 for (c, _), (_, h) in zip(got, SHAPES))


def test_plan_depends_on_the_shapes_and_the_sm_count_only(monkeypatch):
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(132))
    a = twa.forward_plan(722, 6, 144, torch.device("cpu"))
    assert twa.forward_plan(722, 6, 144, torch.device("cpu")) == a
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(7))
    assert twa.forward_plan(722, 6, 144, torch.device("cpu")) != a  # 7 SMs: another grid


@pytest.mark.parametrize("n,resident", [(144, 1), (100, 1), (49, 3), (32, 9), (16, 23)])
def test_plan_fills_the_blocks_the_shared_memory_leaves(monkeypatch, n, resident):
    """Smaller windows take less shared memory, so more blocks are resident
    on a multiprocessor, and the plan cuts as many chunks as fill them."""
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(132))
    assert twa.forward_resident(n) == resident
    chunks = 132 * resident // 6
    plan = twa.forward_plan(10 * chunks, 6, n, torch.device("cpu"))
    assert plan == (chunks, 10)


def test_forward_smem_is_the_kernels_layout():
    """q, k and v of two windows (64-byte TMA rows), the bias tile in f32 at a
    row stride of 16 (mod 32) floats, one window's mask, four mbarriers and
    512 bytes of alignment; within the 227 KB a block may take."""
    assert twa.forward_smem(144) == 6 * 144 * 64 + 144 * 144 * 4 * 2 + 32 + 512 == 221728
    assert twa.forward_smem(64) == twa.forward_smem(49) == 6 * 64 * 64 + 64 * 80 * 4 + 64 * 64 * 4 + 544
    assert twa.forward_smem(1) == twa.forward_smem(16)
    assert max(twa.forward_smem(n) for n in range(1, 145)) <= 232448


def slot_key(c):
    """``csrc/window_attention.cu:slot_key``: the key of accumulator slot c of
    a 16-key slab."""
    t = (c & 7) >> 1
    return 4 * t + (c & 1) + 2 * ((t >> 1) ^ (c >> 3))


def test_key_order_gives_each_thread_four_consecutive_keys():
    keys = [slot_key(c) for c in range(16)]
    assert sorted(keys) == list(range(16))
    for t in range(4):  # slots 2t, 2t + 1 (first n8 block) and 8 + 2t, 9 + 2t (second)
        mine = [slot_key(c) for c in (2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t)]
        assert sorted(mine) == list(range(4 * t, 4 * t + 4))
        # the first two are the float4's first or last pair: swapped for t >= 2
        assert mine[:2] == ([4 * t, 4 * t + 1] if t < 2 else [4 * t + 2, 4 * t + 3])
    # under the 64-byte swizzle a row's 16-byte unit in a 128-byte line is
    # 4 (r & 1) + (chunk ^ ((r >> 1) & 3)): distinct for the 8 rows of each matrix
    for half in (range(8), range(8, 16)):
        for chunk in range(4):
            units = {4 * (slot_key(c) & 1) + (chunk ^ ((slot_key(c) >> 1) & 3)) for c in half}
            assert len(units) == 8


def emulate(q, k, v, bias, mask):
    """The forward body's arithmetic in float32 on (B, H, n, 32) bf16 q, k, v:
    the keys padded to 16 NT, whose bias is -1e30; the fused multiply-adds
    taken exactly and rounded once (float64, then float32)."""
    b, h, n, d = q.shape
    npad = 16 * twa._bwd_tiles(n)
    scale = np.float32(1.0 / math.sqrt(d))
    inv = np.float32(1.0) / scale
    scale_log2 = scale * np.float32(math.log2(math.e))
    tile = torch.full((h, npad, npad), -1e30)
    tile[:, :, :n] = 0.0
    tile[:, :n, :n] = bias.float() * float(inv)
    s = tile[None].expand(b, h, npad, npad).clone()
    if mask is not None:
        nw = mask.shape[0]
        m = torch.zeros((nw, npad, npad), dtype=torch.float64)
        m[:, :n, :n] = mask.double()
        m = m.repeat(b // nw, 1, 1)[:, None]
        s = (m * float(inv) + s.double()).float()
    pad = lambda t: torch.nn.functional.pad(t.float(), (0, 0, 0, npad - n))
    s = s + pad(q) @ pad(k).transpose(-1, -2)
    off = s.max(-1, keepdim=True).values * scale_log2
    p = torch.exp2((s.double() * float(scale_log2) - off.double()).float())
    p = p * (1.0 / p.sum(-1, keepdim=True))
    return (p.bfloat16().float() @ pad(v))[..., :n, :].bfloat16()


@pytest.mark.parametrize("n", [144, 49, 4])
@pytest.mark.parametrize("with_mask", [True, False])
def test_the_bodys_arithmetic_holds_the_plain_version(n, with_mask):
    rng = np.random.RandomState(n)
    bsz, h = 4, 2
    q, k, v = (torch.from_numpy(rng.randn(bsz, h, n, 32).astype(np.float32)).bfloat16()
               for _ in range(3))
    bias = torch.from_numpy((rng.randn(h, n, n) * 0.5).astype(np.float32))
    mask = None
    if with_mask:
        mask = torch.from_numpy(rng.choice([0.0, -100.0], size=(2, n, n), p=[0.7, 0.3])
                                .astype(np.float32))
        mask[:, range(n), range(n)] = 0.0
    got = emulate(q, k, v, bias, mask).float()
    ref = twa.reference_window_attention(q, k, v, bias, mask).float()
    assert torch.isfinite(got).all()
    rel = ((got - ref).norm() / ref.norm()).item()
    assert rel <= 1e-2 and (got - ref).abs().max() <= 3e-2 * ref.abs().max(), rel
