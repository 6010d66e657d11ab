"""The bf16 relative-position attention body's plan, mirrored on the CPU.

``csrc/flash_attention_relpos_sm90.cu`` walks (q tile, head, batch) work
items with a persistent grid of at most one block an SM, reads each head's
80 channels as two TMA boxes (channels 0-63 under the 128-byte swizzle,
64-79 under the 32-byte one) through rank-5 maps whose dimensions are
ordered by stride, and starts each score tile's accumulator from the bias.
On the register path (W <= 64) a K tile is whole grid rows of W' slots (W
rounded up to 8, 16, 32 or 64; the slots past W are empty), Bw stays in
registers for the item and Bh of the tile's grid rows is loaded a tile
ahead; on the general path (W > 64) a K tile is 128 consecutive keys, each
key's (u, v) found by division. This file mirrors that plan in Python
(``walk``, ``slot_width``, ``map_dims``, ``fragment_start``) and holds it,
with the card's multiprocessor count monkeypatched (132 as on an H100, and
7): every item is covered once, the boxes cover each head's channels once at
a fused projection's offsets and each key once, the shared memory of
``ops/flash_attention.py:relpos_smem`` (which ``chip_smoke.py`` holds against
the library) fits a block, every grid the mma.sync body took is still taken,
and the values the fragment mapping starts from equal the dense bias of
``reference_attention_relpos`` (bit for bit: the same two float32 addends)
on both paths.
"""
import itertools

import numpy as np
import pytest
import torch

from divergen_tpu_torch.ops import flash_attention as tfa

torch.set_num_threads(1)

D, ROWS, BK = tfa.RELPOS_HEAD_DIM, tfa.RELPOS_TILE, tfa.RELPOS_BK
PARTS = ((0, 64), (64, 16))  # (first channel, width) of a row's two boxes
SLOT_WIDTHS = (8, 16, 32, 64)
MAX_TOKENS = 2 ** 31 - 1  # the C entry's limit: 32-bit row indices


def walk(batch, heads, n, sms):
    """(block, (q tile, head, batch)) as the blocks take the work items: at
    most one block an SM, q tiles fastest, block i taking items i, i + blocks..."""
    tiles = -(-n // ROWS)
    items = tiles * heads * batch
    blocks = min(items, sms)
    for block in range(blocks):
        for w in range(block, items, blocks):
            yield block, (w % tiles, (w // tiles) % heads, w // (tiles * heads))


def slot_width(w):
    """W': the slots a grid row of width w takes in a K tile of the register
    path, or 0 for the general path (W > 64)."""
    return next((slots for slots in SLOT_WIDTHS if w <= slots), 0)


def map_dims(ext_v, ext_u, heads, batch, strides, boxes):
    """The body's rank-5 map (``relpos_map``): rows split into ext_u runs of
    ext_v, then heads and batch, ordered by element stride, those of extent 1
    and box 1 last with a packed tensor's stride. Returns the dimensions
    after the channels, their element strides and boxes, and the map
    dimension of v, u, the head and the batch. ``strides``: the (batch, head,
    row) element strides."""
    bs, hs, rs = strides
    ext, st, box = (ext_v, ext_u, heads, batch), (rs, rs * ext_v, hs, bs), (*boxes, 1, 1)
    last = [ext[i] == 1 and box[i] == 1 for i in range(4)]
    order = sorted(range(4), key=lambda i: (last[i], st[i]))
    dims, map_strides, map_boxes, at, packed = [], [], [], [0] * 4, D
    for i, o in enumerate(order):
        dims.append(ext[o])
        map_strides.append(packed if last[o] else st[o])
        map_boxes.append(box[o])
        packed = map_strides[-1] * ext[o]
        at[o] = i + 1
    return tuple(dims), tuple(map_strides), tuple(map_boxes), tuple(at)


def fragment_start(bias_h_t, bias_w_t, hw, slot_w=None):
    """The body's ``RelposBias`` over the wgmma fragment (thread t of consumer
    c holds rows 64 c + 16 (t / 32) + (t % 32) / 4 + {0, 8} of the item and
    slots 8 j + 2 (t % 4) + {0, 1}, j < BK / 8, of each K tile), before the
    sqrt(d) multiplier. Returns the start, (BH, q tiles · ROWS, K tiles ·
    BK), and the key each slot holds (-1 for none). ``slot_w``: the register
    path's W' (default ``slot_width``; 0: the general path). On the register
    path slot 8 j + 2 t4 + x of tile t is grid column v = 8 (j mod M) + 2 t4 +
    x, M = W' / 8, of grid row t G + j // M, G = BK / W', with Bw -1e30 at
    v >= W and Bh -1e30 at u >= H; on the general path slot s of tile t is
    key t BK + s, its (u, v) found by division and stepped to its neighbour."""
    h, w = hw
    n = h * w
    slot_w = slot_width(w) if slot_w is None else slot_w
    grid_rows = BK // slot_w if slot_w else 0
    q_tiles = -(-n // ROWS)
    k_tiles = -(-h // grid_rows) if slot_w else -(-n // BK)
    neg = torch.tensor(-1e30)
    qt, c, warp, g, r = torch.meshgrid(*(torch.arange(e) for e in (q_tiles, ROWS // 64, 4, 8, 2)),
                                       indexing="ij")
    row = (qt * ROWS + 64 * c + 16 * warp + g + 8 * r).reshape(-1)
    t, j, t4, x = torch.meshgrid(*(torch.arange(e) for e in (k_tiles, BK // 8, 4, 2)),
                                 indexing="ij")
    slot = (t * BK + 8 * j + 2 * t4 + x).reshape(-1)
    if slot_w:
        m = slot_w // 8
        u = (grid_rows * t + j // m).reshape(-1)
        v = (8 * (j % m) + 2 * t4 + x).reshape(-1)
        u_ok, v_ok = u < h, v < w
    else:
        key0 = (t * BK + 8 * j + 2 * t4).reshape(-1)
        u, v = key0 // w, key0 % w
        step = x.reshape(-1) == 1
        v = torch.where(step, v + 1, v)
        u = torch.where(step & (v == w), u + 1, u)
        v = torch.where(v == w, 0, v)
        u_ok = v_ok = slot < n
    row_ok = row < n
    rows = row.clamp(max=n - 1)[:, None]
    fh = torch.where(row_ok[:, None], bias_h_t[:, u.clamp(max=h - 1)[None, :], rows], 0.0)
    fw = torch.where(row_ok[:, None], bias_w_t[:, v.clamp(max=w - 1)[None, :], rows], 0.0)
    if slot_w:  # each factor masks its own slots
        start = torch.where(u_ok, fh, neg) + torch.where(v_ok, fw, neg)
    else:
        start = torch.where(u_ok, fh + fw, neg)
    out = torch.empty_like(start)
    out[:, row[:, None], slot[None, :]] = start
    keys = torch.empty_like(slot)
    keys[slot] = torch.where(u_ok & v_ok, u * w + v, -1)
    return out, keys


# (batch, heads, H, W): SAM ViT-H's global layers at B = 4 and 1, 64 heads,
# a ragged grid smaller than one q tile, a grid of two half tiles, an odd H
SHAPES = [(4, 16, 64, 64), (1, 16, 64, 64), (1, 64, 64, 64), (2, 3, 5, 7), (1, 2, 8, 16),
          (3, 5, 3, 64)]


# the (batch, head, row) element strides, the slot offsets (q, k, v), the
# heads and the batch of the layouts the wrapper passes: heads-first views of
# a fused (B, N, 3, heads, 80) projection, and contiguous (BH, N, 80)
def fused_layout(batch, heads, n):
    c = heads * D
    return (n * 3 * c, D, 3 * c), [s * c for s in range(3)], heads, batch


def bhsd_layout(batch, heads, n):
    return (n * D, 0, D), [0, 0, 0], 1, batch * heads


def props(sms):
    class Props:
        multi_processor_count = sms
    return lambda device: Props


@pytest.mark.parametrize("sms", [132, 7])
@pytest.mark.parametrize("batch,heads,h,w", SHAPES, ids=[f"{b}x{hd}x{h}x{w}" for b, hd, h, w
                                                          in SHAPES])
def test_plan_covers_every_item_once(monkeypatch, sms, batch, heads, h, w):
    monkeypatch.setattr(torch.cuda, "get_device_properties", props(sms))
    sms = torch.cuda.get_device_properties(None).multi_processor_count
    n = h * w
    tiles = -(-n // ROWS)
    seen = np.zeros((tiles, heads, batch), dtype=int)
    blocks = set()
    for block, (t, hh, b) in walk(batch, heads, n, sms):
        seen[t, hh, b] += 1
        blocks.add(block)
    assert (seen == 1).all()
    assert blocks == set(range(min(sms, tiles * heads * batch)))  # every block has an item


@pytest.mark.parametrize("layout", [fused_layout, bhsd_layout])
@pytest.mark.parametrize("batch,heads,h,w", SHAPES[:4] + [(1, 2, 12, 1), (2, 2, 1, 40)],
                         ids=[f"{b}x{hd}x{h}x{w}" for b, hd, h, w in SHAPES[:4]]
                         + ["1x2x12x1", "2x2x1x40"])
def test_boxes_cover_each_heads_channels_and_keys_once(layout, batch, heads, h, w):
    """The two boxes of a row cover channels 0-79 of every head exactly once,
    at the fused projection's offsets s·C + h·80 of slot s (q, k, v); the maps'
    strides suit TMA (multiples of 16 bytes); a Q box is RELPOS_TILE rows; on
    the register path a K tile's boxes hold its G grid rows u-major (v's map
    dimension before u's, so that slot u·W' + v is grid column v of row u),
    and the tiles together hold every key once."""
    n = h * w
    strides, slots, map_heads, map_batch = layout(batch, heads, n)
    slot_w = slot_width(w)
    grid_rows = BK // slot_w if slot_w else 0
    q_map = map_dims(n, 1, map_heads, map_batch, strides, (ROWS, 1))
    kv_map = (map_dims(w, h, map_heads, map_batch, strides, (slot_w, grid_rows)) if slot_w
              else map_dims(n, 1, map_heads, map_batch, strides, (BK, 1)))
    assert [2 * width for _, width in PARTS] == [128, 32]  # the two swizzles
    for dims, map_strides, boxes, at in (q_map, kv_map):
        assert len(dims) == 4 and sorted(at) == [1, 2, 3, 4]
        assert all(st * 2 % 16 == 0 for st in map_strides)
        assert all(box <= 256 for box in boxes)
        for slot, b, hh in itertools.product(slots, range(map_batch), range(map_heads)):
            origin = slot + sum(c * map_strides[at[k] - 1]
                                for k, c in enumerate((0, 0, hh, b)))
            covered = [origin + c0 + c for c0, width in PARTS for c in range(width)]
            start = slot + b * strides[0] + hh * strides[1]
            assert sorted(covered) == list(range(start, start + D))
    assert q_map[2][q_map[3][0] - 1] == ROWS
    dims, map_strides, boxes, at = kv_map
    rs = strides[2]
    if slot_w:
        assert at[0] < at[1]  # v before u: the box lands u-major
        k_tiles = -(-h // grid_rows)
        rows = [(t * grid_rows + ul) * w + v for t in range(k_tiles) for ul in range(grid_rows)
                for v in range(slot_w) if v < w and t * grid_rows + ul < h]
        # each slot at v rs + u (W rs): the grid row's keys are rows u W + v
        assert map_strides[at[0] - 1] == rs and (h == 1 or map_strides[at[1] - 1] == w * rs)
    else:
        rows = list(range(n))
    assert sorted(rows) == list(range(n))


def test_shared_memory_fits_a_block():
    """Two Q buffers and a 4-stage K/V ring of 128 rows of 160 bytes, and
    1024 bytes to align them, within the 232,448 bytes a block may take."""
    assert tfa.relpos_smem() == 2 * 128 * 160 + 2 * 4 * 128 * 160 + 1024 == 205824
    assert tfa.relpos_smem() <= 232448


def test_every_grid_the_mma_sync_body_took_is_taken():
    """The mma.sync body kept both factor slabs of its q tile in shared memory
    and took H + W <= 647; the new body keeps none, and its C entry takes any
    grid whose tokens fit 32-bit row indices."""
    old_limit = (232448 - 5 * 64 * (80 + 8) * 2) // ((64 + 4) * 4)
    assert old_limit == 647
    assert max(h * (old_limit - h) for h in range(1, old_limit)) <= MAX_TOKENS


def factors(bh, h, w, seed):
    rng = np.random.RandomState(seed)
    n = h * w
    return (torch.from_numpy(rng.randn(bh, h, n).astype(np.float32)),
            torch.from_numpy(rng.randn(bh, w, n).astype(np.float32)))


@pytest.mark.parametrize("hw,slot_w", [((64, 64), None), ((64, 64), 0), ((3, 64), None),
                                       ((3, 64), 0), ((5, 7), None), ((5, 7), 0),
                                       ((8, 16), None), ((8, 16), 0), ((16, 32), None),
                                       ((9, 8), None), ((12, 1), None), ((4, 48), None),
                                       ((4, 48), 0), ((3, 100), None)])
def test_fragment_start_is_the_dense_bias(hw, slot_w):
    """Every key sits in one slot, whose start is the bias
    ``reference_attention_relpos`` adds, bit for bit, on the register path
    (default W' for W <= 64) and the general one (slot_w 0, and W > 64);
    empty slots start at -1e30 or below, rows past N at 0."""
    h, w = hw
    n = h * w
    bh_t, bw_t = factors(2 if n < 4096 else 1, h, w, seed=n)
    start, keys = fragment_start(bh_t, bw_t, hw, slot_w)
    rows = -(-n // ROWS) * ROWS
    assert start.shape == (bh_t.shape[0], rows, keys.numel())
    assert keys.numel() % BK == 0
    filled = keys >= 0
    assert sorted(keys[filled].tolist()) == list(range(n))
    dense = tfa.relpos_dense_bias(bh_t, bw_t)
    assert torch.equal(start[:, :n][:, :, filled], dense[:, :, keys[filled]])
    assert (start[:, :, ~filled] <= -1e30).all()
    assert (start[:, n:][:, :, filled] == 0).all()


@pytest.mark.parametrize("w,slots", [(1, 8), (7, 8), (8, 8), (9, 16), (16, 16), (17, 32),
                                     (32, 32), (33, 64), (48, 64), (64, 64), (65, 0), (128, 0)])
def test_slot_width(w, slots):
    """The C entry's choice of path: the register path's W' for W <= 64."""
    assert slot_width(w) == slots


def test_dense_bias_is_the_definition():
    """``relpos_dense_bias`` (the bias ``reference_attention_relpos`` adds,
    which ``test_torch_relpos.py`` holds against the JAX package) is
    ``bias[b, q, u·W + v] = Bh[b, u, q] + Bw[b, v, q]``, element by element."""
    bh, h, w = 2, 3, 5
    bh_t, bw_t = factors(bh, h, w, seed=9)
    got = tfa.relpos_dense_bias(bh_t, bw_t)
    for b, q, u, v in itertools.product(range(bh), range(h * w), range(h), range(w)):
        assert got[b, q, u * w + v] == bh_t[b, u, q] + bw_t[b, v, q]
