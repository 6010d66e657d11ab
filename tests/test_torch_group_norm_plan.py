"""The GroupNorm kernel's plan and the order of its sums (kernel 7).

``ops/group_norm.py:norm_plan`` gives both passes of ``csrc/group_norm.cu``
their grid: block (ct, s, b) takes channel tile ct of position range s of
image b, its threads ``tile_vecs · rows`` with thread t on channel vector
``t % tile_vecs`` and positions ``t // tile_vecs``, ``+ rows``, … (the apply
pass walks them from the last). Held here on the CPU, with no device to ask:
the plan is a function of the shapes alone (so the order of every sum is
fixed and two runs give the same bits), both walks cover every (image,
position, channel vector) once, and ``combine_slices``, the order in which an
apply block adds its image's partials, takes each once. Then the kernel's
sums written out in float32 in that order against the plain version's
statistics, and ``UNET_GROUP_NORMS`` against a full-width int8 + fused-norm
UNet built on the meta device.
"""
import math

import numpy as np
import pytest
import torch

from divergen_tpu_torch.ops import group_norm as tgn
from divergen_tpu_torch.pipeline.generation import unet as tunet

torch.set_num_threads(1)

SHAPES = [k[:4] for k in tgn.UNET_GROUP_NORMS] + [(2, 5, 7, 96), (2, 9, 11, 36), (2, 16, 16, 7680),
                                                  (1, 1, 1, 8), (3, 2, 3, 1000), (1, 4, 4, 33)]


def no_device(*_, **__):
    raise AssertionError("norm_plan asked a device")


@pytest.mark.parametrize("shape", SHAPES, ids=[str(s) for s in SHAPES])
def test_plan_depends_on_the_shapes_alone(monkeypatch, shape):
    monkeypatch.setattr(torch.cuda, "get_device_properties", no_device)
    b, h, w, c = shape
    plan = tgn.norm_plan(b, h * w, c)
    assert plan == tgn.norm_plan(b, h * w, c)
    groups = math.gcd(32, c)
    assert plan.vec == (8 if c % 8 == 0 else 1)
    assert 2 * groups <= plan.threads <= tgn.NORM_THREADS  # what dg_group_norm takes
    nv = c // plan.vec
    assert plan.ctiles * plan.tile_vecs >= nv > (plan.ctiles - 1) * plan.tile_vecs
    assert 1 <= plan.splits <= 65535
    slices = tgn.combine_slices(plan, groups)
    assert slices == tgn.combine_slices(plan, groups)
    flat = sorted(e for part in slices for e in part)
    assert flat == list(range(plan.splits * plan.ctiles))  # each partial once


def test_plan_at_the_unets_largest_shape():
    """(4, 128, 128, 320): 40 vectors of 8 channels, 12 positions a step
    (480 threads), 66 ranges an image: 264 blocks, one wave of two an SM."""
    plan = tgn.norm_plan(4, 128 * 128, 320)
    assert plan == (8, 40, 12, 1, 66)
    assert 4 * plan.ctiles * plan.splits == tgn.SMS * tgn.NORM_BLOCKS_PER_SM


def walk(plan, b, hw, c, reverse=False):
    """(image, position, channel vector) of every thread step of the plan."""
    nv = c // plan.vec
    t = np.arange(plan.threads)
    out = []
    for img in range(b):
        for s in range(plan.splits):
            begin, end = hw * s // plan.splits, hw * (s + 1) // plan.splits
            for ct in range(plan.ctiles):
                vec = ct * plan.tile_vecs + t % plan.tile_vecs
                row = t // plan.tile_vecs
                steps = np.arange(-(-hw // plan.rows) + 1)
                pos = ((end - 1 - row[:, None] - steps * plan.rows) if reverse
                       else (begin + row[:, None] + steps * plan.rows))
                ok = (pos >= begin) & (pos < end) & (vec < nv)[:, None]
                vv = np.broadcast_to(vec[:, None], pos.shape)
                out.append(np.stack([np.full(ok.sum(), img), pos[ok], vv[ok]]))
    return np.concatenate(out, axis=1)


@pytest.mark.parametrize("shape", SHAPES[:3] + SHAPES[-6:], ids=str)
@pytest.mark.parametrize("reverse", [False, True], ids=["partials", "apply"])
def test_both_walks_cover_every_element_once(shape, reverse):
    b, h, w, c = shape
    plan = tgn.norm_plan(b, h * w, c)
    seen = np.zeros((b, h * w, c // plan.vec), dtype=np.int64)
    img, pos, vec = walk(plan, b, h * w, c, reverse)
    np.add.at(seen, (img, pos, vec), 1)
    assert (seen == 1).all()


@pytest.mark.parametrize("shape", [(2, 5, 7, 96), (2, 9, 11, 36), (1, 16, 16, 8)], ids=str)
def test_the_kernels_sums_in_their_order_give_the_statistics(shape):
    """Per-thread sums over its positions, over the block's rows in row order,
    over each group's channels of the tile in channel order; then per image
    the slices of ``combine_slices`` in turn: float32 throughout, within 1e-6
    of the float64 statistics, the variance clamped."""
    b, h, w, c = shape
    hw = h * w
    groups = math.gcd(32, c)
    cpg = c // groups
    x = (np.random.RandomState(1).randn(b, hw, c) * 2 + 0.5).astype(np.float32)
    plan = tgn.norm_plan(b, hw, c)
    vec, width = plan.vec, plan.tile_vecs * plan.vec
    part = np.zeros((b, plan.splits, plan.ctiles, 2, groups), np.float32)
    for img in range(b):
        for s in range(plan.splits):
            begin, end = hw * s // plan.splits, hw * (s + 1) // plan.splits
            for ct in range(plan.ctiles):
                red = np.zeros((2, plan.rows, width), np.float32)
                for t in range(plan.threads):
                    v0 = (ct * plan.tile_vecs + t % plan.tile_vecs) * vec
                    if v0 >= c:
                        continue
                    row = t // plan.tile_vecs
                    for p in range(begin + row, end, plan.rows):
                        xs = x[img, p, v0:v0 + vec]
                        j = (t % plan.tile_vecs) * vec
                        red[0, row, j:j + vec] += xs
                        red[1, row, j:j + vec] += xs * xs
                chan = np.zeros((2, width), np.float32)
                for r in range(plan.rows):
                    chan += red[:, r]
                c0 = ct * width
                for g in range(groups):
                    for ch in range(max(g * cpg, c0), min((g + 1) * cpg, c0 + width, c)):
                        part[img, s, ct, :, g] += chan[:, ch - c0]
    n = np.float32(hw * cpg)
    for img in range(b):
        entries = part[img].reshape(-1, 2, groups)
        tot = np.zeros((2, groups), np.float32)
        for idx in tgn.combine_slices(plan, groups):
            acc = np.zeros((2, groups), np.float32)
            for e in idx:
                acc += entries[e]
            tot += acc
        mean = tot[0] / n
        var = np.maximum(tot[1] / n - mean * mean, np.float32(0))
        xd = x[img].astype(np.float64).reshape(hw, groups, cpg)
        np.testing.assert_allclose(mean, xd.mean(axis=(0, 2)), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(var, xd.var(axis=(0, 2)), rtol=1e-4, atol=1e-5)


def test_unet_group_norms_are_an_int8_unet_calls():
    """``UNET_GROUP_NORMS`` is what one full-width ``UNetSDXL(quant, fused_ln,
    fused_gn)`` call at B = 2 images, 1024² (UNet batch 4, latents 128²)
    hands kernel 7: two norms per ResBlock (with SiLU), one per spatial
    transformer (without), and norm_out (with)."""
    model = tunet.UNetSDXL(quant=True, fused_ln=True, fused_gn=True, device="meta")
    levels = len(model.block_channels)
    counts = {}

    def add(key):
        counts[key] = counts.get(key, 0) + 1

    for name, m in model.named_modules():
        if not isinstance(m, (tunet.ResBlock, tunet.SpatialTransformer)):
            continue
        lvl = levels - 1 if name.startswith("mid") else int(name.split("_")[0][-1])
        hw = 128 >> lvl
        if isinstance(m, tunet.ResBlock):
            cout, cin = m.conv1.weight.shape[:2]
            add((4, hw, hw, cin, True))
            add((4, hw, hw, cout, True))
        else:
            add((4, hw, hw, m.norm.GroupNorm_0.num_channels, False))
    add((4, 128, 128, model.norm_out.GroupNorm_0.num_channels, True))
    assert counts == tgn.UNET_GROUP_NORMS and sum(counts.values()) == 46
