"""The port's fused GroupNorm → SiLU → 3×3 conv (its plain version, on the
CPU) and the fused-ResBlock UNet option against the JAX package.

Same numpy inputs through both. Tolerances: the function within 2e-3 of max
|reference|: both packages round the same f32 operands to bfloat16, so they
differ only by the order of float32 sums and the rare bf16 rounding tie that
order flips. The JAX Pallas kernel (``interpret=True``) rounds x itself to
bfloat16 before the affine, where the CPU path and the port keep f32 x in
f32; it is compared on bf16 x, where the two paths agree. One fused ResBlock
within 1e-2 of max |reference|: a bf16 rounding of y that falls the other way
moves the second conv's input by one bf16 step.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas.fused_gn_conv import fused_gn_silu_conv3x3 as jax_fused
from divergen_tpu.pipeline.generation import unet as junet
from divergen_tpu_torch.ops import gn_conv as tgc
from divergen_tpu_torch.pipeline.generation import unet as tunet
from divergen_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(1)

# the shapes of tests/test_fused_gn_conv.py, C = 48 among them: 24 groups (the
# largest divisor of 48 at most 32), where gcd(32, 48) would give 16
SHAPES = [((2, 8, 8, 32), 64, 32), ((1, 16, 12, 64), 32, 32), ((1, 8, 8, 48), 16, 32)]


def _case(shape, co, dtype):
    rng = np.random.RandomState(0)
    c = shape[-1]
    x = jnp.asarray(rng.randn(*shape) * 0.5 + 0.2, jnp.float32).astype(dtype)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    gbias = (rng.randn(c) * 0.1).astype(np.float32)
    kernel = (rng.randn(3, 3, c, co) * 0.05).astype(np.float32)  # HWIO
    cbias = (rng.randn(co) * 0.1).astype(np.float32)
    tx = torch.from_numpy(np.asarray(x.astype(jnp.float32))).to(getattr(torch, dtype))
    targs = (tx, torch.from_numpy(scale), torch.from_numpy(gbias),
             torch.from_numpy(kernel).permute(3, 2, 0, 1), torch.from_numpy(cbias))
    return (x, *map(jnp.asarray, (scale, gbias, kernel, cbias))), targs


def _assert_close(got: torch.Tensor, want, tol: float):
    want = np.asarray(jnp.asarray(want).astype(jnp.float32), np.float64)
    got = got.float().numpy().astype(np.float64)
    assert got.shape == want.shape
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,co,groups", SHAPES, ids=["c32", "c64", "c48"])
def test_twin_vs_jax_cpu_path(shape, co, groups, dtype):
    jargs, targs = _case(shape, co, dtype)
    want = jax_fused(*jargs, groups=groups)
    got = tgc.fused_gn_silu_conv3x3(*targs, groups=groups)
    assert got.dtype == targs[0].dtype and got.shape == (*shape[:3], co)
    _assert_close(got, want, 2e-3)


def test_twin_vs_pallas_interpret_and_group_rule():
    jargs, targs = _case((1, 8, 8, 48), 16, "bfloat16")
    want = jax_fused(*jargs, interpret=True)
    _assert_close(tgc.fused_gn_silu_conv3x3(*targs), want, 2e-3)
    assert tgc.group_count(48) == 24 and tgc.group_count(320) == 32 and tgc.group_count(7) == 7


def test_fused_resblock_vs_jax():
    """C_in 32 → C_out 64 (a conv_shortcut), the JAX module's fused path on
    the same ``params_from_jax`` weights, in float32."""
    rng = np.random.RandomState(2)
    x = (rng.randn(2, 8, 8, 32) * 0.6).astype(np.float32)
    emb = rng.randn(2, 48).astype(np.float32)
    jm = junet.ResBlock(out_channels=64, conv_matmul="fused")
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(emb))
    want = jm.apply(params, jnp.asarray(x), jnp.asarray(emb))
    tm = tunet.ResBlock(32, 64, 48, conv_matmul="fused")
    tm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    with torch.inference_mode():
        got = tm(torch.from_numpy(x), torch.from_numpy(emb))
    _assert_close(got, want, 1e-2)


def test_wrapper_refuses_a_device_without_the_kernel_and_unported_options():
    x = torch.empty((1, 8, 8, 32), device="meta")
    w = torch.empty((16, 32, 3, 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tgc.fused_gn_silu_conv3x3(x, x.new_empty(32), x.new_empty(32), w, x.new_empty(16))
    assert tgc.fused_gn_silu_conv3x3.launches == 0
    with pytest.raises(NotImplementedError, match='"fused"'):
        tunet.UNetSDXL.tiny(conv_matmul="im2col")


# SDXL's kernel-8 shapes (B, H, W, C, Co), then ragged ones: W off every
# power of two (the box runs past W), H under the box's th, Co off both tile
# widths, W over 128, one pixel
PLAN_SHAPES = list(tgc.UNET_CONVS) + [(1, 12, 20, 48, 16), (2, 9, 11, 36, 21),
                                      (2, 32, 32, 640, 320), (3, 5, 200, 8, 300),
                                      (1, 1, 1, 8, 1)]


@pytest.mark.parametrize("b,h,w,c,co", PLAN_SHAPES)
def test_conv_plan_covers_each_output_once(b, h, w, c, co):
    """The kernel's walk (``csrc/gn_conv.cu``: ``origin``, the boxes, the
    epilogue's mask) writes every output pixel and channel exactly once; at
    SDXL's shapes on 132 SMs no row or column of a tile falls outside the
    output and the two warpgroups of each block are kept busy (wave
    efficiency 0.97)."""
    plan = tgc.conv_plan(b, h, w, co, 132)
    th, tw = plan.th, plan.tw
    assert th * tw == tgc.CONV_BM and tw & (tw - 1) == 0
    tiles_h, tiles_w, bn = -(-h // th), -(-w // tw), tgc.CONV_BN
    assert plan.tiles_m == b * tiles_h * tiles_w and plan.tiles_n == -(-co // bn)
    tiles = plan.tiles_m * plan.tiles_n
    assert plan.blocks == min(tiles, 132)
    # the blocks' walk: block k takes tiles k, k + blocks, ...: each tile once
    walked = np.concatenate([np.arange(k, tiles, plan.blocks) for k in range(plan.blocks)])
    assert np.array_equal(np.sort(walked), np.arange(tiles))
    t = np.arange(tiles)
    mt, n0 = t // plan.tiles_n, (t % plan.tiles_n) * bn
    hb = mt // tiles_w
    w0, h0, img = (mt % tiles_w) * tw, (hb % tiles_h) * th, hb // tiles_h
    r = np.arange(tgc.CONV_BM)
    py, px = h0[:, None] + r // tw, w0[:, None] + r % tw
    inside = (py < h) & (px < w)
    pix = np.zeros((b, h, w), np.int64)
    np.add.at(pix, (np.broadcast_to(img[:, None], py.shape)[inside], py[inside], px[inside]), 1)
    cols = n0[:, None] + np.arange(bn)
    chan = np.bincount(cols[cols < co], minlength=co)
    # each (pixel, channel) pair is one (pixel tile, channel tile) pair's
    assert (pix == plan.tiles_n).all() and (chan == plan.tiles_m).all()
    if (b, h, w, c, co) in tgc.UNET_CONVS:
        waves = -(-tiles // (2 * plan.blocks))
        efficiency = b * h * w * co / (2 * plan.blocks * waves * tgc.CONV_BM * bn)
        assert inside.all() and tw == w and co % bn == 0
        assert plan.blocks == 132 and 0.969 < efficiency < 0.97


def test_unet_convs_are_a_fused_unet_calls():
    """``UNET_CONVS`` is what one full-width ``UNetSDXL(conv_matmul="fused")``
    call at B = 2 images, 1024² (UNet batch 4, latents 128²) hands kernel 8:
    two convs per ResBlock, at its level's map."""
    model = tunet.UNetSDXL(conv_matmul="fused", device="meta")
    levels = len(model.block_channels)
    counts = {}
    for name, m in model.named_modules():
        if isinstance(m, tunet.ResBlock):
            # down{lvl}_res{i}, up{lvl}_res{i}, or mid_res{i} at the last level
            lvl = levels - 1 if name.startswith("mid") else int(name.split("_")[0][-1])
            hw = 128 >> lvl
            cout, cin = m.conv1.weight.shape[:2]
            for key in ((4, hw, hw, cin, cout), (4, hw, hw, cout, cout)):
                counts[key] = counts.get(key, 0) + 1
    assert counts == tgc.UNET_CONVS and sum(counts.values()) == 34
