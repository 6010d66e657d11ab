"""Every head dim the Pallas attention kernels take, through the port's bodies.

The CUDA bodies are compiled for a few head dims (bf16: 64 and 512, 80 with
the relative-position bias, 32 in the window kernels; float32: 32, 64, 80,
128 and 512, the window backward 32 and 64); the Pallas kernels take any.
``attention_f32.kernel_body`` maps (dtype, bias, d) to a body and a kernel
width ``>= d``; the wrappers zero-pad q, k and v along the head dim to it,
keep the scale at ``1/√d`` of the true d, and take the first d output
channels. Held here on the CPU: the rule for every (dtype, policy, d) from 1
to 128 and 512, the raise beyond it, and the padding path run with the plain
twins (the wrappers' own layout steps: ``attention_f32.pad_head_dim``,
``flash_attention.packed_heads`` / ``packed_merge``, ``window_attention.
pad_packed`` / ``unpad_packed``, ``F.pad``) against the JAX functions on the
same numpy inputs, at 1e-5 of max |reference| (float32 sums in another
order). The JAX functions run as the JAX tests run them on the CPU: the
window kernels and ``flash_attention_packed`` in interpret mode,
``flash_attention`` and ``flash_attention_relpos`` through their reference
paths.
"""
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from divergen_tpu.ops.pallas import flash_attention as jfa
from divergen_tpu.ops.pallas import window_attention as jwa
from divergen_tpu_torch.ops import attention_f32 as af
from divergen_tpu_torch.ops import flash_attention as tfa
from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)
TOL = 1e-5
DIMS = list(range(1, 129)) + [512]


def assert_rel_close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    err = np.abs(got - ref).max()
    assert err <= tol * np.abs(ref).max(), (err, np.abs(ref).max())


def least(widths, d):
    return min(w for w in widths if w >= d)


@pytest.mark.parametrize("mode", ["none", "dense", "relpos"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_every_head_dim_to_128_and_512_has_a_body(dtype, mode):
    bf16 = {"none": (64, 512), "dense": (64, 512), "relpos": (80,)}[mode]
    for d in DIMS:
        body = af.kernel_body(dtype, d, mode)
        assert body.width >= d
        if dtype == torch.float32:
            assert body == af.Body("dg_attention_f32", least(af.F32_HEAD_DIMS, d), torch.float32)
        elif d <= max(bf16):
            width = least(bf16, d)
            assert body == af.Body(af.BF16_BODIES[(mode, width)], width, torch.bfloat16)
        else:  # relpos above 80: no bf16 body is that wide
            assert mode == "relpos"
            assert body == af.Body("dg_attention_f32", least(af.F32_HEAD_DIMS, d), torch.float32)


@pytest.mark.parametrize("dtype,widths", [(torch.bfloat16, (32,)), (torch.float32, (32, 64))],
                         ids=["bf16", "f32"])
def test_window_head_dims_pad_to_their_backwards_widths(dtype, widths):
    for d in range(1, widths[-1] + 1):
        body = af.kernel_body(dtype, d, "window")
        assert (body.width, body.dtype) == (least(widths, d), dtype)
    for d in (widths[-1] + 1, 80, 128):
        with pytest.raises(ValueError, match=f"head dim {d}:.*widths {re.escape(str(widths))}"):
            af.kernel_body(dtype, d, "window")


@pytest.mark.parametrize("d", [0, 129, 200, 256, 511, 513, 1024])
@pytest.mark.parametrize("mode", ["none", "dense", "relpos"])
def test_other_head_dims_raise_naming_the_widths(mode, d):
    for dtype in (torch.bfloat16, torch.float32):
        with pytest.raises(ValueError, match=f"head dim {d}: .*1 <= d <= 128.*d = 512"):
            af.kernel_body(dtype, d, mode)


def test_pad_head_dim_zero_fills_in_the_bodys_dtype():
    x = torch.randn(2, 5, 20, dtype=torch.bfloat16)
    body = af.kernel_body(torch.bfloat16, 100, "relpos")  # the float32 body at 128
    got = af.pad_head_dim(x, body)
    assert got.shape == (2, 5, 128) and got.dtype == torch.float32 and got.is_contiguous()
    assert torch.equal(got[..., :20], x.float()) and not got[..., 20:].any()


def rng_arrays(seed, *shapes):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) for s in shapes]


@pytest.mark.parametrize("with_bias", [False, True], ids=["none", "dense"])
@pytest.mark.parametrize("d", [16, 20, 48, 96])
def test_padded_flash_attention_matches_jax(d, with_bias):
    """Kernel 3's padding path (float32 widths 32, 64 and 128; the bf16 rule
    takes 64 and 512) with the float32 twin, against the JAX function."""
    q, k, v, bias = rng_arrays(d, (3, 50, d), (3, 37, d), (3, 37, d), (3, 50, 37))
    bias = bias if with_bias else None
    want = jfa.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               None if bias is None else jnp.asarray(bias), use_pallas=False)
    body = af.kernel_body(torch.float32, d, "none" if bias is None else "dense")
    assert body.width > d
    qp, kp, vp = (af.pad_head_dim(torch.from_numpy(x), body) for x in (q, k, v))
    out = tfa.reference_attention(qp, kp, vp, None if bias is None else torch.from_numpy(bias),
                                  scale=1.0 / math.sqrt(d))
    assert not out[..., d:].any()  # P·0
    assert_rel_close(out[..., :d].numpy(), want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("d", [16, 20, 48, 96])
def test_padded_packed_attention_takes_kernel_3s_path(dtype, d):
    """Kernel 1 at a width its body cannot read by stride: each head's q, k, v
    padded to (3, B·H, N, width), kernel 3's twin, then (B, N, H·d); against
    the Pallas ``flash_attention_packed`` in interpret mode (float32)."""
    b, n, heads = 2, 40, 3
    (qkv,) = rng_arrays(d + 1, (b, n, 3 * heads * d))
    want = jfa.flash_attention_packed(jnp.asarray(qkv), heads, interpret=True)
    body = af.kernel_body(dtype, d, "none")
    x = tfa.packed_heads(torch.from_numpy(qkv), heads, body)
    assert x.shape == (3, b * heads, n, body.width) and x.dtype == dtype
    assert not x[..., d:].any()
    if dtype == torch.float32:
        out = tfa.reference_attention(x[0], x[1], x[2], scale=1.0 / math.sqrt(d))
        got = tfa.packed_merge(out, b, d, torch.float32)
        assert got.shape == (b, n, heads * d)
        assert_rel_close(got.numpy(), want)
    else:  # the layout alone: the bf16 operands hold the input's heads in order
        per = torch.from_numpy(qkv).reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
        assert torch.equal(x[..., :d].reshape(3, b, heads, n, d), per.to(dtype))


def test_padded_relpos_attention_matches_jax():
    """Kernel 4 at d = 64: the bf16 rule pads to PR 13's d = 80 body, the
    float32 one takes its own d = 64; run here at the bf16 width, float32
    values, on an 8 x 8 grid."""
    d, (h, w), bh = 64, (8, 8), 4
    n = h * w
    q, k, v, bh_t, bw_t = rng_arrays(3, (bh, n, d), (bh, n, d), (bh, n, d), (bh, h, n),
                                     (bh, w, n))
    want = jfa.reference_attention_relpos(*(jnp.asarray(a) for a in (q, k, v, bh_t, bw_t)),
                                          (h, w))
    body = af.kernel_body(torch.bfloat16, d, "relpos")
    assert (body.entry, body.width) == ("dg_flash_attention_relpos_bf16", 80)
    body = af.Body(body.entry, body.width, torch.float32)  # the same padding in float32
    qp, kp, vp = (af.pad_head_dim(torch.from_numpy(x), body) for x in (q, k, v))
    out = tfa.reference_attention_relpos(qp, kp, vp, torch.from_numpy(bh_t),
                                         torch.from_numpy(bw_t), (h, w), scale=1 / math.sqrt(d))
    assert_rel_close(out[..., :d].numpy(), want)
    assert af.kernel_body(torch.float32, d, "relpos").width == 64


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_padded_window_attention_forward_and_gradients_match_jax(with_mask):
    """The window kernels at d = 16 (bf16 and float32 both pad to 32): the
    packed wrapper's ``pad_packed``, the twin at width 32 with the scale of
    d = 16, ``unpad_packed``; forward and autograd's gradients (the pad's
    backward slices them) against the Pallas kernel in interpret mode and
    ``jax.grad`` of it."""
    d, heads, n, bn, nw = 16, 3, 16, 4, 2
    assert af.kernel_body(torch.bfloat16, d, "window").width == 32
    assert af.kernel_body(torch.float32, d, "window").width == 32
    qkv, bias, do = rng_arrays(7, (bn, n, 3 * heads * d), (heads, n, n), (bn, n, heads * d))
    bias *= 0.1
    mask = None
    if with_mask:
        mask = np.random.RandomState(8).choice([0.0, -100.0], size=(nw, n, n),
                                               p=[0.8, 0.2]).astype(np.float32)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(qkv, bias):
        out = jwa.fused_window_attention_packed(qkv, bias, jm, heads, interpret=True)
        return jnp.sum(out * jnp.asarray(do)), out

    (_, want), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(qkv), jnp.asarray(bias))
    tq, tb = (torch.from_numpy(a).requires_grad_(True) for a in (qkv, bias))
    padded = twa.pad_packed(tq, heads, 32)
    assert padded.shape == (bn, n, 3 * heads * 32)
    out = twa.unpad_packed(twa.reference_window_attention_packed(
        padded, tb, None if mask is None else torch.from_numpy(mask), heads,
        scale=1.0 / math.sqrt(d)), heads, d)
    out.backward(torch.from_numpy(do))
    assert_rel_close(out.detach().numpy(), want)
    assert_rel_close(tq.grad.numpy(), grads[0])
    assert_rel_close(tb.grad.numpy(), grads[1])


def test_padded_split_window_gradients_match_jax():
    """The split wrapper's padding (``F.pad`` of q, k and v) at d = 16, its
    gradients sliced by autograd, against ``jax.grad`` of the Pallas split
    kernel in interpret mode."""
    d, heads, n, bn = 16, 2, 9, 4
    q, k, v, bias, do = rng_arrays(9, *[(bn, heads, n, d)] * 3, (heads, n, n), (bn, heads, n, d))

    def loss(q, k, v, bias):
        return jnp.sum(jwa.fused_window_attention(q, k, v, bias, None, interpret=True)
                       * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(a) for a in (q, k, v, bias)))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v, bias)]
    qp, kp, vp = (F.pad(t, (0, 32 - d)) for t in leaves[:3])
    out = twa.reference_window_attention(qp, kp, vp, leaves[3], None, scale=1.0 / math.sqrt(d))
    out[..., :d].backward(torch.from_numpy(do))
    for leaf, w in zip(leaves, want):
        assert_rel_close(leaf.grad.numpy(), w)


@pytest.mark.parametrize("backward", [False, True], ids=["forward", "backward"])
def test_count_tells_bodies_and_head_dims_apart(backward):
    """``attention_f32.count``: one launch adds one to the wrapper's total and
    one under (body entry, the caller's head dim), so a padded launch and a
    launch at the body's own width are counted apart."""
    from collections import Counter

    def wrapper():
        pass

    wrapper.launches = wrapper.backward_launches = 0
    wrapper.bodies, wrapper.backward_bodies = Counter(), Counter()
    padded, own = af.kernel_body(torch.float32, 16, "window"), af.kernel_body(torch.float32, 32,
                                                                              "window")
    for body, d in ((padded, 16), (own, 32), (own, 32)):
        af.count(wrapper, body, d, backward=backward)
    total, bodies = ((wrapper.backward_launches, wrapper.backward_bodies) if backward
                     else (wrapper.launches, wrapper.bodies))
    other = wrapper.bodies if backward else wrapper.backward_bodies
    assert total == 3 and not other
    assert bodies == Counter({("dg_attention_f32", 16): 1, ("dg_attention_f32", 32): 2})


def test_cpu_calls_count_no_body():
    """On a CPU tensor the wrappers run their twins: no launch is counted."""
    wrappers = (tfa.flash_attention, tfa.flash_attention_packed, twa.fused_window_attention_packed)
    before = [(w.launches, sum(w.bodies.values())) for w in wrappers]
    x = torch.randn(2, 16, 3 * 2 * 16)
    tfa.flash_attention(x[..., :16], x[..., 16:32], x[..., 32:48])
    tfa.flash_attention_packed(x, 2)
    twa.fused_window_attention_packed(x, torch.zeros(2, 16, 16), None, 2)
    assert [(w.launches, sum(w.bodies.values())) for w in wrappers] == before
