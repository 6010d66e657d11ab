"""The port's plain window attention against the JAX package, same inputs.

numpy makes the inputs; the port's plain versions (what its wrappers run for a
CPU tensor) are held against the JAX package's ``_reference`` /
``_reference_packed`` and against its Pallas kernels in interpret mode, in
float32, with the JAX tests' own tolerance (atol 2e-5, rtol 1e-4). The CUDA
kernels themselves are held against these plain versions on the card by
``chip_smoke.py``; here the wrappers' argument checks are exercised as far as
they can be reached without a card (a ``meta`` tensor is neither CPU nor CUDA).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import window_attention as jwa
from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)
TOL = dict(atol=2e-5, rtol=1e-4)


def make_inputs(bsz, h, n, d, with_mask, nw=4, seed=0):
    rng = np.random.RandomState(seed)
    qkv = rng.randn(bsz, n, 3 * h * d).astype(np.float32)
    bias = (rng.randn(h, n, n) * 0.1).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.choice([0.0, -100.0], size=(nw, n, n), p=[0.8, 0.2]).astype(np.float32)
    return qkv, bias, mask


def split(qkv, h):
    bn, n, c3 = qkv.shape
    c = c3 // 3
    return [qkv[..., s * c:(s + 1) * c].reshape(bn, n, h, c // h).transpose(0, 2, 1, 3)
            for s in range(3)]


def t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def j(a):
    return None if a is None else jnp.asarray(a)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("h", [4, 6, 12])
def test_plain_packed_matches_jax(h, with_mask):
    qkv, bias, mask = make_inputs(8, h, 16, 32, with_mask)
    got = twa.fused_window_attention_packed(t(qkv), t(bias), t(mask), h).numpy()
    ref = jwa._reference_packed(j(qkv), j(bias), j(mask), h)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    kern = jwa.fused_window_attention_packed(j(qkv), j(bias), j(mask), h, interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("h", [4, 6, 12])
def test_plain_split_matches_jax(h, with_mask):
    qkv, bias, mask = make_inputs(8, h, 16, 32, with_mask, seed=1)
    q, k, v = split(qkv, h)
    got = twa.fused_window_attention(t(q), t(k), t(v), t(bias), t(mask)).numpy()
    ref = jwa._reference(j(q), j(k), j(v), j(bias), j(mask))
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)
    kern = jwa.fused_window_attention(j(q), j(k), j(v), j(bias), j(mask), interpret=True)
    np.testing.assert_allclose(got, np.asarray(kern), **TOL)


def test_packed_and_split_agree_on_strided_views():
    """The split wrapper on heads-first views of the fused projection gives
    what the packed wrapper gives."""
    h = 6
    qkv, bias, mask = make_inputs(8, h, 16, 32, True, seed=2)
    tq = t(qkv)
    c = tq.shape[-1] // 3
    q, k, v = (tq[..., s * c:(s + 1) * c].reshape(8, 16, h, 32).permute(0, 2, 1, 3)
               for s in range(3))
    assert not q.is_contiguous()
    split_out = twa.fused_window_attention(q, k, v, t(bias), t(mask))
    packed = twa.fused_window_attention_packed(tq, t(bias), t(mask), h)
    np.testing.assert_allclose(split_out.permute(0, 2, 1, 3).reshape(8, 16, c).numpy(),
                               packed.numpy(), atol=1e-6)


def test_ragged_window_sizes():
    """n = 4 and n = 49 (shrunk windows, window 7): no padding rule."""
    for n, h in ((4, 3), (49, 3)):
        qkv, bias, mask = make_inputs(4, h, n, 32, True, nw=2, seed=n)
        got = twa.fused_window_attention_packed(t(qkv), t(bias), t(mask), h).numpy()
        ref = jwa._reference_packed(j(qkv), j(bias), j(mask), h)
        np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def meta(*shape, dtype=torch.bfloat16, **kw):
    return torch.empty(*shape, dtype=dtype, device="meta", **kw)


BIAS = torch.zeros(3, 16, 16)


@pytest.mark.parametrize("case,qkv,heads,error,match", [
    ("float32", meta(4, 16, 288, dtype=torch.float32), 3, ValueError, "bfloat16"),
    ("head dim 64", meta(4, 16, 576), 3, ValueError, "head dim 64"),
    ("gradient", meta(4, 16, 288, requires_grad=True), 3, NotImplementedError,
     "backward not yet ported"),
    ("not contiguous", meta(4, 16, 576)[..., :288], 3, ValueError, "contiguous"),
    ("neither CPU nor CUDA", meta(4, 16, 288), 3, ValueError, "CUDA or CPU"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_packed_wrapper_refuses(case, qkv, heads, error, match):
    with pytest.raises(error, match=match):
        twa.fused_window_attention_packed(qkv, BIAS, None, heads)


def test_packed_wrapper_gradient_allowed_under_no_grad():
    """Under ``torch.no_grad()`` a leaf that requires grad is not a request
    for a gradient: the wrapper goes on to its next check."""
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA or CPU"):
        twa.fused_window_attention_packed(meta(4, 16, 288, requires_grad=True), BIAS, None, 3)


@pytest.mark.parametrize("case,kw,error,match", [
    ("float32", dict(dtype=torch.float32), ValueError, "bfloat16"),
    ("head dim 16", dict(d=16), ValueError, "head dim 16"),
    ("too many tokens", dict(n=169), ValueError, "169 tokens"),
    ("gradient", dict(requires_grad=True), NotImplementedError, "backward not yet ported"),
    ("neither CPU nor CUDA", dict(), ValueError, "CUDA or CPU"),
], ids=lambda v: v if isinstance(v, str) else None)
def test_split_wrapper_refuses(case, kw, error, match):
    n, d = kw.pop("n", 16), kw.pop("d", 32)
    q = meta(4, 3, n, d, **kw)
    with pytest.raises(error, match=match):
        twa.fused_window_attention(q, q, q, torch.zeros(3, n, n), None)


def test_split_wrapper_refuses_misaligned_strides():
    base = meta(4, 3, 16, 36)
    q = base[..., :32]  # row stride 36: not a multiple of 8
    with pytest.raises(ValueError, match="multiples of 8"):
        twa.fused_window_attention(q, q, q, BIAS, None)


@pytest.mark.parametrize("bias,mask,match", [
    (torch.zeros(2, 16, 16), None, "bias"),
    (BIAS, torch.zeros(3, 16, 16), "do not cycle"),
    (BIAS, torch.zeros(2, 8, 16), "mask"),
], ids=["bias shape", "mask cycle", "mask shape"])
def test_bias_and_mask_shapes_are_checked_on_the_cpu(bias, mask, match):
    with pytest.raises(ValueError, match=match):
        twa.fused_window_attention_packed(torch.zeros(4, 16, 288), bias, mask, 3)


def test_launch_counters_do_not_move_on_the_cpu():
    before = (twa.fused_window_attention_packed.launches, twa.fused_window_attention.launches)
    qkv, bias, mask = make_inputs(4, 3, 16, 32, False)
    twa.fused_window_attention_packed(t(qkv), t(bias), None, 3)
    assert (twa.fused_window_attention_packed.launches,
            twa.fused_window_attention.launches) == before
