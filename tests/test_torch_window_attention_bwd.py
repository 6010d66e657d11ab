"""The port's plain window-attention backward against the JAX package's kernels.

``reference_window_attention_backward`` (and ``_packed``) repeat the CUDA
backward kernel's arithmetic in plain torch. Here they are held, on the same
numpy inputs in float32, against ``jax.grad`` of the Pallas kernels run in
interpret mode (as ``tests/test_window_attention.py`` runs them on the CPU) and
against torch autograd through the plain forward, to 5e-5 absolute + 1e-3
relative (the JAX tests' own bound for gradients; the two sides sum in another
order). The wrappers' autograd path is checked on CPU tensors, also under
``torch.utils.checkpoint``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from divergen_tpu.ops.pallas import window_attention as jwa
from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)

TOL = dict(atol=5e-5, rtol=1e-3)


def t(a, grad=False):
    return torch.from_numpy(np.ascontiguousarray(a)).requires_grad_(grad)


def make_inputs(bsz, h, n, d, with_mask, nw=4, seed=0):
    rng = np.random.RandomState(seed)
    q, k, v, do = (rng.randn(bsz, h, n, d).astype(np.float32) for _ in range(4))
    bias = (rng.randn(h, n, n) * 0.1).astype(np.float32)
    mask = None
    if with_mask:
        mask = rng.choice([0.0, -100.0], size=(nw, n, n), p=[0.8, 0.2]).astype(np.float32)
    return q, k, v, bias, mask, do


def packed(q, k, v):
    """(B, H, N, D) q, k, v → the fused (B, N, 3·H·D) projection."""
    b, h, n, d = q.shape
    return np.concatenate([x.transpose(0, 2, 1, 3).reshape(b, n, h * d) for x in (q, k, v)], -1)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("h,n,d", [(4, 16, 8), (6, 16, 8), (3, 9, 8), (2, 25, 32)],
                         ids=["h4", "h6", "ragged9", "ragged25"])
def test_plain_backward_against_jax_grad_of_the_pallas_kernel(with_mask, h, n, d):
    q, k, v, bias, mask, do = make_inputs(8, h, n, d, with_mask)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(q, k, v, bias):
        out = jwa.fused_window_attention(q, k, v, bias, jm, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(*(jnp.asarray(x) for x in (q, k, v, bias)))
    got = twa.reference_window_attention_backward(
        t(q), t(k), t(v), t(bias), None if mask is None else t(mask), t(do))
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **TOL)
    assert got[3].dtype == torch.float32 and got[3].shape == bias.shape


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("h", [4, 6])
def test_plain_packed_backward_against_jax_grad_of_the_pallas_kernel(with_mask, h):
    """Four heads take the packed Pallas kernel, six its split fallback."""
    d = 32
    q, k, v, bias, mask, do = make_inputs(4, h, 16, d, with_mask)
    qkv = packed(q, k, v)
    do_p = do.transpose(0, 2, 1, 3).reshape(4, 16, h * d)
    jm = None if mask is None else jnp.asarray(mask)

    def loss(qkv, bias):
        out = jwa.fused_window_attention_packed(qkv, bias, jm, h, interpret=True)
        return jnp.sum(out * jnp.asarray(do_p))

    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(qkv), jnp.asarray(bias))
    got = twa.reference_window_attention_packed_backward(
        t(qkv), t(bias), None if mask is None else t(mask), h, t(do_p))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), err_msg="dqkv", **TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), err_msg="dbias", **TOL)


@pytest.mark.parametrize("with_mask", [False, True], ids=["nomask", "mask"])
def test_plain_backward_against_autograd_of_the_plain_forward(with_mask):
    q, k, v, bias, mask, do = make_inputs(8, 3, 16, 32, with_mask, seed=1)
    tm = None if mask is None else t(mask)
    leaves = [t(x, grad=True) for x in (q, k, v, bias)]
    twa.reference_window_attention(*leaves, tm).backward(t(do))
    got = twa.reference_window_attention_backward(t(q), t(k), t(v), t(bias), tm, t(do))
    for name, g, leaf in zip(("dq", "dk", "dv", "dbias"), got, leaves):
        np.testing.assert_allclose(g.numpy(), leaf.grad.numpy(), err_msg=name, **TOL)


def test_plain_backward_rounds_p_and_ds_to_the_input_dtype():
    """In bfloat16 the plain backward is the float32 one to bfloat16 rounding
    (2e-2 of max |ref|: p and ds are rounded before their products), returns
    bfloat16 dq, dk, dv and a float32 dbias."""
    q, k, v, bias, mask, do = make_inputs(4, 2, 16, 32, True, seed=2)
    half = lambda a: t(a).to(torch.bfloat16)
    got = twa.reference_window_attention_backward(half(q), half(k), half(v), t(bias), t(mask),
                                                  half(do))
    want = twa.reference_window_attention_backward(
        half(q).float(), half(k).float(), half(v).float(), t(bias), t(mask), half(do).float())
    assert [g.dtype for g in got] == [torch.bfloat16] * 3 + [torch.float32]
    for g, w in zip(got, want):
        assert (g.float() - w).abs().max() <= 2e-2 * w.abs().max()


@pytest.mark.parametrize("layout", ["packed", "split"])
def test_wrapper_gradients_on_the_cpu_also_under_checkpoint(layout):
    """On CPU tensors the wrappers differentiate through the plain version;
    ``torch.utils.checkpoint`` around them gives the same gradients, and the
    kernels' launch counters stay where they were."""
    q, k, v, bias, mask, do = make_inputs(4, 3, 16, 32, True, seed=3)
    before = [f.launches + f.backward_launches
              for f in (twa.fused_window_attention_packed, twa.fused_window_attention)]
    if layout == "packed":
        args = [packed(q, k, v), bias]
        fn = lambda qkv, b: twa.fused_window_attention_packed(qkv, b, t(mask), 3)
        grad_out = do.transpose(0, 2, 1, 3).reshape(4, 16, 96)
        ref = twa.reference_window_attention_packed_backward(
            t(args[0]), t(bias), t(mask), 3, t(grad_out))
    else:
        args = [q, k, v, bias]
        fn = lambda q, k, v, b: twa.fused_window_attention(q, k, v, b, t(mask))
        grad_out = do
        ref = twa.reference_window_attention_backward(t(q), t(k), t(v), t(bias), t(mask), t(do))
    plain = [t(a, grad=True) for a in args]
    fn(*plain).backward(t(grad_out))
    again = [t(a, grad=True) for a in args]
    checkpoint(fn, *again, use_reentrant=False).backward(t(grad_out))
    for a, b, r in zip(plain, again, ref):
        np.testing.assert_array_equal(a.grad.numpy(), b.grad.numpy())
        np.testing.assert_allclose(a.grad.numpy(), r.numpy(), **TOL)
    assert before == [f.launches + f.backward_launches
                      for f in (twa.fused_window_attention_packed, twa.fused_window_attention)]


def test_backward_chunks_cover_every_window(monkeypatch):
    """The float32 backward kernel's grid (``f32_backward_plan``): chunks ·
    per_chunk ≥ windows, no empty chunk, and one block per multiprocessor at
    n = 144 (the plan and layout in full: ``test_torch_window_bwd_f32.py``)."""
    class Props:
        multi_processor_count = 132

    monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: Props)
    for batch, heads in [(722, 6), (200, 12), (50, 24), (18, 48), (8, 3), (1, 1), (3, 200)]:
        chunks, per, _ = twa.f32_backward_plan(batch, heads, 144, 32, torch.device("cpu"))
        assert chunks * per >= batch > (chunks - 1) * per
        assert chunks * heads <= max(132 + heads, heads)
    assert twa.f32_backward_plan(722, 6, 144, 32, torch.device("cpu"))[:2] == (22, 33)
