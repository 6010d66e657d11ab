"""Kernel 5's and 6's launches as ``torch.library`` custom ops
(``ops/window_attention.py``), on the CPU: what a tracer sees.

On fake CUDA tensors (no card is needed to trace), ``torch.export`` of each
wrapper records the forward op ``divergen::window_attention_packed`` /
``divergen::window_attention`` with the caller's head dim, and the fake
implementations give every output's shape and dtype: (bn, n, C) forward,
(dqkv, float32 dbias) backward, for bf16 and float32, at the bodies' own
widths (a narrower head dim is zero-padded by ``F.pad``, which fake CUDA
tensors cannot run without a CUDA build of torch). The ops have a CUDA
implementation only: a CPU tensor reaches none of them (the wrappers take
the plain twin for it, and the op itself raises).
"""
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from divergen_tpu_torch.ops import window_attention as wa

torch.set_num_threads(1)
OPS = torch.ops.divergen


class _Packed(torch.nn.Module):
    def __init__(self, heads):
        super().__init__()
        self.heads = heads

    def forward(self, qkv, bias, mask):
        return wa.fused_window_attention_packed(qkv, bias, mask, self.heads)


class _Split(torch.nn.Module):
    def forward(self, q, k, v, bias):
        return wa.fused_window_attention(q, k, v, bias)


def fake_cuda(mode, *shapes, dtype=torch.float32):
    with mode:
        return [torch.empty(s, dtype=dtype, device="cuda") for s in shapes]


def op_calls(ep):
    return [n for n in ep.graph.nodes if n.op == "call_function"
            and str(n.target).startswith("divergen.")]


@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 32), (torch.float32, 32),
                                     (torch.float32, 64)])
def test_packed_wrapper_exports_as_the_custom_op(dtype, d):
    heads, bn, n, nw = 3, 8, 49, 4
    mode = FakeTensorMode()
    (qkv,) = fake_cuda(mode, (bn, n, 3 * heads * d), dtype=dtype)
    bias, mask = fake_cuda(mode, (heads, n, n), (nw, n, n))
    ep = torch.export.export(_Packed(heads), (qkv, bias, mask))
    calls = op_calls(ep)
    assert [str(c.target) for c in calls] == ["divergen.window_attention_packed.default"]
    (call,) = calls
    assert call.args[3:] == (heads, d)  # the caller's head dim sets the scale
    assert tuple(call.meta["val"].shape) == (bn, n, heads * d)
    assert call.meta["val"].dtype == dtype
    # the plain version is not in the card's program
    assert not any("softmax" in str(n.target) for n in ep.graph.nodes)


def test_split_wrapper_exports_as_the_custom_op():
    b, h, n, d = 4, 2, 16, 32
    mode = FakeTensorMode()
    q, k, v = fake_cuda(mode, *[(b, h, n, d)] * 3, dtype=torch.bfloat16)
    (bias,) = fake_cuda(mode, (h, n, n))
    ep = torch.export.export(_Split(), (q, k, v, bias))
    assert [str(c.target) for c in op_calls(ep)] == ["divergen.window_attention.default"]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_fake_implementations_give_shapes_and_dtypes(dtype):
    heads, bn, n, d = 2, 6, 36, 32
    mode = FakeTensorMode()
    (qkv,) = fake_cuda(mode, (bn, n, 3 * heads * d), dtype=dtype)
    q, k, v, do = fake_cuda(mode, *[(bn, heads, n, d)] * 4, dtype=dtype)
    bias, mask = fake_cuda(mode, (heads, n, n), (3, n, n))
    (dout,) = fake_cuda(mode, (bn, n, heads * d), dtype=dtype)
    with mode:
        out = OPS.window_attention_packed(qkv, bias, mask, heads, d)
        dqkv, dbias = OPS.window_attention_packed_backward(qkv, dout, bias, mask, heads, d)
        split = OPS.window_attention(q, k, v, bias, None, d)
        dq, dk, dv, dbias2 = OPS.window_attention_backward(q, k, v, do, bias, None, d)
    assert (out.shape, out.dtype) == ((bn, n, heads * d), dtype)
    assert (dqkv.shape, dqkv.dtype) == (qkv.shape, dtype)
    assert (split.shape, split.dtype) == (q.shape, dtype)
    for g in (dq, dk, dv):
        assert (g.shape, g.dtype) == (q.shape, dtype)
    for db in (dbias, dbias2):
        assert (db.shape, db.dtype) == ((heads, n, n), torch.float32)


def test_ops_have_no_cpu_implementation():
    qkv = torch.zeros(2, 16, 3 * 32)
    bias = torch.zeros(1, 16, 16)
    with pytest.raises(NotImplementedError):
        OPS.window_attention_packed(qkv, bias, None, 1, 32)
    q = torch.zeros(2, 1, 16, 32)
    with pytest.raises(NotImplementedError):
        OPS.window_attention(q, q, q, bias, None, 32)
    # the wrapper takes its plain twin for a CPU tensor and counts nothing
    launches = wa.fused_window_attention_packed.launches
    out = wa.fused_window_attention_packed(qkv, bias, None, 1)
    assert out.shape == (2, 16, 32) and wa.fused_window_attention_packed.launches == launches
