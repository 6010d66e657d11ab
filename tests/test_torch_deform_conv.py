"""The port's deformable convolution (``ops/deform_conv.py``) against the JAX
function, float32 on the CPU: v1 (no mask) and v2 (a mask), stride 1 and 2,
dilation 2, offsets of several pixels that take taps out of the image and
back. Outputs within 1e-5 of max |reference|; the gradients of a random
projection of the output in the input, the offsets, the mask, the kernel
and the bias (torch autograd against ``jax.grad``) within 2e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.deform_conv import deform_conv2d as jax_deform_conv2d
from divergen_tpu_torch.ops.deform_conv import deform_conv2d
from test_torch_detector import assert_rel_close, t

torch.set_num_threads(1)

CASES = {  # name: (mask, stride, padding, dilation)
    "v1": (False, 1, 1, 1),
    "v2": (True, 1, 1, 1),
    "v1_stride2": (False, 2, 1, 1),
    "v2_stride2": (True, 2, 1, 1),
    "v2_dilation2": (True, 1, 2, 2),
}


def inputs(seed, use_mask, stride, padding, dilation, b=2, h=9, w=11, cin=5, cout=6, k=3):
    rng = np.random.RandomState(seed)
    ho = (h + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    wo = (w + 2 * padding - dilation * (k - 1) - 1) // stride + 1
    arrays = {
        "x": rng.randn(b, h, w, cin).astype(np.float32),
        # several pixels: taps leave the image on every side and come back
        "offset": (3.0 * rng.randn(b, ho, wo, 2 * k * k)).astype(np.float32),
        "kernel": (rng.randn(k, k, cin, cout) / np.sqrt(k * k * cin)).astype(np.float32),
        "bias": rng.randn(cout).astype(np.float32),
        "cot": rng.randn(b, ho, wo, cout).astype(np.float32),
    }
    if use_mask:
        arrays["mask"] = rng.rand(b, ho, wo, k * k).astype(np.float32)
    return arrays


@pytest.mark.parametrize("case", sorted(CASES))
def test_deform_conv_matches_jax(case):
    use_mask, stride, padding, dilation = CASES[case]
    a = inputs(len(case), use_mask, stride, padding, dilation)
    names = ["x", "offset", "kernel", "bias"] + (["mask"] if use_mask else [])
    kw = dict(stride=stride, padding=padding, dilation=dilation)

    def jloss(*vals):
        v = dict(zip(names, vals))
        out = jax_deform_conv2d(v["x"], v["offset"], v["kernel"], mask=v.get("mask"),
                                bias=v["bias"], **kw)
        return jnp.sum(out * a["cot"]), out

    (_, want), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(len(names))),
                                           has_aux=True)(*(jnp.asarray(a[n]) for n in names))
    # the offsets reach far out: some taps are out of the image, some clamped
    off = np.abs(a["offset"])
    assert off.max() > 8 and (off < 1).any()

    tv = {n: t(a[n]).requires_grad_() for n in names}
    got = deform_conv2d(tv["x"], tv["offset"], tv["kernel"], mask=tv.get("mask"),
                        bias=tv["bias"], **kw)
    assert got.shape == want.shape
    assert_rel_close(got.detach().numpy(), np.asarray(want), 1e-5)
    (got * t(a["cot"])).sum().backward()
    for n, jg in zip(names, jgrads):
        assert_rel_close(tv[n].grad.numpy(), np.asarray(jg), 2e-4)


def test_deform_conv_zero_offsets_is_a_convolution():
    """With zero offsets and no mask it is the plain convolution."""
    a = inputs(3, False, 1, 1, 1)
    x, k = t(a["x"]), t(a["kernel"])
    got = deform_conv2d(x, torch.zeros_like(t(a["offset"])), k)
    want = torch.nn.functional.conv2d(x.permute(0, 3, 1, 2), k.permute(3, 2, 0, 1), padding=1)
    assert_rel_close(got.numpy(), want.permute(0, 2, 3, 1).numpy(), 1e-5)


def test_deform_conv_rejects_offset_of_another_grid():
    a = inputs(4, False, 1, 1, 1)
    with pytest.raises(ValueError, match="offset"):
        deform_conv2d(t(a["x"]), t(a["offset"])[:, 1:], t(a["kernel"]), stride=1)
