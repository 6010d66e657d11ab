"""The forward-only kernels refuse to run where autograd records.

Six wrappers launch a kernel with no backward (the JAX kernels have no
``custom_vjp``): ``flash_attention``, ``flash_attention_packed``,
``flash_attention_relpos``, ``fused_ln_matmul``, ``int8_matmul_pallas`` and
``int8_matmul_fused_quant``, and kernel 8 ``fused_gn_silu_conv3x3``. The kernel
writes into a fresh buffer, so a result computed with grad on would be cut off
from the graph with no error. Each calls ``_build.require_no_grad`` before it
launches: it raises when grad mode is on and a tensor argument requires grad,
and passes under ``torch.no_grad()``, under ``inference_mode()`` and for
tensors that do not require grad. Held here on ``meta`` tensors, which reach
the wrappers' rules past the CPU branch (the CPU twins differentiate, as
before); the raise on the card is ``chip_smoke.py``'s.
"""
import pytest
import torch

from divergen_tpu_torch.ops import _build
from divergen_tpu_torch.ops import flash_attention as tfa
from divergen_tpu_torch.ops import int8_matmul as ti8
from divergen_tpu_torch.ops import ln_matmul as tln

torch.set_num_threads(1)


def meta(*shape, dtype=torch.float32, grad=False):
    return torch.empty(*shape, dtype=dtype, device="meta", requires_grad=grad)


def test_the_helper_raises_under_grad_on_a_tensor_that_requires_grad():
    with pytest.raises(RuntimeError, match="kernel_x is forward only.*custom_vjp.*no_grad"):
        _build.require_no_grad("kernel_x", meta(4), meta(4, grad=True))


@pytest.mark.parametrize("context", ["no_grad", "inference_mode", "no tensor requires grad"])
def test_the_helper_passes(context):
    if context == "no_grad":
        with torch.no_grad():
            _build.require_no_grad("k", meta(4, grad=True))
    elif context == "inference_mode":
        with torch.inference_mode():
            _build.require_no_grad("k", meta(4, grad=True))
    else:
        with torch.enable_grad():
            _build.require_no_grad("k", meta(4), None, meta(3, dtype=torch.int8))


def inputs(grad):
    x16 = lambda *s: meta(*s, dtype=torch.bfloat16, grad=grad)
    q = x16(2, 64, 64)
    return {
        "flash_attention": lambda: tfa.flash_attention(q, q, q),
        "flash_attention_packed": lambda: tfa.flash_attention_packed(x16(2, 64, 3 * 128), 2),
        "flash_attention_relpos": lambda: tfa.flash_attention_relpos(
            x16(2, 64, 80), x16(2, 64, 80), x16(2, 64, 80), meta(2, 8, 64), meta(2, 8, 64), (8, 8)),
        "fused_ln_matmul": lambda: tln.fused_ln_matmul(x16(64, 128), x16(128, 256),
                                                       meta(128, grad=grad), meta(128)),
        "int8_matmul_pallas": lambda: ti8.int8_matmul_pallas(
            meta(64, 128, dtype=torch.int8), meta(64, 1, grad=grad),
            meta(128, 256, dtype=torch.int8), meta(256)),
        "int8_matmul_fused_quant": lambda: ti8.int8_matmul_fused_quant(
            x16(64, 128), meta(128, 256, dtype=torch.int8), meta(256)),
    }


@pytest.mark.parametrize("name", list(inputs(False)))
def test_each_forward_only_wrapper_refuses_under_grad(name):
    with torch.enable_grad(), pytest.raises(RuntimeError, match=f"{name} is forward only"):
        inputs(True)[name]()


@pytest.mark.parametrize("name", list(inputs(False)))
def test_each_forward_only_wrapper_goes_on_under_no_grad(name):
    """Past the guard a meta tensor meets the next rule (its device): the
    guard is not what stops it."""
    with torch.no_grad(), pytest.raises(ValueError):
        inputs(True)[name]()
