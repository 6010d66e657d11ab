"""Float32 through the attention kernels: which body each wrapper launches.

The five attention kernels take bfloat16 or float32 on the card, as their
Pallas kernels take the input's dtype. ``ops/attention_f32.py:kernel_body``
is the dispatch every wrapper goes through (``flash_attention``,
``flash_attention_packed``, ``flash_attention_relpos`` and both window
wrappers): float32 reaches the float32 body ``csrc/attention_f32.cu``, whose
products are float32 (no operand is rounded to bf16 on the way), bfloat16
the kernel's own body, and any other dtype raises. Head dims between the
bodies' widths are padded up (held in ``test_torch_head_dims.py``). The float32 plain twins
are held against the Pallas kernels in interpret mode by
``test_torch_ops.py``, ``test_torch_relpos.py`` and
``test_torch_window_attention.py``; the float32 body against those twins on
the card by ``chip_smoke.py``. ``graft_entry.entry()`` computes in float32 on
the card, as the JAX ``entry()`` does.
"""
import pytest
import torch

from divergen_tpu_torch import graft_entry
from divergen_tpu_torch.ops import attention_f32 as af
from divergen_tpu_torch.ops import flash_attention as tfa
from divergen_tpu_torch.ops import window_attention as twa

torch.set_num_threads(1)

# (head dim, bias mode) -> the bf16 body: what each wrapper asks for
CASES = {
    "flash_attention_packed d64": (64, "none", "dg_flash_attention_sm90"),
    "flash_attention d64": (64, "none", "dg_flash_attention_sm90"),
    "flash_attention d64 bias": (64, "dense", "dg_flash_attention_sm90"),
    "flash_attention d512": (512, "none", "dg_flash_attention_d512"),
    "flash_attention d512 bias": (512, "dense", "dg_flash_attention_d512"),
    "flash_attention_relpos d80": (80, "relpos", "dg_flash_attention_relpos_bf16"),
    "window attention d32": (32, "window", "dg_window_attention_bf16"),
}


@pytest.mark.parametrize("case", list(CASES))
def test_float32_takes_the_float32_body(case):
    d, mode, _ = CASES[case]
    assert af.kernel_body(torch.float32, d, mode).entry == "dg_attention_f32"


@pytest.mark.parametrize("case", list(CASES))
def test_bfloat16_takes_the_kernels_own_body(case):
    d, mode, body = CASES[case]
    assert af.kernel_body(torch.bfloat16, d, mode).entry == body


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64, torch.int8])
@pytest.mark.parametrize("case", ["flash_attention d64", "flash_attention_relpos d80",
                                  "window attention d32"])
def test_other_dtypes_raise(case, dtype):
    d, mode, _ = CASES[case]
    with pytest.raises(ValueError, match="bfloat16 or float32"):
        af.kernel_body(dtype, d, mode).entry


@pytest.mark.parametrize("dtype,d,mode", [(torch.float32, 200, "none"),
                                          (torch.bfloat16, 129, "dense"),
                                          (torch.bfloat16, 48, "window")])
def test_head_dims_without_a_body_raise(dtype, d, mode):
    """Head dims 1 to 128 and 512 pad up to a body (``test_torch_head_dims.py``);
    past them, and past the window kernels' widths, the dispatch raises."""
    with pytest.raises(ValueError, match=f"head dim {d}"):
        af.kernel_body(dtype, d, mode).entry


def test_every_float32_head_dim_of_a_kernel_has_the_body():
    for d, mode in [(64, "none"), (512, "dense"), (80, "relpos"), (32, "window")]:
        assert d in af.F32_HEAD_DIMS and af.kernel_body(torch.float32, d, mode).entry
    with pytest.raises(ValueError, match="bias mode"):
        af.kernel_body(torch.float32, 64, "alibi").entry


def test_no_float32_path_rounds_to_bf16():
    """The module that rounded float32 q, k and v to bf16 before the wgmma
    bodies no longer has that step."""
    assert not hasattr(tfa, "bf16_operand")


def meta(*shape, dtype):
    return torch.empty(*shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_window_wrappers_take_float32_up_to_the_device_check(dtype):
    """On a ``meta`` tensor (neither CPU nor CUDA) every rule before the
    device check passes for bf16 and float32 alike."""
    bias = torch.zeros(3, 16, 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        twa.fused_window_attention_packed(meta(4, 16, 288, dtype=dtype), bias, None, 3)
    q = meta(4, 3, 16, 32, dtype=dtype)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        twa.fused_window_attention(q, q, q, bias, None)


class _Built(Exception):
    pass


def test_entry_computes_in_float32_on_the_card(monkeypatch):
    """``entry()`` on a CUDA device builds the float32 model (``cfg.FP16``
    off), as the JAX ``entry()``."""
    seen = {}

    def build(cfg, **kw):
        seen["cfg"], seen["kw"] = cfg, kw
        raise _Built

    monkeypatch.setattr(graft_entry, "entry_device", lambda device: torch.device("cuda"))
    monkeypatch.setattr(graft_entry, "build_model", build)
    with pytest.raises(_Built):
        graft_entry.entry()
    assert seen["cfg"].FP16 is False
    assert seen["kw"]["device"] == torch.device("cuda")
