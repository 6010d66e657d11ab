"""The float32 kernels' numerical scheme, emulated on the CPU
(``divergen_tpu_torch/ops/tf32x3.py``).

``csrc/attention_f32.cu`` and the float32 GEMM of ``csrc/ln_matmul.cu`` take
float32 products on the TF32 tensor cores in three passes: each operand is
split into ``big = tf32(x)`` and ``small = tf32(x - big)``, rounded as the
card's ``cvt.rna.tf32.f32``, and a product is ``a_small·b_big + a_big·b_small
+ a_big·b_big``. Held here: the split's bits, its reconstruction of x, and
the three-pass product at the GEMM's depths and an attention at d = 512 over
4096 keys inside the float32 bound ``chip_smoke.py`` holds the kernels to
against float64 (relative L2 <= 1e-5, max |error| <= 1e-4 · max |ref|), while
one TF32 pass falls outside it, so that the bound tells the two apart.
"""
import numpy as np
import pytest
import torch

from divergen_tpu_torch.ops import tf32x3

torch.set_num_threads(1)

# chip_smoke.py: F32_BOUNDS
REL_L2_BOUND, MAX_ABS_BOUND = 1e-5, 1e-4
DEPTHS = [80, 512, 1280, 5120]


def errors(got: torch.Tensor, ref: torch.Tensor):
    diff = got.double() - ref
    return (diff.norm() / ref.norm()).item(), diff.abs().max().item() / ref.abs().max().item()


def within(got, ref) -> bool:
    rel, mx = errors(got, ref)
    return rel <= REL_L2_BOUND and mx <= MAX_ABS_BOUND


def operands(m, k, n, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((k, n)).astype(np.float32))
    return a, b


def test_bounds_are_chip_smokes():
    import chip_smoke

    assert chip_smoke.F32_BOUNDS == dict(rel_l2_bound=REL_L2_BOUND, max_abs_bound=MAX_ABS_BOUND)


def test_big_has_its_low_13_bits_clear():
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(4096).astype(np.float32))
    x = torch.cat([x, x * 1e-30, x * 1e30])
    big, small = tf32x3.split_tf32(x)
    assert int((big.view(torch.int32) & 0x1FFF).abs().sum()) == 0
    assert int((small.view(torch.int32) & 0x1FFF).abs().sum()) == 0


def test_big_plus_small_rebuilds_x_to_2_pow_minus_21():
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(65536).astype(np.float32))
    big, small = tf32x3.split_tf32(x)
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs()).max().item()
    assert rel <= 2.0 ** -21
    # big alone is TF32's own half unit, 2^-11 relative
    assert ((big.double() - x.double()).abs() / x.double().abs()).max().item() <= 2.0 ** -11


@pytest.mark.parametrize("bits,rounded", [
    (0x3F801000, 0x3F802000),   # 1 + half a TF32 unit: a tie, away from zero
    (0xBF801000, 0xBF802000),   # the same, negative
    (0x3F800FFF, 0x3F800000),   # just under the tie: down
    (0x3F801001, 0x3F802000),   # just over: up
    (0x3FFFF000, 0x40000000),   # the carry into the exponent
])
def test_rounding_is_to_nearest_ties_away(bits, rounded):
    x = torch.tensor([bits], dtype=torch.int64).to(torch.int32).view(torch.float32)
    got = tf32x3.round_tf32(x).view(torch.int32).item() & 0xFFFFFFFF
    assert got == rounded


def test_inf_and_nan_pass():
    x = torch.tensor([float("inf"), -float("inf"), float("nan"), 0.0, -0.0])
    got = tf32x3.round_tf32(x)
    assert got[0] == float("inf") and got[1] == -float("inf") and bool(got[2].isnan())
    assert torch.equal(got[3:].view(torch.int32), x[3:].view(torch.int32))


@pytest.mark.parametrize("k", DEPTHS)
def test_three_passes_hold_the_float32_bound(k):
    a, b = operands(16, k, 24, seed=k)
    ref = a.double() @ b.double()
    got = tf32x3.matmul_3xtf32_reference(a, b)
    assert within(got, ref), errors(got, ref)
    # as close as float32's own product, within a factor
    rel_fma = errors(a @ b, ref)[0]
    assert errors(got, ref)[0] <= 4 * rel_fma + 1e-7


@pytest.mark.parametrize("k", DEPTHS)
def test_one_pass_falls_outside_the_float32_bound(k):
    a, b = operands(16, k, 24, seed=k)
    ref = a.double() @ b.double()
    got = tf32x3.matmul_1xtf32_reference(a, b)
    assert not within(got, ref), errors(got, ref)
    assert errors(got, ref)[0] > 1e-4


def attention_case():
    rng = np.random.default_rng(7)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
               for shape in ((4, 512), (4096, 512), (4096, 512)))
    scale = 512 ** -0.5
    s = (q.double() @ k.double().T) * scale
    ref = torch.softmax(s, dim=-1) @ v.double()
    return q, k, v, scale, ref


def test_attention_at_d512_over_4096_keys_holds_the_bound():
    q, k, v, scale, ref = attention_case()
    got = tf32x3.attention_reference(q, k, v, scale)
    assert within(got, ref), errors(got, ref)


def test_attention_in_one_pass_falls_outside_the_bound():
    q, k, v, scale, ref = attention_case()
    got = tf32x3.attention_reference(q, k, v, scale, matmul=tf32x3.matmul_1xtf32_reference)
    assert not within(got, ref), errors(got, ref)


def test_round_tf32_takes_float32_only():
    with pytest.raises(ValueError, match="float32"):
        tf32x3.round_tf32(torch.zeros(3, dtype=torch.float64))
