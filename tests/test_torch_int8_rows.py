"""The int8 fused-quant path split in two: the row-quantize pass and the
persistent GEMM's tile plan, on the CPU.

``quantize_rows_fq_reference`` is the plain twin of the CUDA row-quantize
pass that now runs in front of the GEMM in ``int8_matmul_fused_quant``. It is
held bit for bit (no tolerance: the same f32 formulas) against the fused
twin through ``int8_matmul_pallas_reference``, and against the JAX package's
Pallas kernel in interpret mode through a one-hot weight, whose f32 output is
``float(x_q) * scale`` element by element: bit for bit in every row where
XLA's rewrite of ``/ 127.0`` into a product with fl(1 / 127) gives the true
quotient, to one unit in the last place of the scale elsewhere. ``gemm_plan`` is held to cover
every output tile of every int8 GEMM shape of an SDXL UNet call exactly once
in the order the kernel walks the tiles.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from divergen_tpu.ops.pallas import int8_matmul as jint8
from divergen_tpu_torch.ops import int8_matmul as tint8

torch.set_num_threads(1)

DTYPES = {"bfloat16": (torch.bfloat16, jnp.bfloat16), "float32": (torch.float32, jnp.float32)}

# (M, K, N) of the int8 GEMMs of one SDXL UNet call, and ragged shapes
UNET_SHAPES = [shape for shapes in tint8.UNET_INT8_GEMMS.values() for shape in shapes]
PLAN_SHAPES = UNET_SHAPES + [(1000, 656, 1001), (1000, 656, 1004), (77, 48, 3), (77, 48, 12)]


def _edge_rows(m: int, k: int, seed: int) -> np.ndarray:
    """Rows built to hit the quantizer's edges; the rest random."""
    rng = np.random.RandomState(seed)
    x = rng.randn(m, k).astype(np.float32)
    x[1] = 0.0  # all zero: scale 1e-12 / 127, every value 0
    x[2] *= 5e-11 / np.abs(x[2]).max()  # absmax below 1.27e-10: the two scale formulas part
    x[3] *= 3e-13 / np.abs(x[3]).max()  # absmax below 1e-12: the floor
    x[4] = (np.arange(k) % 254 - 127) + 0.5  # absmax 127 (below): scale 1, exact .5 ties
    x[4, 0] = 127.0
    x[5, k // 2] = -2 * np.abs(x[5]).max()  # -absmax: the clip's edge at -127
    x[6, 0] = 2 * np.abs(x[6]).max()  # +absmax: +127
    # values a random scale puts within an ulp of a .5 tie
    amax = np.abs(x[8:]).max(axis=1, keepdims=True)
    ties = (rng.randint(-126, 127, size=(m - 8, k)) + 0.5) * amax / 127
    x[8:] = np.where(rng.rand(m - 8, k) < 0.25, ties, x[8:])
    return x


def _as(x: np.ndarray, dtype: str):
    """The same values as a torch tensor and as a numpy array JAX takes."""
    t = torch.from_numpy(x).to(DTYPES[dtype][0])
    return t, t.float().numpy()


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("m,k,n", [(64, 16, 24), (37, 656, 45)])
def test_pallas_twin_on_quantized_rows_equals_fused_twin(dtype, m, k, n):
    x, _ = _as(_edge_rows(m, k, 0), dtype)
    rng = np.random.RandomState(1)
    w_q = torch.from_numpy(rng.randint(-127, 128, size=(k, n)).astype(np.int8))
    w_s = torch.from_numpy((rng.rand(n) * 0.01 + 1e-4).astype(np.float32))
    x_q, x_scale = tint8.quantize_rows_fq_reference(x)
    assert x_q.dtype == torch.int8 and x_scale.dtype == torch.float32
    assert x_q.shape == (m, k) and x_scale.shape == (m, 1)
    for out_dtype in (torch.bfloat16, torch.float32):
        split = tint8.int8_matmul_pallas_reference(x_q, x_scale, w_q, w_s, out_dtype)
        fused = tint8.int8_matmul_fused_quant_reference(x, w_q, w_s, out_dtype)
        assert torch.equal(split, fused)
    assert int(x_q[1].abs().sum()) == 0
    assert int(x_q[5].min()) == -127 and int(x_q[6].max()) == 127


def _jax_implied_rows(x: np.ndarray):
    """x_q and scale as the Pallas kernel computes them off the TPU: XLA
    rewrites its ``/ 127.0`` into a product with fl(1 / 127), so its scale
    is fl(max(absmax, 1e-12) * fl(1 / 127)), which can sit one unit in the
    last place from the true quotient the port's formula takes; x / scale is
    a true division in both."""
    amax = np.maximum(np.abs(x).max(axis=1, keepdims=True), np.float32(1e-12))
    scale = (amax * (np.float32(1) / np.float32(127))).astype(np.float32)
    return np.clip(np.rint(x / scale), -127, 127), scale


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("k", [16, 656])
def test_rows_twin_vs_pallas_interpret_one_hot(dtype, k):
    """With w_q the identity (padded to N, a multiple of 128) and w_scale 1,
    the Pallas kernel's f32 output is float(x_q) * scale: it is held to the
    x_q and scale that the kernel's formula implies, and the twin to it in
    every row where the true quotient and XLA's product give the same scale.
    Where they part by one unit in the last place (about one row in twenty
    here), the twin's x_q differs from the kernel's only at values within
    1e-4 of a .5 tie, by one."""
    m, n = 128, -(-k // 128) * 128
    x, x_np = _as(_edge_rows(m, k, 2), dtype)
    eye = np.zeros((k, n), np.int8)
    eye[np.arange(k), np.arange(k)] = 1
    ones = np.ones(n, np.float32)
    want = np.asarray(jint8.int8_matmul_fused_quant(
        jnp.asarray(x_np, DTYPES[dtype][1]), jnp.asarray(eye), jnp.asarray(ones),
        out_dtype=jnp.float32, interpret=True))
    np.testing.assert_array_equal(want[:, k:], 0.0)
    j_q, j_scale = _jax_implied_rows(x_np)
    np.testing.assert_array_equal(want[:, :k], (j_q * j_scale).astype(np.float32))

    x_q, x_scale = tint8.quantize_rows_fq_reference(x)
    t_q, t_scale = x_q.numpy().astype(np.float32), x_scale.numpy()
    np.testing.assert_array_equal(
        t_scale, np.maximum(np.abs(x_np).max(axis=1, keepdims=True), np.float32(1e-12))
        / np.float32(127))
    same = (t_scale == j_scale)[:, 0]
    assert same.mean() > 0.8 and same[[1, 4]].all()  # the zero row, the ties at scale 1
    np.testing.assert_array_equal((t_q * t_scale)[same], want[same, :k])
    ulps = np.abs(t_scale.view(np.int32) - j_scale.view(np.int32))
    assert ulps.max() <= 1
    q_over = x_np / j_scale
    near_tie = np.abs(np.abs(q_over - np.floor(q_over)) - 0.5) < 1e-4
    moved = t_q != j_q
    assert not (moved & ~near_tie).any() and np.abs(t_q - j_q).max() <= 1
    # the edge rows: .5 ties rounded to even at scale 1, the clip, the zero row
    np.testing.assert_array_equal(x_q[4, :8].numpy(),
                                  [127, -126, -124, -124, -122, -122, -120, -120])
    assert int(x_q[5].min()) == -127 and int(x_q[6].max()) == 127
    assert int(x_q[1].abs().sum()) == 0


def _walk(m: int, n: int, bn: int, ctas: int):
    """The output tiles, as the kernel's producer and its two consumers walk
    them: block b takes tiles t = b + j * ctas, consumer j % 2 of it
    multiplies and stores tile j; tile t is row tile t % tiles_m and column
    tile t // tiles_m."""
    tiles_m = -(-m // tint8.GEMM_BM)
    tiles = tiles_m * -(-n // bn)
    for b in range(ctas):
        produced = list(range(b, tiles, ctas))
        consumed = [b + j * ctas for c in (0, 1) for j in range(c, len(produced), 2)]
        assert sorted(consumed) == produced
        for t in produced:
            yield (t % tiles_m) * tint8.GEMM_BM, (t // tiles_m) * bn


def test_unet_gemm_launches_per_call():
    """The shape list counts the launches a UNet call makes: 382 and 130."""
    assert len(UNET_SHAPES) == 10
    assert {kernel: sum(shapes.values()) for kernel, shapes in tint8.UNET_INT8_GEMMS.items()} \
        == {"int8_matmul_fused_quant": 382, "int8_matmul_pallas": 130}


@pytest.mark.parametrize("m,k,n", PLAN_SHAPES)
def test_gemm_plan_covers_every_output_tile_once(m, k, n):
    for sms in (132, 114):  # H100 SXM and PCIe
        bn, ctas = tint8.gemm_plan(m, n, sms)
        assert bn in tint8.GEMM_BNS and 1 <= ctas <= sms
        starts = list(_walk(m, n, bn, ctas))
        assert len(starts) == len(set(starts))  # no tile twice
        tiles_m, tiles_n = -(-m // tint8.GEMM_BM), -(-n // bn)
        # the tiles walked are the whole grid, and the grid covers the output
        # with no tile wholly past it
        assert set(starts) == {(i * tint8.GEMM_BM, j * bn)
                               for i in range(tiles_m) for j in range(tiles_n)}
        assert (tiles_m - 1) * tint8.GEMM_BM < m <= tiles_m * tint8.GEMM_BM
        assert (tiles_n - 1) * bn < n <= tiles_n * bn
        assert ctas == min(sms, len(starts))  # one block an SM, none without a tile


def test_gemm_plan_widths_at_the_unet_shapes():
    """On 132 SMs the plan takes the width measured faster at each UNet
    shape: 128 where the busiest block's tiles span fewer columns at that
    width (M 308: one tile either way; (16384, 640, 5120): 39 tiles of 128
    against 32 of 160), 160 elsewhere, ties included."""
    narrow = {(308, 2048, 1280), (308, 2048, 2560), (16384, 640, 5120)}
    for m, k, n in UNET_SHAPES:
        assert tint8.gemm_plan(m, n, 132)[0] == (128 if (m, k, n) in narrow else 160)
