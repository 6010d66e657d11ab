"""Fused LayerNorm + GEMM: hand-written CUDA kernel on the card, plain torch
on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/ln_matmul.py:fused_ln_matmul``:
``LN(x) @ w (+ bias)`` with the epilogue none, exact-erf GELU (``act="gelu"``)
or GEGLU (``geglu=True``: ``h · gelu(gate)`` over the two halves of the
output columns, writing (M, N/2)). x and w in bf16 or float32, the output in
x's dtype. For a CUDA tensor it launches ``csrc/ln_matmul.cu`` through two C
entry points: ``dg_ln_apply`` (the LayerNorm applied once per element into
(M, K) scratch in x's dtype, :func:`ln_apply_reference`'s y) then the GEMM,
``dg_ln_gemm`` for bf16 (a persistent, warp-specialized wgmma + TMA body;
:func:`gemm_plan` picks its blocks and :func:`weight_rows` says which weight
rows a tile reads) or ``dg_ln_gemm_f32`` for float32: the same body and plan
at float32 accuracy on the TF32 tensor cores in three passes
(``tf32x3.py``), y written by the apply pass as its two TF32 parts and the
weight split into its two by ``dg_tf32_split`` on each call. For a
CPU tensor it runs :func:`ln_matmul_reference`, the plain version
(``_reference`` of the TPU file). A CUDA tensor the kernel cannot take
raises. Launches (one per call, whatever passes the kernel makes) are
counted in ``fused_ln_matmul.launches``. Forward only, as the JAX kernel (no
``custom_vjp``): on a CUDA tensor it raises where autograd would record it
(``_build.require_no_grad``); the CPU twin differentiates.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from . import _build

_EPILOGUES = {"none": 0, "gelu": 1}
_GEGLU = 2
GEMM_BM = 128  # output rows per tile of the bf16 GEMM (csrc/ln_matmul.cu: kBM)
WEIGHT_BOX = 80  # weight rows per TMA box; a tile stacks two (kBox)
# row tiles a group of the bf16 GEMM's tile order sweeps over every column
# tile. On an H100 (tools/ln_matmul_ab.py, device ms): 8 took 0.2599 at SAM's
# (16384, 1280, 3840) against 0.4218 with all 128 row tiles in one group (the
# activation, 42 MB, read again for every column tile past what L2 keeps) and
# 0.2977 with one (the weight swept for every row tile); within 1 % of the
# best of 1, 2, 4, 8, 16 at the other three shapes
GEMM_GROUP = 8
KERNEL_DTYPES = (torch.bfloat16, torch.float32)


def ln_apply_reference(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                       eps: float = 1e-5) -> torch.Tensor:
    """Row LayerNorm with var = E[x²] − E[x]² clamped at 0, in f32, rounded
    to x's dtype: the apply pass's y."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf * xf).mean(-1, keepdim=True) - mean * mean
    y = (xf - mean) * torch.rsqrt(var.clamp_min(0.0) + eps)
    return (y * gamma.float() + beta.float()).to(x.dtype)


def ln_matmul_reference(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, eps: float = 1e-5,
                        bias: Optional[torch.Tensor] = None, geglu: bool = False,
                        act: str = "none") -> torch.Tensor:
    """:func:`ln_apply_reference`, then the product in f32 and the epilogue."""
    y = ln_apply_reference(x, gamma, beta, eps)
    out = y.float() @ w.float()
    if bias is not None:
        out = out + bias.float()
    if geglu:
        h, gate = out.chunk(2, dim=-1)
        out = h * F.gelu(gate)
    elif act == "gelu":
        out = F.gelu(out)
    return out.to(x.dtype)


class GemmPlan(NamedTuple):
    """The GEMM's output tiles, bf16 and float32 alike: ``tiles_m`` row
    tiles of ``GEMM_BM`` by ``tiles_n`` column tiles of ``step`` output
    columns, walked by ``blocks`` persistent blocks in groups of ``group``
    row tiles: a group sweeps every column tile, row tiles fastest inside
    it, so that the blocks in flight share a band of the activation and one
    of the weight, both kept in L2 (``csrc/ln_matmul.cu:tile_of``). Block i
    takes tiles i, i + blocks, … and hands them to its two consumer
    warpgroups in turns (bf16), or gives each of them 64 rows of every tile
    (float32)."""
    tiles_m: int
    tiles_n: int
    step: int
    blocks: int
    group: int

    def tile(self, t: int) -> Tuple[int, int]:
        """(row tile, column tile) of tile ``t``."""
        gi, local = divmod(t, self.group * self.tiles_n)
        rows = min(self.group, self.tiles_m - gi * self.group)
        return gi * self.group + local % rows, local // rows

    def tiles(self, block: int) -> Iterator[Tuple[int, int]]:
        """(row tile, column tile) of each tile of ``block``, in order."""
        for t in range(block, self.tiles_m * self.tiles_n, self.blocks):
            yield self.tile(t)


def gemm_plan(m: int, n: int, geglu: bool, sms: int) -> GemmPlan:
    """The tiles of an (m, K) x (K, n) product on a card of ``sms`` SMs: a
    tile covers 160 output columns, or 80 for GEGLU (its 80 h columns and
    their 80 gate columns fill the same 160-wide product)."""
    step = WEIGHT_BOX if geglu else 2 * WEIGHT_BOX
    out_cols = n // 2 if geglu else n
    tiles_m, tiles_n = -(-m // GEMM_BM), -(-out_cols // step)
    return GemmPlan(tiles_m, tiles_n, step, min(tiles_m * tiles_n, sms), min(GEMM_GROUP, tiles_m))


def weight_rows(u: int, n: int, geglu: bool) -> List[int]:
    """The 160 weight rows (output columns of ``y @ w``, rows of the (N, K)
    operand) that column tile ``u`` stacks in shared memory, as two TMA boxes
    of ``WEIGHT_BOX`` rows: rows 160 u … 160 u + 159, or for GEGLU the h rows
    80 u … 80 u + 79 and then their gate rows N/2 + 80 u …; -1 where a box
    runs past N (TMA's zeros)."""
    step = WEIGHT_BOX if geglu else 2 * WEIGHT_BOX
    second = n // 2 if geglu else WEIGHT_BOX
    rows = [u * step + i for i in range(WEIGHT_BOX)]
    rows += [u * step + second + i for i in range(WEIGHT_BOX)]
    return [r if r < n else -1 for r in rows]


def _apply(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor, eps: float,
           y: torch.Tensor) -> torch.Tensor:
    """The apply pass on a checked CUDA x (M, K) into y: (M, K) bf16 for
    bf16 x; for float32 x (2, M, K), the TF32 parts of the LayerNorm's
    output (``tf32x3.split_tf32`` of :func:`ln_apply_reference`'s y)."""
    m, k = x.shape
    code = _build.lib().dg_ln_apply(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), y.data_ptr(), m, k, eps,
        int(x.dtype == torch.float32), torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(code, "LayerNorm apply pass launch")
    return y


def _split(t: torch.Tensor) -> torch.Tensor:
    """A contiguous CUDA float32 t as (2, *t.shape): its big then its small
    TF32 part (``tf32x3.split_tf32``)."""
    parts = torch.empty((2, *t.shape), device=t.device, dtype=torch.float32)
    code = _build.lib().dg_tf32_split(t.data_ptr(), parts.data_ptr(), t.numel(),
                                      torch.cuda.current_stream(t.device).cuda_stream)
    _build.check(code, "TF32 split launch")
    return parts


def _gemm(y: torch.Tensor, wt: torch.Tensor, bias: Optional[torch.Tensor], out: torch.Tensor,
          epilogue: int) -> torch.Tensor:
    """The GEMM on checked CUDA operands: y from :func:`_apply` ((M, K)
    bf16, or float32's (2, M, K) parts), wt (N, K) in x's dtype, bias (N,)
    f32 or None, into out (M, N or N/2)."""
    m, k = y.shape[-2:]
    n = wt.shape[0]
    stream = torch.cuda.current_stream(y.device).cuda_stream
    bias_ptr = None if bias is None else bias.data_ptr()
    sms = torch.cuda.get_device_properties(y.device).multi_processor_count
    plan = gemm_plan(m, n, epilogue == _GEGLU, sms)
    lib = _build.lib()
    if y.dtype == torch.float32:
        code = lib.dg_ln_gemm_f32(y.data_ptr(), _split(wt).data_ptr(), bias_ptr, out.data_ptr(),
                                  m, n, k, epilogue, plan.blocks, plan.group, stream)
    else:
        code = lib.dg_ln_gemm(y.data_ptr(), wt.data_ptr(), bias_ptr, out.data_ptr(), m, n, k,
                              epilogue, plan.blocks, plan.group, stream)
    _build.check(code, "fused LayerNorm-matmul GEMM launch")
    return out


def fused_ln_matmul(x: torch.Tensor, w: torch.Tensor, gamma: torch.Tensor,
                    beta: torch.Tensor, eps: float = 1e-5,
                    bias: Optional[torch.Tensor] = None, geglu: bool = False,
                    act: str = "none") -> torch.Tensor:
    """LayerNorm(x) @ w (+ bias) [+ GELU or GEGLU epilogue].

    x (M, K), w (K, N), gamma/beta (K,), bias (N,). The kernel reads the
    weight as w.T, (N, K) row-major, which is nn.Linear's layout: passing
    ``linear.weight.t()`` costs no copy; any other layout of w is transposed
    into that one first."""
    if act not in _EPILOGUES:
        raise ValueError(f"act {act!r} not in {tuple(_EPILOGUES)}")
    if x.device.type == "cpu":
        return ln_matmul_reference(x, w, gamma, beta, eps, bias, geglu, act)
    _build.require_no_grad("fused_ln_matmul", x, w, gamma, beta, bias)
    m, k = x.shape
    if w.shape[0] != k:
        raise ValueError(f"x {tuple(x.shape)} and w {tuple(w.shape)} do not chain")
    n = w.shape[1]
    cols = n // 2 if geglu else n
    if x.device.type != "cuda" or w.device != x.device:
        raise ValueError(f"x on {x.device}, w on {w.device}: the kernel needs CUDA")
    if x.dtype not in KERNEL_DTYPES or w.dtype != x.dtype:
        raise ValueError(f"the kernel takes bfloat16 or float32 x and w of one dtype, got "
                         f"{x.dtype}, {w.dtype}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("the kernel takes a contiguous, 16-byte aligned x")
    if k % 8 or n % 8 or (geglu and n % 16):
        raise ValueError(f"K={k}, N={n}: the kernel needs K and the output width "
                         "to be multiples of 8")
    if m == 0:
        raise ValueError("empty input")
    wt = w.t().contiguous()  # a view of nn.Linear's weight: no copy
    if wt.data_ptr() % 16:
        raise ValueError("the kernel needs a 16-byte aligned weight")
    f32 = dict(device=x.device, dtype=torch.float32)
    gamma = gamma.to(**f32).contiguous()
    beta = beta.to(**f32).contiguous()
    if bias is not None:
        bias = bias.to(**f32).contiguous()
    out = torch.empty((m, cols), device=x.device, dtype=x.dtype)
    fused_ln_matmul.launches += 1
    return _into(x, wt, gamma, beta, eps, bias, _GEGLU if geglu else _EPILOGUES[act], out)


def _into(x: torch.Tensor, wt: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
          eps: float, bias: Optional[torch.Tensor], epilogue: int,
          out: torch.Tensor) -> torch.Tensor:
    """The apply pass, then the GEMM, on checked CUDA operands (gamma, beta
    and bias f32) into ``out``, a contiguous (M, N or N/2) tensor in x's
    dtype that the caller allocates (the first rows of a larger one are
    fine)."""
    y = torch.empty((2, *x.shape) if x.dtype == torch.float32 else x.shape, device=x.device,
                    dtype=x.dtype)
    return _gemm(_apply(x, gamma, beta, eps, y), wt, bias, out, epilogue)


fused_ln_matmul.launches = 0
