"""Swin window attention: hand-written CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/window_attention.py``, forward and
backward: ``fused_window_attention_packed`` reads q, k and v straight out of the fused
(bn, n, 3C) projection and writes (bn, n, C); ``fused_window_attention`` takes
split (B, H, N, D) tensors. Both compute, per window b and head h,

    softmax(q·kᵀ·d^-½ + bias[h] + mask[b % nW]) · v

with the scale applied to the float32 scores after the product, the
probabilities cast to v's dtype before the second product and the result in
the input's dtype. Both launch ``csrc/window_attention.cu`` for a CUDA tensor
and use the plain version in this module, the numerics reference, for a CPU
tensor. A CUDA tensor the kernel cannot take raises: bfloat16 or float32 (as
the TPU kernels take the input's dtype; float32 runs the float32 bodies of
``csrc/attention_f32.cu``: forward and backward products at float32
accuracy on the tensor cores in three TF32 passes), 1 ≤ n ≤ 144, any head
count (there is no lane rule, so six heads take the packed kernel like any
other count), and head dims 1 to 32 in bf16 and 1 to 64 in float32: a head
dim below a body's width (32; 32 or 64, ``attention_f32.kernel_body``) is
zero-padded to it along the head dim with ``F.pad`` before the kernel and
the output sliced after it, so autograd slices dq, dk and dv back; the scale
stays ``1/√d`` of the true d.

The JAX kernels carry a ``custom_vjp``; here each wrapper is a
``torch.autograd.Function`` on a CUDA tensor: its backward launches the
backward kernel of ``csrc/window_attention.cu``, which recomputes the scores
and returns dq, dk, dv (for the packed wrapper in one (bn, n, 3C) buffer) and
the bias gradient summed over windows; the mask gets none. A block of that
kernel takes one head and a chunk of consecutive windows (``backward_plan``
for bfloat16, ``f32_backward_plan`` for the float32 body) and a second small
kernel adds the chunks' partial bias gradients in a fixed order, so two runs
give the same bits. On a CPU tensor ordinary autograd runs through the plain
version. ``reference_window_attention_backward`` (and ``_packed``) repeat the
kernel's arithmetic step by step, bfloat16 casts included (the bf16 kernel
forms the scores as ((bias + mask) / scale + q·kᵀ)·scale, the same float32
values to rounding).

The bf16 forward body, too, gives a block one head and a chunk of
consecutive windows (``forward_plan``): it stages the head's bias in shared
memory once and streams the chunk's q, k, v and masks through TMA buffers,
the next window's behind this one's products. It forms the scores as the
backward recomputes them, ``((bias + mask) / scale + q·kᵀ)·scale``: the same
float32 values to rounding.

Each wrapper counts its kernel launches in plain int attributes: ``.launches``
for the forward kernel and ``.backward_launches`` for the backward kernel;
and in ``.bodies`` and ``.backward_bodies`` by the body that ran (bf16 or
float32) and the caller's head dim (``attention_f32.count``).
"""
from __future__ import annotations

import functools
import math
from collections import Counter
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import _build
from . import attention_f32

KERNEL_MAX_TOKENS = 144  # a 12 x 12 window; the scores of a row stay in registers


def reference_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias: torch.Tensor, mask: Optional[torch.Tensor] = None,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Plain window attention: q/k/v (B, H, N, D), bias (H, N, N), mask
    (nW, N, N) or None with window b taking ``mask[b % nW]``. Products in
    float32, P cast to v's dtype before P·V, output in q's dtype. ``scale``
    by default ``1/√D`` (a head dim padded with zeros keeps its own)."""
    b, h, n, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bhnd,bhmd->bhnm", q.float(), k.float()) * scale
    s = s + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(b // nw, nw, h, n, n) + mask.float()[None, :, None]).reshape(b, h, n, n)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhnm,bhmd->bhnd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def reference_window_attention_packed(qkv: torch.Tensor, bias: torch.Tensor,
                                      mask: Optional[torch.Tensor], heads: int,
                                      scale: Optional[float] = None) -> torch.Tensor:
    """Plain window attention on fused QKV (bn, n, 3C) → (bn, n, C); the
    channel axis is [q | k | v], head-major inside each."""
    bn, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    q, k, v = (qkv[..., s * c:(s + 1) * c].reshape(bn, n, heads, d).permute(0, 2, 1, 3)
               for s in range(3))
    out = reference_window_attention(q, k, v, bias, mask, scale)
    return out.permute(0, 2, 1, 3).reshape(bn, n, c)


def reference_window_attention_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                        bias: torch.Tensor, mask: Optional[torch.Tensor],
                                        do: torch.Tensor):
    """The backward of ``reference_window_attention`` written out as the
    kernel computes it: (dq, dk, dv, dbias) with dq, dk, dv in q's dtype and
    dbias (H, N, N) in float32. Scores and softmax are recomputed in float32;
    p and ds are cast to q's dtype for their products (``dv = pᵀ·do``,
    ``dq = ds·k``, ``dk = dsᵀ·q``), ``dp = do·vᵀ`` and ``ds = p·(dp −
    rowsum(p·dp))`` stay float32, dq and dk take the scale after the product,
    and dbias is the float32 sum of ds over windows. The mask has no gradient."""
    b, h, n, d = q.shape
    scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhnd,bhmd->bhnm", qf, kf) * scale + bias.float()[None]
    if mask is not None:
        nw = mask.shape[0]
        s = (s.reshape(b // nw, nw, h, n, n) + mask.float()[None, :, None]).reshape(b, h, n, n)
    p = torch.softmax(s, dim=-1)
    pc = p.to(q.dtype).float()
    dv = torch.einsum("bhnm,bhnd->bhmd", pc, dof)
    dp = torch.einsum("bhnd,bhmd->bhnm", dof, vf)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dsc = ds.to(q.dtype).float()
    dq = torch.einsum("bhnm,bhmd->bhnd", dsc, kf) * scale
    dk = torch.einsum("bhnm,bhnd->bhmd", dsc, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype), ds.sum(dim=0)


def reference_window_attention_packed_backward(qkv: torch.Tensor, bias: torch.Tensor,
                                               mask: Optional[torch.Tensor], heads: int,
                                               do: torch.Tensor):
    """``reference_window_attention_backward`` on fused QKV (bn, n, 3C) and
    do (bn, n, C): (dqkv (bn, n, 3C), dbias (H, n, n) float32)."""
    bn, n, c3 = qkv.shape
    c = c3 // 3
    d = c // heads
    split = lambda t: t.reshape(bn, n, heads, d).permute(0, 2, 1, 3)
    q, k, v = (split(qkv[..., s * c:(s + 1) * c]) for s in range(3))
    dq, dk, dv, dbias = reference_window_attention_backward(q, k, v, bias, mask, split(do))
    merge = lambda t: t.permute(0, 2, 1, 3).reshape(bn, n, c)
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1), dbias


def _check_bias_mask(bias: torch.Tensor, mask: Optional[torch.Tensor], batch: int,
                     heads: int, n: int) -> None:
    if bias.shape != (heads, n, n):
        raise ValueError(f"bias {tuple(bias.shape)} is not ({heads}, {n}, {n})")
    if mask is not None:
        if mask.dim() != 3 or mask.shape[1:] != (n, n):
            raise ValueError(f"mask {tuple(mask.shape)} is not (nW, {n}, {n})")
        if batch % mask.shape[0]:
            raise ValueError(f"{batch} windows do not cycle over a mask of {mask.shape[0]}")


def _require_kernel_input(name: str, t: torch.Tensor, n: int, strided: bool) -> None:
    """Raise on a non-CPU tensor the kernel cannot take. Its dtype and head
    dim are a body's own: the wrappers take the body from
    :func:`attention_f32.kernel_body` (which raises on any other) and pad to
    its width first, and these rules hold for the padded tensor. The device
    is checked last, so the other rules can be exercised without a card (a
    ``meta`` tensor reaches them)."""
    if not 1 <= n <= KERNEL_MAX_TOKENS:
        raise ValueError(f"{n} tokens per window: the kernel takes 1 to {KERNEL_MAX_TOKENS}")
    if strided:
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{name}: the kernel takes a unit last stride and other "
                             f"strides that are multiples of 8, got {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned data")


def _f32_on(t: Optional[torch.Tensor], device: torch.device) -> Optional[torch.Tensor]:
    if t is None:
        return None
    return t.detach().to(device=device, dtype=torch.float32).contiguous()


BWD_TILE_COUNTS = (1, 2, 4, 7, 9)  # the backward bodies' instances: 16-row tiles a window
SM_SHARED_BYTES = 233472  # shared memory of an H100 multiprocessor that blocks can take
BLOCK_SHARED_BYTES = 232448  # of it, what one block can take
BLOCK_RESERVED_BYTES = 1024  # the runtime's own share of it per block
SM_WARPS = 64
SM_BLOCKS = 32  # blocks a multiprocessor holds at most


def _bwd_tiles(n: int) -> int:
    """16-row tiles of the bf16 backward body that takes ``n`` tokens."""
    return next(t for t in BWD_TILE_COUNTS if 16 * t >= n)


def backward_smem(n: int) -> int:
    """Dynamic shared memory of the bf16 backward body at ``n`` tokens, as
    ``csrc/window_attention.cu:BwdSmem<NT>::kBytes`` lays it out (the library's
    ``dg_window_attention_bwd_smem`` gives the same): q and do of two windows,
    k and v of one (TMA tiles of 64-byte rows), the p and ds tiles in bf16 and
    the bias-gradient sum in f32 (rows padded by 8), three mbarriers, and 512
    bytes to align the swizzled tiles."""
    rows = 16 * _bwd_tiles(n)
    return 6 * rows * 64 + rows * (rows + 8) * (2 + 2 + 4) + 3 * 8 + 512


class BackwardPlan(NamedTuple):
    """The bf16 backward body's grid: block ``i`` takes head ``i % heads`` and
    windows ``[c * per_chunk, min(batch, (c + 1) * per_chunk))`` of chunk
    ``c = i // heads``; ``scratch`` is the shape of the partial bias gradients
    the wrapper allocates (no rows with one chunk: the kernel writes dbias)."""
    chunks: int
    per_chunk: int
    scratch: tuple


def backward_plan(batch: int, heads: int, n: int, device: torch.device,
                  smem: Optional[int] = None) -> BackwardPlan:
    """Chunks of consecutive windows for the bf16 backward body: as many
    chunks per head as fill the blocks the card holds at once (its
    multiprocessors times the blocks that the body's shared memory, by
    default ``backward_smem(n)``, and the warp slots leave on each; one at
    n = 144), then as even as windows divide. Fewer chunks mean fewer partial
    bias gradients to add; one chunk more a head than the slots take would
    double the time of the last wave."""
    smem = backward_smem(n) if smem is None else smem
    resident = max(1, min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                          SM_WARPS // _bwd_tiles(n)))
    return _chunk_plan(batch, heads, n, resident, device)


def _chunk_plan(batch: int, heads: int, n: int, resident: int,
                device: torch.device) -> BackwardPlan:
    """As many chunks per head as fill the card's multiprocessors times
    ``resident`` blocks, then as even as windows divide."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    chunks = max(1, min(batch, sms * resident // heads))
    per = -(-batch // chunks)
    chunks = -(-batch // per)
    return BackwardPlan(chunks, per, (chunks if chunks > 1 else 0, heads, n, n))


F32_BWD_HEAD_DIMS = (32, 64)  # the float32 backward body's instances


def f32_backward_layout(n: int, d: int) -> dict:
    """The float32 backward body at ``n`` tokens and head dim ``d``
    (``csrc/attention_f32.cu:WinBwd<NT, D>``): its warps (warp w takes rows,
    then keys, 16w..), and its shared memory in float offsets: q, k, do and,
    when the four operands fit, v (``rows`` x d floats each, the rows padded
    to whole 16-row tiles), the P / ds tile (``rows`` x ``ld``) and, where it
    fits (``sum_smem``), the chunk's bias-gradient sum (``rows`` x ``rows``).
    With ``swap`` v takes q's room (n > 112). Without ``sum_smem`` (d = 64 at
    n > 112) the sum stays in registers, ``acc`` floats a thread, over twelve
    warps at nine tiles so that a thread holds 54 of them, not 72."""
    if d not in F32_BWD_HEAD_DIMS or not 1 <= n <= KERNEL_MAX_TOKENS:
        raise ValueError(f"no float32 backward body at n = {n}, d = {d}")
    nt = _bwd_tiles(n)
    rows = 16 * nt
    ld = rows + 8
    op, tile, total = rows * d, rows * ld, rows * rows
    size = lambda ops, with_sum: 4 * (ops * op + tile + (total if with_sum else 0))
    sum_smem = size(3, True) <= BLOCK_SHARED_BYTES
    swap = size(4, sum_smem) > BLOCK_SHARED_BYTES
    warps = 12 if not sum_smem and nt == 9 else nt
    offsets = {"q": 0, "k": op, "do": 2 * op, "v": 0 if swap else 3 * op,
               "tile": (3 if swap else 4) * op}
    if sum_smem:
        offsets["sum"] = offsets["tile"] + tile
    return {"rows": rows, "ld": ld, "swap": swap, "sum_smem": sum_smem, "warps": warps,
            "offsets": offsets, "bytes": size(3 if swap else 4, sum_smem),
            "acc": 1 if sum_smem else -(-total // (32 * warps))}


def f32_backward_smem(n: int, d: int) -> int:
    """Dynamic shared memory of the float32 backward body (the library's
    ``dg_window_attention_bwd_f32_smem`` gives the same)."""
    return f32_backward_layout(n, d)["bytes"]


def f32_backward_resident(n: int, d: int) -> int:
    """Blocks of the float32 backward body a multiprocessor holds at once, as
    its shared memory, warp slots and block slots allow (the body's launch
    bounds keep its registers from allowing fewer;
    ``dg_window_attention_bwd_f32_resident`` asks the card)."""
    lay = f32_backward_layout(n, d)
    return max(1, min(SM_SHARED_BYTES // (lay["bytes"] + BLOCK_RESERVED_BYTES),
                      SM_WARPS // lay["warps"], SM_BLOCKS))


def f32_backward_plan(batch: int, heads: int, n: int, d: int, device: torch.device,
                      resident: Optional[int] = None) -> BackwardPlan:
    """Chunks of consecutive windows for the float32 backward body, as
    ``backward_plan`` cuts them for the bf16 one: block ``i`` takes head
    ``i % heads`` and the windows of chunk ``i // heads``; as many chunks per
    head as fill the blocks the card holds at once (by default
    ``f32_backward_resident(n, d)`` a multiprocessor; one at n = 144)."""
    resident = f32_backward_resident(n, d) if resident is None else resident
    return _chunk_plan(batch, heads, n, resident, device)


def f32_backward_swizzle(r: int, c: int, d: int, rows_t: bool) -> int:
    """The float offset of element (row r, channel c) of a q, k, v or do
    operand in the float32 backward body's shared memory (``swz``): rows of d
    floats, the 4-float chunks of row r permuted by XOR with ``r % 8`` (k, v)
    or, with ``rows_t`` (q, do), ``2 (r % 4) + (r // 4) % 2``."""
    x = 2 * (r & 3) + ((r >> 2) & 1) if rows_t else r & 7
    return r * d + (c ^ (x << 2))


# what a forward block spends before its windows stream, in windows: staging
# its head's bias (83 KB from L2 at n = 144) and its first loads, which
# nothing hides
FWD_BLOCK_START = 2


def forward_smem(n: int) -> int:
    """Dynamic shared memory of the bf16 forward body at ``n`` tokens, as
    ``csrc/window_attention.cu:FwdSmem<NT>::kBytes`` lays it out (the
    library's ``dg_window_attention_fwd_smem`` gives the same): q, k and v of
    two windows (TMA tiles of 64-byte rows), the head's bias in f32 (row
    stride 16 mod 32 floats), one window's mask in f32 as in memory, four
    mbarriers, and 512 bytes to align the swizzled tiles."""
    rows = 16 * _bwd_tiles(n)
    return 2 * 3 * rows * 64 + rows * (rows | 16) * 4 + rows * rows * 4 + 4 * 8 + 512


def forward_resident(n: int, smem: Optional[int] = None) -> int:
    """Blocks of the bf16 forward body at ``n`` tokens that a multiprocessor
    holds at once: as its shared memory (by default ``forward_smem(n)``) and
    warp slots allow (the body's launch bounds keep its registers from
    allowing fewer; ``dg_window_attention_fwd_resident`` asks the card)."""
    smem = forward_smem(n) if smem is None else smem
    return max(1, min(SM_SHARED_BYTES // (smem + BLOCK_RESERVED_BYTES),
                      SM_WARPS // _bwd_tiles(n), SM_BLOCKS))


class ForwardPlan(NamedTuple):
    """The bf16 forward body's grid: block ``i`` takes head ``i % heads`` and
    windows ``[c * per_chunk, min(batch, (c + 1) * per_chunk))`` of chunk
    ``c = i // heads``, in window order (``forward_walk``)."""
    chunks: int
    per_chunk: int


@functools.lru_cache(maxsize=256)
def _forward_grid(batch: int, heads: int, slots: int) -> ForwardPlan:
    best, last = None, 0
    for per in range(1, batch + 1):  # chunks fall as per grows
        chunks = -(-batch // per)
        if chunks == last:
            continue  # as many chunks as a shorter one: no better
        last = chunks
        cost = -(-(chunks * heads) // slots) * (per + FWD_BLOCK_START)
        if best is None or cost <= best[0]:
            best = (cost, chunks, per)
    return ForwardPlan(best[1], best[2])


def forward_plan(batch: int, heads: int, n: int, device: torch.device,
                 smem: Optional[int] = None) -> ForwardPlan:
    """Chunks of consecutive windows for the bf16 forward body: the grid
    whose blocks, in waves of the card's slots (its multiprocessors times
    ``forward_resident(n, smem)``), finish soonest, a block taking as long as
    its windows plus ``FWD_BLOCK_START``; on a tie, the fewest chunks. No
    partial sums cross chunks, so any plan gives the same bits; this one is a
    function of the shapes and the card's multiprocessor count only."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return _forward_grid(batch, heads, sms * forward_resident(n, smem))


def forward_walk(plan: ForwardPlan, batch: int, heads: int):
    """The body's walk: (block, head, windows in the order the block takes
    them) for every block of ``plan``."""
    for block in range(plan.chunks * heads):
        first = (block // heads) * plan.per_chunk
        yield block, block % heads, list(range(first, min(batch, first + plan.per_chunk)))


def _plan(dtype: torch.dtype, batch: int, heads: int, n: int, d: int,
          device: torch.device) -> BackwardPlan:
    """The grid of the backward body that takes ``dtype``."""
    if dtype == torch.float32:
        return f32_backward_plan(batch, heads, n, d, device)
    return backward_plan(batch, heads, n, device)


class _WindowAttention(torch.autograd.Function):
    """Split layout on CUDA tensors: forward and backward kernels."""

    @staticmethod
    def forward(ctx, q, k, v, bias, mask, body, true_d):
        b, h, n, d = q.shape
        scale = 1.0 / math.sqrt(true_d)
        bias32 = _f32_on(bias, q.device)
        mask32 = _f32_on(mask, q.device)
        out = torch.empty((b, h, n, d), dtype=q.dtype, device=q.device)
        nw = 1 if mask32 is None else mask32.shape[0]
        attention_f32.count(fused_window_attention, body, true_d)
        if q.dtype == torch.float32:
            attention_f32.launch(
                q, k.data_ptr(), v.data_ptr(), out, batch=b, heads=h, sq=n, sk=n, d=d,
                q_strides=q.stride()[:3], kv_strides=k.stride()[:3], o_strides=out.stride()[:3],
                bias_mode="window", bias=bias32, bias2=mask32, nw=nw, scale=scale)
        else:
            code = _build.lib().dg_window_attention_bf16(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), bias32.data_ptr(),
                None if mask32 is None else mask32.data_ptr(), out.data_ptr(), b, h, n, nw,
                *forward_plan(b, h, n, q.device), *q.stride()[:3], *k.stride()[:3],
                *out.stride()[:3], scale, torch.cuda.current_stream(q.device).cuda_stream)
            _build.check(code, "window attention kernel launch")
        ctx.save_for_backward(q, k, v, bias32, mask32)
        ctx.bias_dtype, ctx.scale, ctx.body, ctx.true_d = bias.dtype, scale, body, true_d
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias32, mask32 = ctx.saved_tensors
        b, h, n, d = q.shape
        do = do.contiguous()
        dq, dk, dv = (torch.empty((b, h, n, d), dtype=q.dtype, device=q.device) for _ in range(3))
        dbias = torch.empty((h, n, n), dtype=torch.float32, device=q.device)
        chunks, per, scratch = _plan(q.dtype, b, h, n, d, q.device)
        partial = torch.empty(scratch, dtype=torch.float32, device=q.device)
        attention_f32.count(fused_window_attention, ctx.body, ctx.true_d, backward=True)
        lib = _build.lib()
        f32 = q.dtype == torch.float32
        entry = lib.dg_window_attention_bwd_f32 if f32 else lib.dg_window_attention_bwd_bf16
        code = entry(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), bias32.data_ptr(),
            None if mask32 is None else mask32.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dbias.data_ptr(), partial.data_ptr(), b, h, n, *((d,) if f32 else ()),
            1 if mask32 is None else mask32.shape[0], chunks, per,
            *q.stride()[:3], *k.stride()[:3], *do.stride()[:3], *dq.stride()[:3],
            ctx.scale, torch.cuda.current_stream(q.device).cuda_stream)
        _build.check(code, "window attention backward kernel launch")
        return dq, dk, dv, dbias.to(ctx.bias_dtype), None, None, None


class _WindowAttentionPacked(torch.autograd.Function):
    """Packed layout on a CUDA tensor: forward and backward kernels."""

    @staticmethod
    def forward(ctx, qkv, bias, mask, heads, body, true_d):
        bn, n, c3 = qkv.shape
        scale = 1.0 / math.sqrt(true_d)
        c = c3 // 3
        bias32 = _f32_on(bias, qkv.device)
        mask32 = _f32_on(mask, qkv.device)
        out = torch.empty((bn, n, c), dtype=qkv.dtype, device=qkv.device)
        nw = 1 if mask32 is None else mask32.shape[0]
        d = c // heads
        attention_f32.count(fused_window_attention_packed, body, true_d)
        if qkv.dtype == torch.float32:
            strides, size = (n * c3, d, c3), qkv.element_size()
            attention_f32.launch(
                qkv, qkv.data_ptr() + c * size, qkv.data_ptr() + 2 * c * size, out, batch=bn,
                heads=heads, sq=n, sk=n, d=d, q_strides=strides, kv_strides=strides,
                o_strides=(n * c, d, c),
                bias_mode="window", bias=bias32, bias2=mask32, nw=nw, scale=scale)
        else:
            code = _build.lib().dg_window_attention_packed_bf16(
                qkv.data_ptr(), bias32.data_ptr(), None if mask32 is None else mask32.data_ptr(),
                out.data_ptr(), bn, n, heads, nw, *forward_plan(bn, heads, n, qkv.device), scale,
                torch.cuda.current_stream(qkv.device).cuda_stream)
            _build.check(code, "packed window attention kernel launch")
        ctx.save_for_backward(qkv, bias32, mask32)
        ctx.heads, ctx.bias_dtype, ctx.scale = heads, bias.dtype, scale
        ctx.body, ctx.true_d = body, true_d
        return out

    @staticmethod
    def backward(ctx, do):
        qkv, bias32, mask32 = ctx.saved_tensors
        bn, n, c3 = qkv.shape
        heads = ctx.heads
        do = do.contiguous()
        dqkv = torch.empty_like(qkv)
        dbias = torch.empty((heads, n, n), dtype=torch.float32, device=qkv.device)
        d = c3 // 3 // heads
        chunks, per, scratch = _plan(qkv.dtype, bn, heads, n, d, qkv.device)
        partial = torch.empty(scratch, dtype=torch.float32, device=qkv.device)
        attention_f32.count(fused_window_attention_packed, ctx.body, ctx.true_d, backward=True)
        lib = _build.lib()
        f32 = qkv.dtype == torch.float32
        entry = (lib.dg_window_attention_packed_bwd_f32 if f32
                 else lib.dg_window_attention_packed_bwd_bf16)
        code = entry(
            qkv.data_ptr(), do.data_ptr(), bias32.data_ptr(),
            None if mask32 is None else mask32.data_ptr(), dqkv.data_ptr(), dbias.data_ptr(),
            partial.data_ptr(), bn, n, heads, *((d,) if f32 else ()),
            1 if mask32 is None else mask32.shape[0], chunks, per, ctx.scale,
            torch.cuda.current_stream(qkv.device).cuda_stream)
        _build.check(code, "packed window attention backward kernel launch")
        return dqkv, dbias.to(ctx.bias_dtype), None, None, None, None


def fused_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window attention on split q/k/v (B, H, N, D) → (B, H, N, D) with bias
    (H, N, N) and an optional mask (nW, N, N), B a multiple of nW.

    q, k and v may be strided views with a unit last stride (for example the
    heads-first slices of a fused (B, N, 3, H, D) projection); k and v must
    share strides. The result is contiguous. Differentiable in q, k, v and
    bias: on CUDA tensors through the backward kernel. A head dim below the
    body's width is zero-padded to it first (module docstring)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    b, h, n, d = q.shape
    _check_bias_mask(bias, mask, b, h, n)
    if q.device.type == "cpu":
        return reference_window_attention(q, k, v, bias, mask)
    body = attention_f32.kernel_body(q.dtype, d, "window")
    if body.width != d:  # F.pad: autograd slices dq, dk and dv back
        q, k, v = (F.pad(t, (0, body.width - d)) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_kernel_input(name, t, n, strided=True)
    if k.stride() != v.stride():
        raise ValueError(f"k and v must share strides, got {k.stride()} and {v.stride()}")
    out = _WindowAttention.apply(q, k, v, bias, mask, body, d)
    return out if body.width == d else out[..., :d].contiguous()


fused_window_attention.launches = 0
fused_window_attention.backward_launches = 0
fused_window_attention.bodies = Counter()
fused_window_attention.backward_bodies = Counter()


def fused_window_attention_packed(qkv: torch.Tensor, bias: torch.Tensor,
                                  mask: Optional[torch.Tensor], heads: int) -> torch.Tensor:
    """Window attention on a fused QKV projection, (bn, n, 3C) → (bn, n, C).

    The channel axis is [q | k | v], H·d channels each; head h of slot s is
    channels [s·C + h·d, s·C + (h+1)·d). bias is (H, n, n), mask (nW, n, n)
    or None with bn a multiple of nW. The kernel reads q, k and v from ``qkv``
    by stride and writes (bn, n, C) directly: no transpose on either side, and
    its backward writes the gradient of ``qkv`` as one (bn, n, 3C) buffer.
    Differentiable in qkv and bias. A head dim below the body's width is
    zero-padded to it per head first, (bn, n, 3, H, width) (module
    docstring)."""
    if qkv.dim() != 3:
        raise ValueError(f"qkv {tuple(qkv.shape)} is not (bn, n, 3C)")
    bn, n, c3 = qkv.shape
    if heads < 1 or c3 % (3 * heads):
        raise ValueError(f"channels {c3} do not split into 3 x {heads} heads")
    _check_bias_mask(bias, mask, bn, heads, n)
    if qkv.device.type == "cpu":
        return reference_window_attention_packed(qkv, bias, mask, heads)
    d = c3 // 3 // heads
    body = attention_f32.kernel_body(qkv.dtype, d, "window")
    if body.width != d:
        qkv = pad_packed(qkv, heads, body.width)
    _require_kernel_input("qkv", qkv, n, strided=False)
    out = _WindowAttentionPacked.apply(qkv, bias, mask, heads, body, d)
    return out if body.width == d else unpad_packed(out, heads, d)


def pad_packed(qkv: torch.Tensor, heads: int, width: int) -> torch.Tensor:
    """A fused (bn, n, 3·H·d) projection with each head's channels
    zero-padded to ``width``, (bn, n, 3·H·width), by ``F.pad``: autograd
    slices the gradient back."""
    bn, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    return F.pad(qkv.reshape(bn, n, 3, heads, d), (0, width - d)).reshape(bn, n, -1)


def unpad_packed(out: torch.Tensor, heads: int, d: int) -> torch.Tensor:
    """The (bn, n, H·width) output of :func:`pad_packed`'s projection as
    (bn, n, H·d)."""
    bn, n, c = out.shape
    return out.reshape(bn, n, heads, c // heads)[..., :d].reshape(bn, n, heads * d)


fused_window_attention_packed.launches = 0
fused_window_attention_packed.backward_launches = 0
fused_window_attention_packed.bodies = Counter()
fused_window_attention_packed.backward_bodies = Counter()
