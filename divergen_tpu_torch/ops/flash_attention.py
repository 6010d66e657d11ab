"""Flash attention: hand-written CUDA kernel on the card, plain torch on the CPU.

Counterpart of ``divergen_tpu/ops/pallas/flash_attention.py``:
``flash_attention`` ((BH, S, D), optional dense bias),
``flash_attention_packed`` (self-attention straight out of a fused
(B, N, 3C) QKV projection) and ``flash_attention_relpos`` (global attention
over a token grid with the decomposed relative-position bias of ViTDet and
SAM). All launch a hand-written CUDA kernel for a CUDA tensor and use the
plain version in this module, the numerics reference, for a CPU tensor. A
CUDA tensor the kernel cannot take raises. The head dim picks the body:
d = 64 (SDXL) runs ``csrc/flash_attention_sm90.cu`` (TMA, wgmma, three
consumer warpgroups taking turns), d = 512 (the VAE)
``csrc/flash_attention_d512.cu`` (TMA, wgmma, the channels split over two
consumer warpgroups that sum their shares of the scores), the
relative-position kernel at d = 80 (SAM) ``csrc/flash_attention_relpos_sm90.cu``
(TMA, wgmma, two consumer warpgroups taking turns, the bias started in the
score accumulator). Each takes bf16 or float32, as the TPU kernels take the
input's
dtype: float32 q, k and v (a float32 model's attention) run the float32 body
``csrc/attention_f32.cu`` (float32-accurate products on the tensor cores in
three TF32 passes, ``tf32x3.py``, at head dims 32, 64, 80, 128 and 512), and
the output is in q's dtype; any other dtype raises. Every head dim from 1 to
128, and 512, runs: ``attention_f32.kernel_body`` names the body and its
width, and the wrapper zero-pads q, k and v along the head dim to that width
first (the packed kernel through kernel 3's path, as the Pallas
``flash_attention_packed`` sends a width it cannot tile to
``flash_attention``); other head dims raise.

The three are forward only, as the JAX kernels (no ``custom_vjp``): on a CUDA
tensor each raises where autograd would record it
(``_build.require_no_grad``), so call them under ``torch.no_grad()`` or
``inference_mode()``; the CPU twins differentiate.

Each wrapper counts its kernel launches in a plain int attribute
(``flash_attention.launches``, ``flash_attention_packed.launches``,
``flash_attention_relpos.launches``), and in ``.bodies`` by the body that ran
and the caller's head dim (``attention_f32.count``).
"""
from __future__ import annotations

import math
from collections import Counter
from typing import Iterator, NamedTuple, Optional, Tuple

import torch

from . import _build
from . import attention_f32

SM90_HEAD_DIM = 64  # head dim of flash_attention_sm90.cu (bf16)
SM90_TILE = 192  # q rows a work item of that body (its kBQ: 3 warpgroups of 64)
D512_TILE = 64  # q rows a work item of flash_attention_d512.cu (its kRows)
# flash_attention_relpos_sm90.cu (its kD, kBQ, kBK, kStages): head dim, q rows
# of a work item (2 consumer warpgroups of 64), keys of a K tile, stages of
# the K/V ring; checked against the library by chip_smoke.py, and the plan of
# the body is mirrored in tests/test_torch_relpos_plan.py
RELPOS_HEAD_DIM = 80
RELPOS_TILE = 128
RELPOS_BK = 128
RELPOS_STAGES = 4
SOFTMAX_MODES = ("exact", "rawmax")  # the same math; the TPU's bf16exp is not ported


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Plain softmax attention, q/k/v (BH, S, D): products in f32, P cast to
    v's dtype before the P@V product, output in q's dtype. ``scale`` by
    default ``1/√D`` (a head dim padded with zeros keeps its own)."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    if bias is not None:
        s = s + bias.float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def reference_attention_packed(qkv: torch.Tensor, heads: int) -> torch.Tensor:
    """Plain self-attention on fused QKV (B, N, 3C) → (B, N, C)."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    qh, kh, vh = (qkv[..., s * heads * d:(s + 1) * heads * d].reshape(b, n, heads, d)
                  for s in range(3))
    s = torch.einsum("bnhd,bmhd->bhnm", qh.float(), kh.float()) / math.sqrt(d)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhnm,bmhd->bnhd", p.to(vh.dtype).float(), vh.float())
    return out.to(qkv.dtype).reshape(b, n, heads * d)


def relpos_dense_bias(bias_h_t: torch.Tensor, bias_w_t: torch.Tensor) -> torch.Tensor:
    """The (BH, N, N) bias of the factors bias_h_t (BH, H, N) and bias_w_t
    (BH, W, N): ``bias[b, q, k = u·W + v] = bias_h_t[b, u, q] + bias_w_t[b, v, q]``."""
    bh, h, n = bias_h_t.shape
    bias = bias_h_t[:, :, None, :] + bias_w_t[:, None, :, :]  # (BH, H, W, N)
    return bias.reshape(bh, n, n).transpose(1, 2)


def reference_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               bias_h_t: torch.Tensor, bias_w_t: torch.Tensor,
                               hw: Tuple[int, int], scale: Optional[float] = None) -> torch.Tensor:
    """Plain attention with the decomposed relative-position bias: q/k/v
    (BH, N, D); bias_h_t (BH, H, N); bias_w_t (BH, W, N); N = H·W. The bias of
    query q against key (u, v) is ``bias_h_t[b, u, q] + bias_w_t[b, v, q]``.
    ``scale`` by default ``1/√D``."""
    d = q.shape[-1]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale
    s = s + relpos_dense_bias(bias_h_t, bias_w_t).float()
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p.to(v.dtype).float(), v.float()).to(q.dtype)


def _require_kernel_input(name: str, t: torch.Tensor, strided: bool = False) -> None:
    """Raise on a non-CPU tensor the kernel cannot take. Its dtype and head
    dim are a body's own: the wrappers take the body from
    :func:`attention_f32.kernel_body` (which raises on any other) and pad to
    its width first, and these rules hold for the padded tensor."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA or CPU tensor, got {t.device}")
    if strided:
        if t.stride(-1) != 1 or any(st % 8 for st in t.stride()[:-1]):
            raise ValueError(f"{name}: the kernel takes a unit last stride and other "
                             f"strides that are multiples of 8, got {t.stride()}")
    elif not t.is_contiguous():
        raise ValueError(f"{name}: the kernel takes a contiguous tensor")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel needs 16-byte aligned data")


class TilePlan(NamedTuple):
    """How a wgmma body covers one call. Its work items are (q tiles of
    ``rows`` rows, heads, batch), q tiles fastest; a persistent grid of at
    most one block an SM walks them, block i taking items i, i + blocks, ...
    q, k and v are read through maps of (``width`` channels, rows, batch),
    and head h of a slot is the head dim's channels from ``c0 + h * head_c``
    of that slot."""
    items: Tuple[int, int, int]
    width: int
    q_c0: int
    k_c0: int
    v_c0: int
    head_c: int
    rows: int = SM90_TILE

    def blocks(self, sms: int) -> int:
        return min(math.prod(self.items), sms)

    def boxes(self, sms: int) -> Iterator[Tuple[int, Tuple[int, int, int],
                                                Tuple[int, int, int], int, int]]:
        """Per block and item: (block, (q tile, head, batch), the (channel,
        row, batch) origin of the q box, the channels of the k and v boxes),
        as the kernel computes them (``csrc/flash_attention_sm90.cu``,
        ``csrc/flash_attention_d512.cu``)."""
        tiles, heads, _ = self.items
        blocks = self.blocks(sms)
        for block in range(blocks):
            for w in range(block, math.prod(self.items), blocks):
                t, h, b = w % tiles, (w // tiles) % heads, w // (tiles * heads)
                yield (block, (t, h, b), (self.q_c0 + h * self.head_c, t * self.rows, b),
                       self.k_c0 + h * self.head_c, self.v_c0 + h * self.head_c)


def relpos_smem() -> int:
    """Dynamic shared memory of a block of the body: two Q buffers and the
    K/V ring, 80 channels a row, and 1024 bytes to align them to the
    128-byte swizzle's atoms (its ``kSmem``)."""
    row = RELPOS_HEAD_DIM * 2
    return 2 * RELPOS_TILE * row + 2 * RELPOS_STAGES * RELPOS_BK * row + 1024


def _rows(d: int) -> int:
    """q rows a work item of the body that takes head dim ``d``."""
    return D512_TILE if d == 512 else SM90_TILE


def packed_plan(batch: int, n: int, channels: int, heads: int) -> TilePlan:
    """The plan of a fused (batch, n, 3 * channels) projection: one map over
    all 3C channels, q, k and v at channel offsets 0, C and 2C."""
    d = channels // heads
    rows = _rows(d)
    return TilePlan((-(-n // rows), heads, batch), 3 * channels, 0, channels, 2 * channels, d,
                    rows)


def bhsd_plan(bh: int, sq: int, d: int) -> TilePlan:
    """The plan of (BH, S, D) q, k and v: a map of (D, S, BH) each, one head."""
    rows = _rows(d)
    return TilePlan((-(-sq // rows), 1, bh), d, 0, 0, 0, 0, rows)


def _launch_wgmma(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, plan: TilePlan, d: int,
                  sq: int, sk: int, out: torch.Tensor, o_strides, bias=None,
                  bias_strides=(0, 0, 0), scale: Optional[float] = None) -> None:
    """The bf16 wgmma body of head dim ``d`` (64 or 512) on q, k and v of
    shape (batch, rows, width) (the same tensor for a packed projection),
    into ``out``, a caller's buffer addressed by ``o_strides`` (batch, head,
    row); ``scale`` by default ``1/√d``."""
    if max(sq, sk, math.prod(plan.items)) >= 2**31:
        raise ValueError(f"attention of {sq} queries x {sk} keys in {plan.items} work items: "
                         "the kernel counts rows and work items in 32-bit ints")
    lib = _build.lib()
    entry = lib.dg_flash_attention_sm90 if d == SM90_HEAD_DIM else lib.dg_flash_attention_d512
    sms = torch.cuda.get_device_properties(out.device).multi_processor_count
    code = entry(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), None if bias is None else bias.data_ptr(),
        out.data_ptr(), plan.items[2], plan.items[1], sq, sk, plan.width, q.stride(0),
        plan.width, k.stride(0), plan.q_c0, plan.k_c0, plan.v_c0, plan.head_c, *o_strides,
        *bias_strides, 1.0 / math.sqrt(d) if scale is None else scale,
        int(out.dtype == torch.float32),
        plan.blocks(sms), torch.cuda.current_stream(out.device).cuda_stream,
    )
    _build.check(code, f"flash attention (d = {d}) kernel launch")


def _packed_into(qkv: torch.Tensor, heads: int, out: torch.Tensor) -> torch.Tensor:
    """Launches the wgmma body on a checked CUDA ``qkv`` (B, N, 3C) into
    ``out``, a (B, N, C) view with a unit channel stride that the caller
    allocates (a view of a larger buffer is fine)."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    o_strides = (out.stride(0), d, out.stride(1))
    if qkv.dtype == torch.float32:
        c, size = c3 // 3, qkv.element_size()
        strides = (qkv.stride(0), d, qkv.stride(1))
        return attention_f32.launch(
            qkv, qkv.data_ptr() + c * size, qkv.data_ptr() + 2 * c * size, out, batch=b,
            heads=heads, sq=n, sk=n, d=d, q_strides=strides, kv_strides=strides,
            o_strides=o_strides, scale=1.0 / math.sqrt(d))
    _launch_wgmma(qkv, qkv, qkv, packed_plan(b, n, c3 // 3, heads), d, n, n, out, o_strides)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention over (BH, S, D): q (BH, Sq, D), k/v (BH, Sk, D), optional
    bias broadcastable to (BH, Sq, Sk). Keys are never padded in memory: the
    kernel masks the ragged last K tile by index."""
    if q.device.type == "cpu":
        return reference_attention(q, k, v, bias)
    bh, sq, d = q.shape
    sk = k.shape[1]
    if k.shape != (bh, sk, d) or v.shape != k.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if sq == 0 or sk == 0:
        raise ValueError("empty sequence")
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    mode = "none" if bias is None else "dense"
    body = attention_f32.kernel_body(q.dtype, d, mode)
    _build.require_no_grad("flash_attention", q, k, v, bias)
    dtype, copied = q.dtype, body.width != d or body.dtype != q.dtype
    if copied:
        q, k, v = (attention_f32.pad_head_dim(t, body) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_kernel_input(name, t)
    out = torch.empty_like(q)
    attention_f32.count(flash_attention, body, d)
    _flash_into(q, k, v, bias, out, 1.0 / math.sqrt(d))
    return out[..., :d].to(dtype).contiguous() if copied else out


def _flash_into(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                bias: Optional[torch.Tensor], out: torch.Tensor,
                scale: Optional[float] = None) -> torch.Tensor:
    """Launches the kernel on checked CUDA q, k, v (BH, S, D) into ``out``, a
    (BH, Sq, D) view with a unit last stride that the caller allocates (a
    view of a larger buffer is fine); ``scale`` by default ``1/√D``."""
    bh, sq, d = q.shape
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    sk = k.shape[1]
    bias_strides = (0, 0, 0)
    if bias is not None:
        bias = bias.to(device=q.device, dtype=torch.float32).expand(bh, sq, sk)
        if bias.stride(-1) != 1:
            bias = bias.contiguous()
        bias_strides = (bias.stride(0), 0, bias.stride(1))
    o_strides = (out.stride(0), 0, out.stride(1))
    if q.dtype == torch.float32:
        return attention_f32.launch(
            q, k.data_ptr(), v.data_ptr(), out, batch=bh, heads=1, sq=sq, sk=sk, d=d,
            q_strides=(q.stride(0), 0, q.stride(1)), kv_strides=(k.stride(0), 0, k.stride(1)),
            o_strides=o_strides, bias_mode="none" if bias is None else "dense", bias=bias,
            bias_strides=bias_strides, scale=scale)
    _launch_wgmma(q, k, v, bhsd_plan(bh, sq, d), d, sq, sk, out, o_strides, bias, bias_strides,
                  scale)
    return out


flash_attention.launches = 0
flash_attention.bodies = Counter()


def flash_attention_packed(qkv: torch.Tensor, heads: int,
                           softmax_mode: str = "exact") -> torch.Tensor:
    """Self-attention on a fused QKV projection, (B, N, 3C) → (B, N, C).

    The channel axis is [q | k | v], H·d channels each; head h of slot s is
    channels [s·C + h·d, s·C + (h+1)·d). The kernel reads q, k and v from
    ``qkv`` by stride and writes (B, N, C) directly: no transpose on either
    side. ``softmax_mode`` is ``"exact"`` or ``"rawmax"``, which are the same
    math (the TPU kernel's two orderings of the scale and the running max)."""
    if softmax_mode not in SOFTMAX_MODES:
        raise ValueError(f"softmax_mode {softmax_mode!r} not in {SOFTMAX_MODES}")
    b, n, c3 = qkv.shape
    if c3 % (3 * heads):
        raise ValueError(f"channels {c3} do not split into 3 x {heads} heads")
    if qkv.device.type == "cpu":
        return reference_attention_packed(qkv, heads)
    c = c3 // 3
    d = c // heads
    body = attention_f32.kernel_body(qkv.dtype, d, "none")
    _build.require_no_grad("flash_attention_packed", qkv)
    if body.width == d and body.dtype == qkv.dtype:
        _require_kernel_input("qkv", qkv)
        out = torch.empty((b, n, c), dtype=qkv.dtype, device=qkv.device)
        attention_f32.count(flash_attention_packed, body, d)
        return _packed_into(qkv, heads, out)
    # a width the body cannot read by stride: kernel 3's path
    x = packed_heads(qkv, heads, body)
    for name, t in zip("qkv", x):
        _require_kernel_input(name, t)
    out = torch.empty_like(x[0])
    attention_f32.count(flash_attention_packed, body, d)
    _flash_into(x[0], x[1], x[2], None, out, 1.0 / math.sqrt(d))
    return packed_merge(out, b, d, qkv.dtype)


def packed_heads(qkv: torch.Tensor, heads: int, body: attention_f32.Body) -> torch.Tensor:
    """A fused (B, N, 3·H·d) projection as kernel 3's (3, B·H, N, width)
    operands in ``body.dtype``, each head's channels zero-padded to the
    body's width: the layout step of :func:`flash_attention_packed` at a
    head dim that its body cannot read by stride."""
    b, n, c3 = qkv.shape
    d = c3 // (3 * heads)
    x = qkv.new_zeros((3, b, heads, n, body.width), dtype=body.dtype)
    x[..., :d] = qkv.reshape(b, n, 3, heads, d).permute(2, 0, 3, 1, 4)
    return x.view(3, b * heads, n, body.width)


def packed_merge(out: torch.Tensor, batch: int, d: int, dtype: torch.dtype) -> torch.Tensor:
    """Kernel 3's (B·H, N, width) output of :func:`packed_heads`' operands
    as the (B, N, H·d) result in ``dtype``."""
    bh, n, width = out.shape
    heads = bh // batch
    out = out.view(batch, heads, n, width)[..., :d].permute(0, 2, 1, 3)
    return out.to(dtype).reshape(batch, n, heads * d)


flash_attention_packed.launches = 0
flash_attention_packed.bodies = Counter()


def flash_attention_relpos(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           bias_h_t: torch.Tensor, bias_w_t: torch.Tensor,
                           hw: Tuple[int, int]) -> torch.Tensor:
    """Global self-attention over an H × W token grid with the decomposed
    relative-position bias, ``softmax(q·kᵀ/√d + bias)·v`` with
    ``bias[b, q, k=(u, v)] = bias_h_t[b, u, q] + bias_w_t[b, v, q]``.

    q/k/v are (BH, N, D) with N = H·W, bias_h_t (BH, H, N), bias_w_t
    (BH, W, N) float32; the result is (BH, N, D) in q's dtype. The (N, N)
    bias is never built: the kernel rebuilds it per score tile from the two
    factors. Any H, W ≥ 1.

    q/k/v may also be 4-D views (B, heads, N, D) with a unit last stride, for
    example slices of a fused (B, N, 3, heads, D) projection permuted to
    heads-first: the kernel reads them by stride, the factors are then
    (B, heads, H|W, N) or (B·heads, H|W, N), and the result is a
    (B, heads, N, D) view of a (B, N, heads·D) buffer, so that
    ``out.permute(0, 2, 1, 3).reshape(B, N, heads·D)`` copies nothing."""
    h, w = hw
    if q.dim() not in (3, 4) or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    n, d = q.shape[-2:]
    if h < 1 or w < 1 or n != h * w:
        raise ValueError(f"{n} tokens are not an {h} x {w} grid")
    bh = q.shape[:-2].numel()
    bias_h_t = bias_h_t.reshape(bh, h, n)
    bias_w_t = bias_w_t.reshape(bh, w, n)
    if q.device.type == "cpu":
        flat = lambda t: t.reshape(bh, n, d)
        out = reference_attention_relpos(flat(q), flat(k), flat(v), bias_h_t, bias_w_t, hw)
        return out.reshape(q.shape)
    if not q.dtype == k.dtype == v.dtype:
        raise ValueError(f"q, k, v dtypes {q.dtype}, {k.dtype}, {v.dtype} differ")
    body = attention_f32.kernel_body(q.dtype, d, "relpos")
    _build.require_no_grad("flash_attention_relpos", q, k, v, bias_h_t, bias_w_t)
    dtype, copied = q.dtype, body.width != d or body.dtype != q.dtype
    if copied:
        q, k, v = (attention_f32.pad_head_dim(t, body) for t in (q, k, v))
    for name, t in (("q", q), ("k", k), ("v", v)):
        _require_kernel_input(name, t, strided=True)
    if k.stride() != v.stride():
        raise ValueError(f"k and v must share strides, got {k.stride()} and {v.stride()}")

    def buffer(width, dt):
        if q.dim() == 3:
            return torch.empty((bh, n, width), dtype=dt, device=q.device)
        batch, heads = q.shape[:2]
        return torch.empty((batch, n, heads, width), dtype=dt, device=q.device).permute(0, 2, 1, 3)

    out = buffer(body.width, body.dtype)
    attention_f32.count(flash_attention_relpos, body, d)
    _relpos_into(q, k, v, bias_h_t, bias_w_t, hw, out, 1.0 / math.sqrt(d))
    if not copied:
        return out
    return buffer(d, dtype).copy_(out[..., :d])


def _relpos_into(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias_h_t: torch.Tensor,
                 bias_w_t: torch.Tensor, hw: Tuple[int, int], out: torch.Tensor,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Launches the kernel on checked CUDA q, k, v ((BH, N, D) or
    (B, heads, N, D), k and v sharing strides) and (BH, H|W, N) factors into
    ``out``, a view of q's shape with a unit last stride that the caller
    allocates (a view of a larger buffer is fine); ``scale`` by default
    ``1/√D``."""
    h, w = hw
    n, d = q.shape[-2:]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    f32 = dict(device=q.device, dtype=torch.float32)
    bias_h_t = bias_h_t.to(**f32).contiguous()
    bias_w_t = bias_w_t.to(**f32).contiguous()
    if q.dim() == 3:
        batch, heads = q.shape[0], 1
        strides = lambda t: (t.stride(0), 0, t.stride(1))
    else:
        batch, heads = q.shape[:2]
        strides = lambda t: (t.stride(0), t.stride(1), t.stride(2))
    if q.dtype == torch.float32:
        return attention_f32.launch(
            q, k.data_ptr(), v.data_ptr(), out, batch=batch, heads=heads, sq=n, sk=n, d=d,
            q_strides=strides(q), kv_strides=strides(k), o_strides=strides(out),
            bias_mode="relpos", bias=bias_h_t, bias2=bias_w_t, grid=(h, w), scale=scale)
    code = _build.lib().dg_flash_attention_relpos_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), bias_h_t.data_ptr(), bias_w_t.data_ptr(),
        out.data_ptr(), batch, heads, h, w, d, *strides(q), *strides(k), *strides(out),
        scale, torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(code, "flash attention (relative position) kernel launch")
    return out


flash_attention_relpos.launches = 0
flash_attention_relpos.bodies = Counter()
