"""Which CUDA body an attention wrapper launches, at which width, and the
launch of the float32 body (``csrc/attention_f32.cu``).

The five attention kernels of ``flash_attention.py`` and
``window_attention.py`` take bfloat16 or float32, as their Pallas kernels
take the input's dtype. bf16 runs each kernel's own body; float32 runs one
float32 body for all of them, whose score bias is a policy (none, dense,
relative position, window), and whose products are float32-accurate: TF32
tensor-core products in three passes (``tf32x3.py``), no operand rounded to
bf16 or taken in one TF32 pass. Any other dtype raises.

The bodies are compiled for a few head dims; the Pallas kernels take any.
:func:`kernel_body` maps (dtype, bias, d) to a body and a kernel width
``dk >= d``: the wrapper hands the body q, k and v zero-padded along the head
dim to ``dk`` (the zero channels add exact zeros to q·kᵀ, and P·0 is 0), keeps
the scale at ``1/√d`` of the true d, and takes the first d output channels.
Where no bf16 body is that wide (the relative-position bias above d = 80),
the float32 body takes a float32 copy. :func:`count` adds a launch to a
wrapper's counts, by body and head dim.

The forward's tile plan is :data:`TC_PLANS` (the body's ``Plan<D>``, which
the library reports through ``dg_attention_f32_plan``); :func:`block_rows`,
:func:`warp_channels` and :func:`pv_slot_key` say which rows, channels and
keys each block, warp and k-slot of the body takes.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from . import _build

F32_HEAD_DIMS = (32, 64, 80, 128, 512)
BIAS_MODES = {"none": 0, "dense": 1, "relpos": 2, "window": 3}
# the bf16 body of each (bias mode, head dim)
BF16_BODIES = {("none", 64): "dg_flash_attention_sm90", ("dense", 64): "dg_flash_attention_sm90",
               ("none", 512): "dg_flash_attention_d512", ("dense", 512): "dg_flash_attention_d512",
               ("relpos", 80): "dg_flash_attention_relpos_bf16",
               ("window", 32): "dg_window_attention_bf16"}
PADDED_HEAD_DIMS = 128  # head dims 1..128 pad up to a body's width; 512 is one
# the window kernels' widths by dtype: their backward bodies'
# (csrc/window_attention.cu at d = 32, csrc/attention_f32.cu at 32 and 64)
WINDOW_WIDTHS = {torch.bfloat16: (32,), torch.float32: (32, 64)}


class Body(NamedTuple):
    """A body for one (dtype, bias mode, head dim): its C entry point, the
    head dim it is launched at (``width >= d``; the channels past d are
    zeros) and the dtype it computes in (the input's, or float32 for a bf16
    input that no bf16 body is wide enough for)."""
    entry: str
    width: int
    dtype: torch.dtype


def _widths(dtype: torch.dtype, bias_mode: str) -> Tuple[int, ...]:
    if bias_mode == "window":
        return WINDOW_WIDTHS[dtype]
    if dtype == torch.float32:
        return F32_HEAD_DIMS
    return tuple(sorted(dd for mode, dd in BF16_BODIES if mode == bias_mode))


def kernel_body(dtype: torch.dtype, d: int, bias_mode: str) -> Body:
    """The body that computes attention of head dim ``d`` with the score bias
    ``bias_mode`` on ``dtype`` q, k and v, at the least width ``>= d`` that a
    body of that dtype has; for bf16 without one (the relative-position bias
    above d = 80), the float32 body's. Head dims 1 to 128 and 512 (the window
    kernels: up to their backward's widest); raises on any other, and on a
    dtype other than bfloat16 or float32."""
    if bias_mode not in BIAS_MODES:
        raise ValueError(f"bias mode {bias_mode!r} not in {tuple(BIAS_MODES)}")
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"the kernel takes bfloat16 or float32, got {dtype}")
    widths = _widths(dtype, bias_mode)
    if bias_mode == "window":
        top = widths[-1]
        if not 1 <= d <= top:
            raise ValueError(f"head dim {d}: the {dtype} window kernels take 1 <= d <= {top} "
                             f"(widths {widths})")
    elif not (1 <= d <= PADDED_HEAD_DIMS or d == 512):
        raise ValueError(f"head dim {d}: the attention kernels take 1 <= d <= "
                         f"{PADDED_HEAD_DIMS} (padded to {dtype} widths {widths}) and d = 512")
    width = next((w for w in widths if w >= d), None)
    if width is None:  # bf16 relpos above d = 80
        return Body("dg_attention_f32", next(w for w in F32_HEAD_DIMS if w >= d), torch.float32)
    if dtype == torch.float32:
        return Body("dg_attention_f32", width, dtype)
    return Body(BF16_BODIES[(bias_mode, width)], width, dtype)


def count(wrapper, body: Body, d: int, backward: bool = False) -> None:
    """One launch of ``wrapper``'s kernel on ``body`` at the caller's head
    dim ``d``: one more in ``wrapper.launches`` (``.backward_launches``) and
    in ``wrapper.bodies`` (``.backward_bodies``) under (``body.entry``, d),
    which tells the bodies and the padded head dims of its launches apart."""
    if backward:
        wrapper.backward_launches += 1
        wrapper.backward_bodies[body.entry, d] += 1
    else:
        wrapper.launches += 1
        wrapper.bodies[body.entry, d] += 1


def pad_head_dim(t: torch.Tensor, body: Body) -> torch.Tensor:
    """``t`` (..., d) as a new contiguous (..., ``body.width``) tensor in
    ``body.dtype``, channels d.. zero: a layout step in front of the body."""
    out = t.new_zeros((*t.shape[:-1], body.width), dtype=body.dtype)
    out[..., :t.shape[-1]] = t
    return out


class TcPlan(NamedTuple):
    """The float32 forward's tiles at one head dim (``csrc/attention_f32.cu``:
    ``Plan<D>``): ``warps_r`` warps split a block's query rows, ``m_tiles``
    16-row tiles each; ``warps_c`` warps split the head dim's channels;
    ``keys`` keys a K/V tile, ``stages`` tiles in flight."""
    warps_r: int
    warps_c: int
    m_tiles: int
    keys: int
    stages: int

    @property
    def rows(self) -> int:
        """Query rows a block."""
        return 16 * self.m_tiles * self.warps_r

    @property
    def warps(self) -> int:
        return self.warps_r * self.warps_c

    def smem(self, d: int) -> int:
        """Shared-memory bytes of a block: the K/V ring (rows padded to d + 4
        floats) and, with the channels split, the block's Q, the warps'
        shares of S (a float4 per lane and fragment) and their sum."""
        ring = self.stages * 2 * self.keys * (d + 4)
        if self.warps_c == 1:
            return 4 * ring
        frags = self.m_tiles * (self.keys // 8) * 32
        return 4 * (ring + self.rows * (d + 4) + 4 * (self.warps + 1) * frags)


# d 32 is the window policy's: n = 144 in three blocks of 48 rows, three tiles of 48 keys
TC_PLANS = {32: TcPlan(3, 1, 1, 48, 3), 64: TcPlan(4, 1, 1, 32, 3), 80: TcPlan(4, 1, 1, 32, 3),
            128: TcPlan(1, 4, 2, 16, 3), 512: TcPlan(1, 8, 2, 16, 2)}


def grid(sq: int, heads: int, batch: int, d: int) -> Tuple[int, int, int]:
    """The forward's blocks: (query-row blocks, heads, batch)."""
    return -(-sq // TC_PLANS[d].rows), heads, batch


def block_rows(block: int, warp: int, sq: int, d: int) -> List[int]:
    """The query rows that ``warp`` of row block ``block`` computes and
    stores (rows past ``sq`` are computed on zeros and not stored)."""
    plan = TC_PLANS[d]
    first = block * plan.rows + 16 * plan.m_tiles * (warp // plan.warps_c)
    return [r for r in range(first, first + 16 * plan.m_tiles) if r < sq]


def warp_channels(warp: int, d: int) -> List[int]:
    """The head-dim channels over which ``warp`` sums its share of q·kᵀ and
    whose output columns it stores."""
    plan = TC_PLANS[d]
    width = d // plan.warps_c
    return list(range((warp % plan.warps_c) * width, (warp % plan.warps_c + 1) * width))


def pv_slot_key(slot: int) -> int:
    """The key (0-7, within its 8-key slab) at k-slot ``slot`` of P·V's
    m16n8k8 product: the tf32 A fragment holds k-slots t and t + 4 where the
    S accumulator holds keys 2t and 2t + 1, so P is fed from the accumulator
    as it stands and V's rows are read in this order."""
    if not 0 <= slot < 8:
        raise ValueError(f"slot {slot} not in 0..7")
    return 2 * (slot % 4) + slot // 4


def launch(q: torch.Tensor, k_ptr: int, v_ptr: int, out: torch.Tensor, *, batch: int,
           heads: int, sq: int, sk: int, d: int, q_strides: Sequence[int],
           kv_strides: Sequence[int], o_strides: Sequence[int], bias_mode: str = "none",
           bias: Optional[torch.Tensor] = None, bias2: Optional[torch.Tensor] = None,
           bias_strides: Sequence[int] = (0, 0, 0), grid=(0, 0), nw: int = 1,
           scale: float = 1.0) -> torch.Tensor:
    """The float32 body on checked CUDA float32 operands: q from ``q`` (its
    data pointer), k and v at the given addresses, all (batch, head, row)
    strided with a unit channel stride, k and v sharing ``kv_strides``; into
    ``out`` at ``o_strides``. ``bias`` and ``bias2`` as ``bias_mode`` reads
    them (``csrc/attention_f32.cu:dg_attention_f32``)."""
    code = _build.lib().dg_attention_f32(
        q.data_ptr(), k_ptr, v_ptr, out.data_ptr(), None if bias is None else bias.data_ptr(),
        None if bias2 is None else bias2.data_ptr(), BIAS_MODES[bias_mode], d, batch, heads,
        sq, sk, *q_strides, *kv_strides, *o_strides, *bias_strides, *grid, nw, scale,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(code, f"float32 attention ({bias_mode} bias, d = {d}) kernel launch")
    return out
