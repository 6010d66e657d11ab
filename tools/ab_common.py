"""What the A/B tools share (``attention_ab.py``, ``int8_gemm_ab.py``,
``gn_conv_ab.py``, ``ln_matmul_ab.py``, ``window_attention_ab.py``,
``layer_norm_ab.py``): building one kernel source into a library of its own,
and timing several builds in turns on one GPU.

Each tool runs from the root of a checkout as ``python3 tools/<tool>.py``;
importing this module puts the checkout on ``sys.path``.
"""
from __future__ import annotations

import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import device_ms  # noqa: E402
from divergen_tpu_torch.ops import _build  # noqa: E402

TURNS = 3
ORDER = ("earlier", "current", "current", "earlier")


def build(tag: str, name: str, src: Path, report: bool = False, flags=()) -> ctypes.CDLL:
    """nvcc ``src`` alone, with the extra ``flags``, into
    ``build/scratch/<tag>_<name>.so`` (headers from the source's own
    directory first, then ``csrc/``) and load it. With ``report``, print the
    compiler's lines on registers, spills and wgmma."""
    out = ROOT / "build" / "scratch" / f"{tag}_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, *flags, "-I", str(src.parent), "-I",
           str(_build.CSRC), "-shared", "-o", str(out), str(src)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {src}:\n{res.stdout}{res.stderr}")
    if report:
        for line in (res.stdout + res.stderr).splitlines():
            if "registers" in line or "spill" in line or "wgmma" in line.lower():
                print(f"  ptxas ({name}): {line.strip()}", flush=True)
    return ctypes.CDLL(str(out))


def in_turns(fns: dict, timer=device_ms, order=ORDER) -> dict:
    """``{name: (median, runs)}`` of ``timer(fns[name])`` over ``TURNS``
    rounds of ``order``."""
    times = {name: [] for name in fns}
    for _ in range(TURNS):
        for name in order:
            times[name].append(timer(fns[name]))
    return {name: (statistics.median(t), t) for name, t in times.items()}


def checked(code: int) -> None:
    if code:
        raise RuntimeError(f"launch failed with CUDA error {code}")
