"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``divergen_tpu_torch/csrc/*.cu`` file is compiled on first use (one
``nvcc`` per source, all started together) and linked into one shared library
under ``build/kernels/`` at the root of the checkout, for ``sm_90a`` (H100),
with a plain C interface. The library's name carries a
hash of the sources and flags, so an edit to any source builds a new one.
Nothing here runs at import time: the CPU tests import every module of the
port, and a machine without ``nvcc`` only fails when a kernel is asked for.

Each C entry point launches on the stream it is given and returns
``cudaGetLastError()``; :func:`check` turns a non-zero code into an error.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_lib = None


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"divergen_kernels_{h.hexdigest()[:16]}.so"


def find_nvcc() -> str:
    """nvcc from PATH, ``$CUDA_HOME`` or the toolkit's default location."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.access(os.path.join(root, "bin", "nvcc"), os.X_OK):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the port's CUDA kernels cannot be built")


def build() -> Path:
    """Compile the kernels if the library for these sources is missing.

    The compiler's report (``-Xptxas -v``: registers, shared memory and
    spills per kernel) is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = {src: BUILD_DIR / f"{tag}.{src.stem}.o" for src in sorted(CSRC.glob("*.cu"))}
    procs = [(subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                               stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), src)
             for src, obj in objs.items()]
    report, failed = "", []
    for proc, src in procs:  # wait for all of them, so that none outlives a failure
        out, _ = proc.communicate()
        report += f"== {src.name}\n{out}"
        if proc.returncode != 0:
            failed.append(src.name)
    tmp = BUILD_DIR / f"{tag}.tmp"
    try:
        if failed:
            raise RuntimeError(f"nvcc failed on {', '.join(failed)}:\n{report}")
        cmd = [nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {res.returncode}:\n{' '.join(cmd)}\n"
                               f"{res.stdout}{res.stderr}")
    finally:
        for obj in objs.values():
            obj.unlink(missing_ok=True)
    so.with_suffix(".log").write_text(report)
    os.replace(tmp, so)  # atomic: a concurrent process never loads a partial file
    return so


def _declare(lib: ctypes.CDLL) -> None:
    p, i, i64, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_float
    lib.dg_flash_attention_bf16.argtypes = [p] * 5 + [i] * 5 + [i64] * 12 + [f, p]
    lib.dg_flash_attention_bf16.restype = i
    lib.dg_flash_attention_relpos_bf16.argtypes = [p] * 6 + [i] * 5 + [i64] * 9 + [f, p]
    lib.dg_flash_attention_relpos_bf16.restype = i
    lib.dg_window_attention_bf16.argtypes = [p] * 6 + [i] * 4 + [i64] * 9 + [f, p]
    lib.dg_window_attention_bf16.restype = i
    lib.dg_window_attention_packed_bf16.argtypes = [p] * 4 + [i] * 4 + [f, p]
    lib.dg_window_attention_packed_bf16.restype = i
    lib.dg_ln_matmul_bf16.argtypes = [p] * 7 + [i] * 3 + [f, i, p]
    lib.dg_ln_matmul_bf16.restype = i
    lib.dg_error_string.argtypes = [i]
    lib.dg_error_string.restype = ctypes.c_char_p


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            loaded = ctypes.CDLL(str(build()))
            _declare(loaded)
            _lib = loaded
    return _lib


def check(code: int, what: str) -> None:
    if code != 0:
        msg = lib().dg_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
