"""Poisson image editing (host scipy), the 'possion' blend mode.

Counterpart of ``divergen_tpu/data/poisson_blend.py``: ``poisson_edit`` (a
per-channel sparse Laplacian system solved with
``scipy.sparse.linalg.spsolve``) and ``blend_image_host``, whose 'gaussian'
mode is ``cv2.blur`` 5 x 5 on float32, here ``native.box_blur``. The JAX
module's sources: ``DiverGen/divergen/data/transforms/possion_blending.py:
8-64`` as dispatched by ``blend_image`` (custom_cp_method.py:5-22).
Gradient-domain compositing needs a global solve, so it stays on the host;
the device compositor (``ops/copy_paste.py``) covers basic / alpha /
gaussian.
"""
from __future__ import annotations

import numpy as np

from .. import native


def poisson_edit(source: np.ndarray, target: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Blend ``source`` into ``target`` where ``mask``>0, preserving source
    gradients with target boundary conditions. (H,W,3) float images."""
    import scipy.sparse as sp
    from scipy.sparse.linalg import spsolve

    h, w = mask.shape
    m = mask > 0
    idx = -np.ones((h, w), np.int64)
    ys, xs = np.where(m)
    n = len(ys)
    if n == 0:
        return target.copy()
    idx[ys, xs] = np.arange(n)

    rows, cols, vals = [], [], []
    b = np.zeros((n, source.shape[2]), np.float64)
    src = source.astype(np.float64)
    tgt = target.astype(np.float64)
    for k in range(n):
        y, x = ys[k], xs[k]
        rows.append(k)
        cols.append(k)
        vals.append(4.0)
        lap = 4.0 * src[y, x]
        for dy, dx in ((-1, 0), (1, 0), (0, -1), (0, 1)):
            ny, nx = y + dy, x + dx
            if not (0 <= ny < h and 0 <= nx < w):
                lap -= src[y, x]  # replicate border
                continue
            lap -= src[ny, nx]
            if m[ny, nx]:
                rows.append(k)
                cols.append(idx[ny, nx])
                vals.append(-1.0)
            else:
                b[k] += tgt[ny, nx]
        b[k] += lap
    A = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    out = tgt.copy()
    for c in range(source.shape[2]):
        sol = spsolve(A, b[:, c])
        out[ys, xs, c] = np.clip(sol, 0, 255)
    return out.astype(target.dtype)


def blend_image_host(dst_img: np.ndarray, src_img: np.ndarray, mask: np.ndarray,
                     method: str = "basic") -> np.ndarray:
    """Host reference of blend_image (custom_cp_method.py:5-22), incl. the
    Poisson path the device compositor doesn't cover."""
    if method == "possion":
        return poisson_edit(src_img, dst_img, mask)
    if method == "alpha":
        a = mask.astype(np.float32)[..., None]
        return (dst_img * (1 - a) + src_img * a).astype(dst_img.dtype)
    if method == "gaussian":
        w = native.box_blur((mask > 0).astype(np.float32), (5, 5))[..., None]
        return (dst_img * (1 - w) + src_img * w).astype(dst_img.dtype)
    m = (mask > 0)[..., None]
    return np.where(m, src_img, dst_img).astype(dst_img.dtype)
