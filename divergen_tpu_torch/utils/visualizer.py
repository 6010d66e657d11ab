"""Instance-prediction visualizer in numpy (no OpenCV).

Counterpart of ``divergen_tpu/utils/visualizer.py``: the same colours, mask
blend and label text. The JAX module draws with ``cv2.rectangle`` and
``cv2.putText`` (Hershey); here the rectangles (2 px) are drawn in numpy and
the labels with a small embedded 3 x 5 bitmap font shown at twice its size
(lower case as upper case, other characters as a filled box), so the pixels
of the outline and the text are not OpenCV's. The PNG is written with
``utils/png.write_png``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .png import write_png

# rows of each glyph, "#" set: 3 wide, 5 tall
_GLYPHS = {
    "0": "### #.# #.# #.# ###", "1": ".#. ##. .#. .#. ###", "2": "### ..# ### #.. ###",
    "3": "### ..# ### ..# ###", "4": "#.# #.# ### ..# ..#", "5": "### #.. ### ..# ###",
    "6": "### #.. ### #.# ###", "7": "### ..# ..# ..# ..#", "8": "### #.# ### #.# ###",
    "9": "### #.# ### ..# ###", "A": ".#. #.# ### #.# #.#", "B": "##. #.# ##. #.# ##.",
    "C": ".## #.. #.. #.. .##", "D": "##. #.# #.# #.# ##.", "E": "### #.. ##. #.. ###",
    "F": "### #.. ##. #.. #..", "G": ".## #.. #.# #.# .##", "H": "#.# #.# ### #.# #.#",
    "I": "### .#. .#. .#. ###", "J": "..# ..# ..# #.# .#.", "K": "#.# #.# ##. #.# #.#",
    "L": "#.. #.. #.. #.. ###", "M": "#.# ### ### #.# #.#", "N": "##. #.# #.# #.# #.#",
    "O": ".#. #.# #.# #.# .#.", "P": "##. #.# ##. #.. #..", "Q": ".#. #.# #.# ##. .##",
    "R": "##. #.# ##. #.# #.#", "S": ".## #.. .#. ..# ##.", "T": "### .#. .#. .#. .#.",
    "U": "#.# #.# #.# #.# ###", "V": "#.# #.# #.# #.# .#.", "W": "#.# #.# ### ### #.#",
    "X": "#.# #.# .#. #.# #.#", "Y": "#.# #.# .#. .#. .#.", "Z": "### ..# .#. #.. ###",
    " ": "... ... ... ... ...", "%": "#.# ..# .#. #.. #.#", "_": "... ... ... ... ###",
    "-": "... ... ### ... ...", ".": "... ... ... ... .#.", "(": ".#. #.. #.. #.. .#.",
    ")": ".#. ..# ..# ..# .#.", "/": "..# ..# .#. #.. #..", ":": "... .#. ... .#. ...",
    ",": "... ... ... .#. #..", "'": ".#. .#. ... ... ...",
}
_UNKNOWN = "### ### ### ### ###"
_SCALE = 2  # each font pixel is a 2 x 2 block: glyphs 6 x 10, advance 8


def _glyph(ch: str) -> np.ndarray:
    rows = _GLYPHS.get(ch.upper(), _UNKNOWN).split()
    bits = np.array([[c == "#" for c in r] for r in rows], bool)
    return np.kron(bits, np.ones((_SCALE, _SCALE), bool))


def _put_text(img: np.ndarray, text: str, x: int, y: int, color) -> None:
    """Draw ``text`` with its bottom row at ``y`` and left edge at ``x``
    (``cv2.putText``'s origin), clipped to the image."""
    h, w = img.shape[:2]
    gh, gw = 5 * _SCALE, 3 * _SCALE
    top = y - gh + 1
    for i, ch in enumerate(text):
        left = x + i * (gw + _SCALE)
        bits = _glyph(ch)
        y0, y1 = max(top, 0), min(top + gh, h)
        x0, x1 = max(left, 0), min(left + gw, w)
        if y0 >= y1 or x0 >= x1:
            continue
        sub = bits[y0 - top:y1 - top, x0 - left:x1 - left]
        img[y0:y1, x0:x1][sub] = color


def _rectangle(img: np.ndarray, x1: int, y1: int, x2: int, y2: int, color,
               thickness: int = 2) -> None:
    """Outline of the box (x1, y1)–(x2, y2), ``thickness`` pixels, inside the
    corners, clipped to the image."""
    h, w = img.shape[:2]
    xa, xb = max(min(x1, x2), 0), min(max(x1, x2), w - 1)
    ya, yb = max(min(y1, y2), 0), min(max(y1, y2), h - 1)
    if xa > xb or ya > yb:
        return
    t = thickness
    for y in (min(y1, y2), max(y1, y2) - t + 1):  # top and bottom bands
        r0, r1 = max(y, 0), min(y + t, h)
        if r0 < r1:
            img[r0:r1, xa:xb + 1] = color
    for x in (min(x1, x2), max(x1, x2) - t + 1):  # left and right bands
        c0, c1 = max(x, 0), min(x + t, w)
        if c0 < c1:
            img[ya:yb + 1, c0:c1] = color


def _color(i: int) -> tuple:
    rng = np.random.RandomState(i * 7919 + 13)
    c = rng.randint(60, 255, 3)
    return int(c[0]), int(c[1]), int(c[2])


def draw_instance_predictions(
    image: np.ndarray,  # (H, W, 3) RGB uint8
    boxes: np.ndarray,  # (N, 4) xyxy
    scores: Optional[np.ndarray] = None,
    classes: Optional[np.ndarray] = None,
    masks: Optional[np.ndarray] = None,  # (N, H, W) bool
    class_names: Optional[Sequence[str]] = None,
    score_thresh: float = 0.0,
) -> np.ndarray:
    out = image.copy()
    n = len(boxes)
    for i in range(n):
        if scores is not None and scores[i] < score_thresh:
            continue
        cid = int(classes[i]) if classes is not None else 0
        color = _color(cid)
        x1, y1, x2, y2 = [int(round(v)) for v in boxes[i]]
        _rectangle(out, x1, y1, x2, y2, color, 2)
        if masks is not None:
            m = masks[i].astype(bool)
            overlay = out.copy()
            overlay[m] = (0.5 * np.asarray(color) + 0.5 * overlay[m]).astype(np.uint8)
            out = overlay
        label = class_names[cid] if class_names and cid < len(class_names) else str(cid)
        if scores is not None:
            label = f"{label} {scores[i]:.0%}"
        _put_text(out, label, x1, max(y1 - 4, 10), color)
    return out


def save_visualization(path: str, image_rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 RGB image as PNG."""
    write_png(path, np.ascontiguousarray(image_rgb, np.uint8))
