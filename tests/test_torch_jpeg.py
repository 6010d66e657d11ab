"""The port's baseline-JPEG decoder (``divergen_tpu_torch/native/jpeg.cpp``
behind ``utils/image_io.py``) against OpenCV, which the JAX package reads
every image with.

JPEGs are written here with ``cv2.imencode`` (or PIL for what OpenCV cannot
write) from seeded numpy images. ``read_rgb`` must equal
``cvtColor(imdecode(buf, IMREAD_COLOR), BGR2RGB)`` and ``read_gray``
``imdecode(buf, IMREAD_GRAYSCALE)`` bit for bit: every sampling factor at
qualities 50 / 75 / 95 / 100 and at sizes whose edge MCUs are partial,
restart intervals, optimised Huffman tables, SOF1, grey input, an RGB-coded
file, and EXIF orientations 1-8. Modes the port refuses raise ``ValueError``
naming the mode and the file; so does a truncated file, which OpenCV's
``imread`` pads (its ``imdecode`` returns None).
The committed fixtures (``tests/data/jpeg``, ``tools/make_jpeg_fixtures.py``)
decode to their manifest's hashes, which ``chip_smoke.py`` checks on the card.
"""
import hashlib
import io
import json
import os
import struct

import cv2
import numpy as np
import pytest
import torch

from divergen_tpu.data.dataset_mapper import read_image as jread_image
from divergen_tpu_torch import native
from divergen_tpu_torch.data.dataset_mapper import read_image as tread_image
from divergen_tpu_torch.utils import image_io
from divergen_tpu_torch.utils.png import write_png

torch.set_num_threads(1)

FIXTURES = os.path.join(os.path.dirname(__file__), "data", "jpeg")
SAMPLING = {"444": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_444,
            "422": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_422,
            "440": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440,
            "420": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_420,
            "411": cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411}
SIZES = [(1, 1), (17, 33), (479, 641), (2, 3), (9, 16)]


def image(seed, h, w, channels=3):
    """Smooth content with noise (what JPEG is for) or plain noise."""
    rng = np.random.default_rng(seed)
    if seed % 2:
        return rng.integers(0, 256, (h, w, channels)[:3 if channels > 1 else 2]).astype(np.uint8)
    grid = rng.random((max(h // 8, 2), max(w // 8, 2), 3)).astype(np.float32) * 255
    img = cv2.resize(grid, (w, h), interpolation=cv2.INTER_CUBIC) + rng.normal(0, 8, (h, w, 3))
    img = np.clip(img, 0, 255).astype(np.uint8)
    return img if channels == 3 else img[..., 0].copy()


def encode(img, *params):
    ok, buf = cv2.imencode(".jpg", img, list(params))
    assert ok
    return buf.tobytes()


def cv2_rgb(data):
    return cv2.cvtColor(cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR),
                        cv2.COLOR_BGR2RGB)


def cv2_gray(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_GRAYSCALE)


def assert_decodes_like_cv2(data, tmp_path=None):
    np.testing.assert_array_equal(image_io.decode_rgb(data), cv2_rgb(data))
    np.testing.assert_array_equal(native.jpeg_decode(data, gray=True), cv2_gray(data))
    if tmp_path is not None:  # the file path, as cv2.imread
        path = str(tmp_path / "x.jpg")
        with open(path, "wb") as f:
            f.write(data)
        np.testing.assert_array_equal(image_io.read_rgb(path), jread_image(path))
        np.testing.assert_array_equal(image_io.read_gray(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))


@pytest.mark.parametrize("quality", [50, 75, 95, 100])
@pytest.mark.parametrize("sampling", list(SAMPLING))
def test_sampling_and_quality(sampling, quality):
    for k, (h, w) in enumerate(SIZES):
        data = encode(image(k + quality, h, w), cv2.IMWRITE_JPEG_QUALITY, quality,
                      cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling])
        assert_decodes_like_cv2(data)


@pytest.mark.parametrize("sampling", ["444", "422", "420"])
@pytest.mark.parametrize("option", ["restart1", "restart5", "optimize", "restart_optimize"])
def test_restart_markers_and_optimised_tables(tmp_path, sampling, option):
    params = [cv2.IMWRITE_JPEG_QUALITY, 85, cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    if option.startswith("restart"):
        params += [cv2.IMWRITE_JPEG_RST_INTERVAL, 1 if option == "restart1" else 5]
    if "optimize" in option:
        params += [cv2.IMWRITE_JPEG_OPTIMIZE, 1]
    for k, (h, w) in enumerate([(17, 33), (100, 140)]):
        assert_decodes_like_cv2(encode(image(k, h, w), *params), tmp_path)


def test_grey_input(tmp_path):
    for k, (h, w) in enumerate(SIZES):
        data = encode(image(k, h, w, channels=1), cv2.IMWRITE_JPEG_QUALITY, 75)
        rgb = image_io.decode_rgb(data)
        assert rgb.shape == (h, w, 3)  # IMREAD_COLOR replicates grey
        assert_decodes_like_cv2(data, tmp_path)


def test_gray_read_of_colour_is_the_y_plane():
    """IMREAD_GRAYSCALE of a colour JPEG is libjpeg's Y plane, not a BT.601
    mix of the decoded RGB (which the PNG path uses)."""
    data = encode(image(3, 96, 128), cv2.IMWRITE_JPEG_QUALITY, 90)
    gray = native.jpeg_decode(data, gray=True)
    np.testing.assert_array_equal(gray, cv2_gray(data))
    mix = np.round(image_io.decode_rgb(data).astype(np.float32)
                   @ np.array([0.299, 0.587, 0.114], np.float32)).astype(np.uint8)
    assert (mix != gray).any()


def test_sof1_and_rgb_coded():
    data = encode(image(0, 40, 56), cv2.IMWRITE_JPEG_QUALITY, 75)
    i = data.index(b"\xff\xc0")
    assert_decodes_like_cv2(data[:i] + b"\xff\xc1" + data[i + 2:])
    from PIL import Image

    buf = io.BytesIO()  # Adobe transform 0: components are R, G, B
    Image.fromarray(image(1, 40, 56)).save(buf, "JPEG", keep_rgb=True, quality=90)
    assert b"Adobe" in buf.getvalue()
    assert_decodes_like_cv2(buf.getvalue())


def with_orientation(data, orientation, little_endian):
    e = "<" if little_endian else ">"
    tiff = ((b"II" if little_endian else b"MM") + struct.pack(e + "HI", 42, 8)
            + struct.pack(e + "H", 1) + struct.pack(e + "HHIHH", 0x0112, 3, 1, orientation, 0)
            + struct.pack(e + "I", 0))
    app1 = b"Exif\0\0" + tiff
    return data[:2] + b"\xff\xe1" + struct.pack(">H", len(app1) + 2) + app1 + data[2:]


@pytest.mark.parametrize("orientation", range(1, 9))
def test_exif_orientation(tmp_path, orientation):
    """OpenCV applies the Orientation tag in imread and imdecode; so does the port."""
    for little_endian in (True, False):
        for channels in (3, 1):
            base = encode(image(orientation, 17, 30, channels), cv2.IMWRITE_JPEG_QUALITY, 90)
            data = with_orientation(base, orientation, little_endian)
            want = cv2_rgb(data)
            assert want.shape[:2] == ((30, 17) if orientation >= 5 else (17, 30))
            assert_decodes_like_cv2(data, tmp_path)


def patched(data, marker, precision=None):
    i = data.index(b"\xff\xc0")
    out = bytearray(data)
    out[i + 1] = marker
    if precision is not None:
        out[i + 4] = precision
    return bytes(out)


def test_refused_modes_raise_naming_mode_and_file(tmp_path):
    img = image(0, 32, 48)
    base = encode(img, cv2.IMWRITE_JPEG_QUALITY, 75)
    from PIL import Image

    cmyk = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(cmyk, "JPEG")
    cases = {
        "progressive": encode(img, cv2.IMWRITE_JPEG_PROGRESSIVE, 1),
        "arithmetic": patched(base, 0xC9),
        "12-bit": patched(base, 0xC1, precision=12),
        "lossless": patched(base, 0xC3),
        "CMYK": cmyk.getvalue(),
    }
    for mode, data in cases.items():
        path = tmp_path / f"{mode}.jpg"
        path.write_bytes(data)
        for read in (image_io.read_rgb, image_io.read_gray, tread_image):
            with pytest.raises(ValueError, match=mode) as err:
                read(str(path))
            assert str(path) in str(err.value)
    assert cv2.imread(str(tmp_path / "progressive.jpg")) is not None  # OpenCV takes it


def test_truncated_file_raises(tmp_path):
    data = encode(image(0, 120, 160), cv2.IMWRITE_JPEG_QUALITY, 90)
    for cut in (3, 100, len(data) // 2, len(data) - 40, len(data) - 2):
        path = tmp_path / f"cut{cut}.jpg"
        path.write_bytes(data[:cut])
        with pytest.raises(ValueError, match="truncated") as err:
            image_io.read_rgb(str(path))
        assert str(path) in str(err.value)
    # where the port raises, OpenCV's imread warns and returns a padded image
    # (the JAX package's file reads); its imdecode (tar members) returns None
    half = str(tmp_path / f"cut{len(data) // 2}.jpg")
    assert cv2.imread(half, cv2.IMREAD_COLOR).shape == (120, 160, 3)
    assert cv2.imdecode(np.frombuffer(data[: len(data) // 2], np.uint8), 1) is None


def test_dispatch_on_signature(tmp_path):
    img = image(0, 20, 30)
    png_named_jpg = tmp_path / "png_named.jpg"
    write_png(str(tmp_path / "a.png"), img)
    png_named_jpg.write_bytes((tmp_path / "a.png").read_bytes())
    np.testing.assert_array_equal(image_io.read_rgb(str(png_named_jpg)), img)
    jpg_named_png = tmp_path / "jpeg_named.png"
    data = encode(img, cv2.IMWRITE_JPEG_QUALITY, 75)
    jpg_named_png.write_bytes(data)
    np.testing.assert_array_equal(image_io.read_rgb(str(jpg_named_png)), cv2_rgb(data))
    (tmp_path / "x.gif").write_bytes(b"GIF89a" + bytes(32))
    with pytest.raises(ValueError, match="neither a PNG nor a JPEG"):
        image_io.read_rgb(str(tmp_path / "x.gif"))
    with pytest.raises(FileNotFoundError):
        tread_image(str(tmp_path / "missing.jpg"))


def test_committed_fixtures_match_manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    total = 0
    for entry in manifest["files"]:
        path = os.path.join(FIXTURES, entry["file"])
        total += os.path.getsize(path)
        with open(path, "rb") as f:
            data = f.read()
        if "raises" in entry:
            with pytest.raises(ValueError, match=entry["raises"]):
                image_io.read_rgb(path)
            continue
        got = image_io.read_rgb(path)
        assert got.shape == (entry["height"], entry["width"], 3)
        assert hashlib.sha256(got.tobytes()).hexdigest() == entry["sha256_rgb"], entry["file"]
        np.testing.assert_array_equal(got, cv2_rgb(data))
    assert len(manifest["lvis_images"]) == 6 and total < 1_500_000
