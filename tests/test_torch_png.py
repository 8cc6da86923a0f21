"""The port's PNG reader (``mnc_tpu_torch/utils/png.py``) against
``cv2.imread`` (``IMREAD_COLOR``: BGR uint8), bit for bit.

The files are written by cv2 (grey, BGR, BGRA at 8 and 16 bits, and 1-bit
bilevel) and by this file's writer, which covers what cv2 does not write:
every colour type at every bit depth PNG allows (palette and grey +
alpha among them) with each of the five row filters, at odd widths.  The
reader goes by the signature: PNG bytes under a ``.jpg`` name decode
without cv2, a JPEG without cv2 is an error that names the file, and what
the reader does not decode (interlaced, ``eXIf``, corrupt data) is an
error, not a near-match.  ``data.loader.load_image`` reads through it.
"""

import struct
import sys
import zlib

import cv2
import numpy as np
import pytest

from mnc_tpu_torch.utils import png
import tests.torch_threads  # noqa: F401,E402  (torch threads per xdist worker)

# (colour type, bit depth, samples a pixel)
TYPES = [(0, 1, 1), (0, 2, 1), (0, 4, 1), (0, 8, 1), (0, 16, 1), (2, 8, 3), (2, 16, 3),
         (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1), (4, 8, 2), (4, 16, 2), (6, 8, 4),
         (6, 16, 4)]
SIZES = [(1, 1), (5, 7), (17, 33), (9, 64)]


def encode(pixels: np.ndarray, color_type: int | None = None, bit_depth: int = 8,
           palette: np.ndarray | None = None, filters=(0,), level: int = 6) -> bytes:
    """Any PNG the reader decodes, of ``pixels`` in the PNG's own channel
    order: (H, W) grey or palette indices, (H, W, 2) grey + alpha, (H, W, 3)
    RGB, (H, W, 4) RGBA;
    uint8, or uint16 at ``bit_depth`` 16.  ``color_type`` defaults from the
    channels (3 with a ``palette``, an (N, 3) uint8 RGB table); row ``y``
    takes filter ``filters[y % len(filters)]``."""
    px = np.asarray(pixels)
    if px.ndim == 2:
        px = px[..., None]
    h, w, ch = px.shape
    if color_type is None:
        color_type = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    if png._CHANNELS[color_type] != ch or bit_depth not in png._DEPTHS[color_type]:
        raise ValueError(f"colour type {color_type} at {bit_depth} bits: {ch} channels given")
    if bit_depth == 16:
        rows = px.astype(">u2").reshape(h, w * ch).view(np.uint8).reshape(h, -1)
    elif bit_depth == 8:
        rows = px.astype(np.uint8).reshape(h, w * ch)
    else:
        per = 8 // bit_depth
        vals = np.zeros((h, -(-w // per) * per), np.uint8)
        vals[:, :w] = px[..., 0]
        shifts = np.arange(8 - bit_depth, -1, -bit_depth, dtype=np.uint8)
        rows = np.bitwise_or.reduce(vals.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)
    bpp = max(1, png._CHANNELS[color_type] * bit_depth // 8)
    out, prior = [], np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        cur = rows[y].astype(np.int32)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        ftype = filters[y % len(filters)]
        if ftype == 0:
            f = cur
        elif ftype == 1:
            f = cur - left
        elif ftype == 2:
            f = cur - prior
        elif ftype == 3:
            f = cur - (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prior), np.abs(p - upleft)
            f = cur - np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([ftype]) + (f & 0xFF).astype(np.uint8).tobytes())
        prior = cur

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    body = chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0))
    if color_type == 3:
        body += chunk(b"PLTE", np.asarray(palette, np.uint8).reshape(-1, 3).tobytes())
    return (png.PNG_SIGNATURE + body + chunk(b"IDAT", zlib.compress(b"".join(out), level))
            + chunk(b"IEND", b""))


def _write(tmp_path, name, data):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    return path


def _encoded(rs, ctype, depth, ch, h, w, filters):
    top = (1 << depth) - 1
    palette = None
    if ctype == 3:
        palette = rs.randint(0, 256, (min(top + 1, 200), 3)).astype(np.uint8)
        top = len(palette) - 1
    px = rs.randint(0, top + 1, (h, w, ch)).astype(np.uint16 if depth == 16 else np.uint8)
    return encode(px, ctype, depth, palette, filters=filters)


@pytest.mark.parametrize("ctype,depth,ch", TYPES, ids=[f"type{t}-{d}bit" for t, d, _ in TYPES])
def test_every_colour_type_and_filter_equals_cv2(tmp_path, ctype, depth, ch):
    rs = np.random.RandomState(ctype * 100 + depth)
    for h, w in SIZES:
        for f in range(5):
            path = _write(tmp_path, f"{h}x{w}_{f}.png",
                          _encoded(rs, ctype, depth, ch, h, w, (f, (f + 2) % 5, f)))
            want = cv2.imread(path)
            got = png.imread(path)
            assert got.dtype == np.uint8 and got.shape == want.shape == (h, w, 3)
            np.testing.assert_array_equal(got, want, err_msg=f"{h}x{w} filter {f}")


@pytest.mark.parametrize("ch,dtype", [(1, np.uint8), (3, np.uint8), (4, np.uint8),
                                      (1, np.uint16), (3, np.uint16), (4, np.uint16)],
                         ids=["grey8", "bgr8", "bgra8", "grey16", "bgr16", "bgra16"])
def test_cv2_written_pngs_equal_cv2(tmp_path, ch, dtype):
    """cv2's own writer (its filter choice, 16-bit samples cut to the high
    byte, alpha dropped), at odd widths and a photo-sized image."""
    rs = np.random.RandomState(ch)
    for h, w in SIZES + [(37, 50)]:
        im = rs.randint(0, np.iinfo(dtype).max + 1, (h, w, ch)).astype(dtype)
        path = str(tmp_path / f"{h}x{w}.png")
        assert cv2.imwrite(path, im[..., 0] if ch == 1 else im)
        np.testing.assert_array_equal(png.imread(path), cv2.imread(path))
    y, x = np.mgrid[0:75, 0:100]  # a smooth picture, where cv2's filters predict
    im = cv2.GaussianBlur(np.stack([(x + y) % 256, 2 * x % 256, (3 * y + x) % 256], -1)
                          .astype(np.uint8), (5, 5), 0)
    path = str(tmp_path / "smooth.png")
    cv2.imwrite(path, im, [cv2.IMWRITE_PNG_COMPRESSION, 9])
    np.testing.assert_array_equal(png.imread(path), cv2.imread(path))
    bilevel = (rs.uniform(size=(13, 29)) > 0.5).astype(np.uint8) * 255
    path = str(tmp_path / "bilevel.png")
    cv2.imwrite(path, bilevel, [cv2.IMWRITE_PNG_BILEVEL, 1])
    np.testing.assert_array_equal(png.imread(path), cv2.imread(path))


def test_png_under_a_jpg_name_decodes_by_signature(tmp_path, monkeypatch):
    """A PNG named .jpg (the reference's tree names) reads without cv2, as
    cv2 itself reads it; ``load_image`` and ``imwrite`` go through it."""
    from mnc_tpu_torch.data.loader import load_image

    rs = np.random.RandomState(0)
    bgr = rs.randint(0, 256, (23, 31, 3)).astype(np.uint8)
    path = str(tmp_path / "2008_000001.jpg")
    png.imwrite(path, bgr)
    np.testing.assert_array_equal(cv2.imread(path), bgr)
    monkeypatch.setitem(sys.modules, "cv2", None)  # cv2 does not import from here on

    class One:
        def image_path_at(self, i):
            return path

    np.testing.assert_array_equal(png.imread(path), bgr)
    np.testing.assert_array_equal(load_image(One(), 0), bgr)


def test_jpeg_without_cv2_raises_naming_the_file(tmp_path, monkeypatch):
    path = str(tmp_path / "photo.jpg")
    cv2.imwrite(path, np.zeros((8, 8, 3), np.uint8))
    assert png.imread(path).shape == (8, 8, 3)  # with cv2: cv2's decode
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(RuntimeError, match="photo.jpg.*needs cv2"):
        png.imread(path)
    with pytest.raises(FileNotFoundError):
        png.imread(str(tmp_path / "missing.png"))


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def test_unsupported_and_corrupt_pngs_raise(tmp_path):
    """Interlaced, animated and eXIf PNGs, a bad CRC on a critical chunk,
    short image data and a palette index past the palette: an error naming
    the file, never an image."""
    good = png.encode_png(np.zeros((4, 5, 3), np.uint8))
    ihdr_end = 8 + 12 + 13
    interlaced = bytearray(good)
    interlaced[8 + 8 + 12] = 1  # the interlace byte of IHDR
    interlaced[ihdr_end - 4:ihdr_end] = _chunk(b"IHDR", bytes(interlaced[16:29]))[-4:]
    cases = {
        "interlaced": (bytes(interlaced), "interlaced"),
        "exif": (good[:ihdr_end] + _chunk(b"eXIf", b"MM\x00*") + good[ihdr_end:], "eXIf"),
        "apng": (good[:ihdr_end] + _chunk(b"acTL", bytes(8)) + good[ihdr_end:], "acTL"),
        "crc": (good[:ihdr_end - 1] + bytes([good[ihdr_end - 1] ^ 1]) + good[ihdr_end:],
                "CRC error"),
        "short": (good[:ihdr_end] + _chunk(b"IDAT", zlib.compress(b"\x00" * 7))
                  + _chunk(b"IEND", b""), "too short"),
        "palette": (encode(np.full((2, 2), 3, np.uint8), 3, 8, np.zeros((2, 3), np.uint8)),
                    "palette index 3"),
    }
    for name, (data, msg) in cases.items():
        path = _write(tmp_path, f"{name}.png", data)
        with pytest.raises(png.PNGError, match=msg):
            png.imread(path)
        assert name in str(pytest.raises(png.PNGError, png.imread, path).value)


def test_demo_reads_png_without_cv2_or_pil(tmp_path, monkeypatch):
    """``tools/demo.py::_imread`` falls back to the PNG reader where neither
    cv2 nor PIL imports (the machine with the GPU), so ``demo --im-dir``
    runs there on PNG images; a JPEG there is an error naming the file."""
    from mnc_tpu_torch.tools import demo

    bgr = np.random.RandomState(1).randint(0, 256, (9, 14, 3)).astype(np.uint8)
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, bgr)
    jpg = str(tmp_path / "b.jpg")
    cv2.imwrite(jpg, bgr)
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    np.testing.assert_array_equal(demo._imread(path), bgr)
    with pytest.raises(RuntimeError, match="b.jpg"):
        demo._imread(jpg)
