"""A PNG reader that gives what ``cv2.imread(path)`` gives, without cv2.

The machine with the GPU has neither cv2 nor PIL, and the reference's
datasets name their images ``<id>.jpg``.  :func:`imread` goes by a file's
signature, as cv2 does, not by its name: a PNG is decoded here with the
standard library's ``zlib`` and the five row filters done in numpy; any
other content goes to ``cv2.imread``, and where cv2 does not import that is
an error that names the file.  Nothing is substituted silently.

What is decoded, and how it matches ``cv2.imread``'s ``IMREAD_COLOR``
(libpng under OpenCV): non-interlaced PNG of every colour type (grey,
RGB, palette, grey + alpha, RGBA) at every bit depth the format allows,
out as (H, W, 3) BGR uint8.  Alpha is dropped without compositing, grey and
palette entries are expanded to BGR, 1/2/4-bit grey is scaled to 8 bits by
bit replication (0x55 and 0x11 multiples), and 16-bit samples keep their
high byte.  Ancillary chunks (gamma, colour profiles, transparency, text)
change nothing, as under cv2.  Interlaced files, animated PNG (``acTL``)
and ``eXIf`` (cv2 would apply its orientation) are refused with an error,
as are corrupt files: a bad CRC on a critical chunk, an unknown critical
chunk, short image data or a palette index past the palette's end.

:func:`encode_png` and :func:`imwrite` write 8-bit RGB PNG, for trees made
without cv2 and the demo's overlays.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# samples per pixel of each colour type
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}


class PNGError(ValueError):
    """A PNG this reader refuses: corrupt, or outside what it decodes."""


def is_png(data: bytes) -> bool:
    return data[:8] == PNG_SIGNATURE


def _chunks(data: bytes, name: str):
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) < length or len(crc) < 4:
            raise PNGError(f"{name}: truncated {kind!r} chunk")
        if struct.unpack(">I", crc)[0] != zlib.crc32(kind + body) & 0xFFFFFFFF:
            if kind[0] & 0x20 == 0:  # critical: libpng stops there
                raise PNGError(f"{name}: CRC error in the {kind.decode('latin-1')} chunk")
        else:
            yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return


def _unfilter(raw: np.ndarray, h: int, rowbytes: int, bpp: int, name: str) -> np.ndarray:
    """Reverse the per-row filters of (h, 1 + rowbytes) filtered bytes;
    ``bpp`` is the byte distance to the left neighbour (at least 1)."""
    out = np.zeros((h, rowbytes), np.uint8)
    prior = np.zeros(rowbytes, np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:  # None
            cur = line.copy()
        elif ftype == 1:  # Sub: a running sum per byte lane, mod 256
            pad = (-rowbytes) % bpp
            lanes = np.concatenate([line, np.zeros(pad, np.uint8)]).reshape(-1, bpp)
            cur = np.cumsum(lanes, axis=0, dtype=np.uint8).reshape(-1)[:rowbytes]
        elif ftype == 2:  # Up
            cur = line + prior
        elif ftype in (3, 4):  # Average, Paeth: each byte needs its left neighbour's result
            f, b = line.tolist(), prior.tolist()
            r = [0] * rowbytes
            for x in range(rowbytes):
                a = r[x - bpp] if x >= bpp else 0
                if ftype == 3:
                    r[x] = (f[x] + ((a + b[x]) >> 1)) & 0xFF
                    continue
                c = b[x - bpp] if x >= bpp else 0
                p = a + b[x] - c
                pa, pb, pc = abs(p - a), abs(p - b[x]), abs(p - c)
                pred = a if pa <= pb and pa <= pc else (b[x] if pb <= pc else c)
                r[x] = (f[x] + pred) & 0xFF
            cur = np.asarray(r, np.uint8)
        else:
            raise PNGError(f"{name}: unknown filter type {ftype} in row {y}")
        out[y] = prior = cur
    return out


def decode_png(data: bytes, name: str = "<png bytes>") -> np.ndarray:
    """PNG bytes → (H, W, 3) BGR uint8, as ``cv2.imread`` with
    ``IMREAD_COLOR`` decodes them (see the module docstring)."""
    if not is_png(data):
        raise PNGError(f"{name}: not a PNG (no PNG signature)")
    header = palette = None
    idat = []
    for kind, body in _chunks(data, name):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body[:13])
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind in (b"acTL", b"eXIf"):
            raise PNGError(f"{name}: {kind.decode()} chunk (animated PNG or EXIF orientation) "
                           "is not supported by this reader")
        elif kind not in (b"IEND",) and kind[0] & 0x20 == 0:
            raise PNGError(f"{name}: unknown critical chunk {kind!r}")
    if header is None or not idat:
        raise PNGError(f"{name}: no IHDR or no IDAT chunk")
    w, h, depth, ctype, compression, filt, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype] or compression or filt:
        raise PNGError(f"{name}: invalid header (colour type {ctype}, bit depth {depth})")
    if interlace:
        raise PNGError(f"{name}: interlaced (Adam7) PNG is not supported by this reader")
    if w == 0 or h == 0:
        raise PNGError(f"{name}: empty image {w}x{h}")
    if ctype == 3 and palette is None:
        raise PNGError(f"{name}: palette image without a PLTE chunk")
    bits = _CHANNELS[ctype] * depth
    rowbytes = (w * bits + 7) // 8
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"{name}: corrupt image data ({e})") from None
    if len(raw) < h * (1 + rowbytes):
        raise PNGError(f"{name}: image data too short ({len(raw)} of {h * (1 + rowbytes)} "
                       "bytes)")
    raw = np.frombuffer(raw, np.uint8, h * (1 + rowbytes)).reshape(h, 1 + rowbytes)
    rows = _unfilter(raw, h, rowbytes, max(1, bits // 8), name)

    if depth == 16:  # the high byte of each big-endian sample
        samples = rows[:, 0::2].reshape(h, w, _CHANNELS[ctype])
    elif depth == 8:
        samples = rows.reshape(h, w, _CHANNELS[ctype])
    else:  # 1, 2, 4 bits: one sample a pixel, packed from the most significant bit
        per = 8 // depth
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
        samples = vals.reshape(h, rowbytes * per)[:, :w, None]
        if ctype == 0:  # bit replication: 1 → 255, 2-bit × 0x55, 4-bit × 0x11
            samples = samples * np.uint8(255 // ((1 << depth) - 1))

    if ctype == 3:
        idx = samples[..., 0]
        if int(idx.max()) >= len(palette):
            raise PNGError(f"{name}: palette index {int(idx.max())} past the "
                           f"{len(palette)}-entry palette")
        return np.ascontiguousarray(palette[idx][..., ::-1])
    if ctype in (0, 4):  # grey (+ alpha, dropped) → BGR
        return np.ascontiguousarray(np.repeat(samples[..., :1], 3, axis=2))
    return np.ascontiguousarray(samples[..., 2::-1])  # RGB(A) → BGR, alpha dropped


def imread(path: str) -> np.ndarray:
    """(H, W, 3) BGR uint8 of the image file at ``path``, as
    ``cv2.imread(path)``: PNG content (whatever the file is named) is
    decoded here, anything else by cv2, and where cv2 does not import that
    is an error that names the file."""
    with open(path, "rb") as f:
        data = f.read()
    if is_png(data):
        return decode_png(data, path)
    try:
        import cv2
    except ImportError:
        raise RuntimeError(
            f"{path}: not a PNG, and reading any other format (JPEG, ...) needs cv2, which "
            "does not import here; convert the image to PNG") from None
    im = cv2.imread(path)
    if im is None:
        raise FileNotFoundError(f"cv2 failed to read {path}")
    return im


def encode_png(rgb: np.ndarray) -> bytes:
    """An 8-bit RGB PNG of (H, W, 3) uint8, every row filtered Up (the
    cheapest filter to decode), by the standard library."""
    h, w = rgb.shape[:2]
    rows = np.ascontiguousarray(rgb, np.uint8).reshape(h, w * 3)
    up = np.diff(rows, axis=0, prepend=np.zeros((1, w * 3), np.uint8))  # mod 256
    raw = np.concatenate([np.full((h, 1), 2, np.uint8), up], axis=1)

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw.tobytes())) + chunk(b"IEND", b""))


def imwrite(path: str, bgr: np.ndarray) -> None:
    """Write (H, W, 3) BGR uint8 as an 8-bit RGB PNG at ``path``, whatever
    its extension (``encode_png``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(encode_png(bgr[..., ::-1]))
