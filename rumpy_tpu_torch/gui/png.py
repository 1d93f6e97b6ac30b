"""A PNG codec on the standard library (``zlib``, ``struct``) and numpy.

The GUI server's images travel as base64 PNG data URLs. The machines the
port serves on need not have Pillow, so the server encodes and decodes
PNGs itself:

* :func:`encode_png` writes 8-bit grey, RGB or RGBA images, every row with
  one filter type (0 None by default; 1 Sub, 2 Up, 3 Average, 4 Paeth), or
  each row under the filter libpng's heuristic picks, as a browser does;
* :func:`decode_png` reads what a browser canvas sends: 8-bit,
  non-interlaced, grey (colour type 0), grey with alpha (4), RGB (2) or
  RGBA (6), rows under any of the five filters, IDAT split anywhere. Any
  other PNG (a palette, 16-bit samples, Adam7 interlacing) raises
  :class:`PNGError` naming what it holds.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 4: 2, 2: 3, 6: 4}  # colour type -> samples a pixel
_COLOR_TYPE = {c: t for t, c in _CHANNELS.items()}


class PNGError(ValueError):
    """A PNG this codec does not read, or bytes that are not a PNG."""


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    """The Paeth predictor of numpy int16 arrays (left, up, upper left):
    with p = a + b - c, pa = |p - a| = |b - c|, pb = |a - c| and
    pc = |b - c + a - c|."""
    bc, ac = b - c, a - c
    pa, pb, pc = np.abs(bc), np.abs(ac), np.abs(bc + ac)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def encode_png(img: np.ndarray, filter_type=0) -> bytes:
    """A uint8 (H, W), (H, W, 1), (H, W, 2), (H, W, 3) or (H, W, 4) image
    as PNG bytes, every row filtered with ``filter_type`` (0-4), or with
    ``"adaptive"`` each row under the filter whose residuals, read as signed
    bytes, have the least sum of magnitudes: libpng's heuristic, which the
    browsers' canvas encoders use."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise PNGError(f"encode_png takes uint8 images, not {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    if c not in _COLOR_TYPE:
        raise PNGError(f"encode_png takes 1 to 4 channels, not {c}")
    if filter_type not in (0, 1, 2, 3, 4, "adaptive"):
        raise PNGError(f"unknown PNG filter type {filter_type}")
    rows = img.reshape(h, w * c)
    types = np.zeros(h, np.uint8)
    if filter_type != 0:
        x = rows.astype(np.int16)
        left = np.zeros_like(x)
        left[:, c:] = x[:, :-c]
        up = np.zeros_like(x)
        up[1:] = x[:-1]
        if filter_type == "adaptive":
            upleft = np.zeros_like(x)
            upleft[1:, c:] = x[:-1, :-c]
            preds = [0, left, up, (left + up) // 2, _paeth(left, up, upleft)]
            res = np.stack([(x - p) % 256 for p in preds])  # (5, h, w * c)
            types = np.argmin(np.minimum(res, 256 - res).sum(axis=2), axis=0).astype(np.uint8)
            rows = res[types, np.arange(h)].astype(np.uint8)
        else:
            if filter_type == 4:
                upleft = np.zeros_like(x)
                upleft[1:, c:] = x[:-1, :-c]
                pred = _paeth(left, up, upleft)
            else:
                pred = {1: left, 2: up, 3: (left + up) // 2}[filter_type]
            types[:] = filter_type
            rows = ((x - pred) % 256).astype(np.uint8)
    raw = np.concatenate([types[:, None], rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[c], 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes())) + _chunk(b"IEND", b""))


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """The (h, stride) uint8 samples of the filtered rows in ``raw``."""
    if len(raw) < h * (stride + 1):
        raise PNGError(f"PNG image data too short: {len(raw)} bytes for {h} rows "
                       f"of {stride}")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(h, stride + 1)
    types, lines = rows[:, 0], rows[:, 1:]
    if (types > 4).any():
        y = int(np.argmax(types > 4))
        raise PNGError(f"unknown PNG filter type {types[y]} in row {y}")
    if (types >= 3).any():
        return _unfilter_diagonals(types, lines, bpp)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = types[y], lines[y]
        if ftype == 0:
            out[y] = line
        elif ftype == 2:
            out[y] = line + prev  # uint8 arithmetic wraps modulo 256
        else:
            # each channel's running sum along the row, modulo 256
            out[y] = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        prev = out[y]
    return out


def _unfilter_diagonals(types: np.ndarray, lines: np.ndarray, bpp: int) -> np.ndarray:
    """Rows under any of the five filters. A pixel's prediction reads the
    pixels to its left, above and above-left, so every pixel of one
    anti-diagonal (y + x = d) is decoded at once, in bpp-wide lanes: H + W - 1
    numpy steps where a byte loop takes H * W * bpp. The pixels are held
    skewed, ``skew[d + 1, y + 1]`` the pixel (y, d - y), so that a diagonal
    and its three neighbours are slices; the slots of no pixel stay 0, the
    value PNG gives the neighbours outside the image."""
    h, w = lines.shape[0], lines.shape[1] // bpp
    resid = lines.reshape(h, w, bpp).astype(np.int16)
    skew = np.zeros((h + w, h + 1, bpp), np.int16)
    r_skew = np.zeros((h + w - 1, h, bpp), np.int16)
    for y in range(h):
        r_skew[y:y + w, y] = resid[y]
    t_col = types.astype(np.intp)[:, None]
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h, d + 1)
        a, b, c = skew[d, lo + 1:hi + 1], skew[d, lo:hi], skew[d - 1, lo:hi]
        pred = np.choose(t_col[lo:hi], [0, a, b, (a + b) >> 1, _paeth(a, b, c)])
        skew[d + 1, lo + 1:hi + 1] = (r_skew[d, lo:hi] + pred) & 0xFF
    out = np.empty((h, w, bpp), np.uint8)
    for y in range(h):
        out[y] = skew[y + 1:y + 1 + w, y + 1]
    return out.reshape(h, w * bpp)


def decode_png(data: bytes) -> np.ndarray:
    """The (H, W, C) uint8 samples of an 8-bit, non-interlaced grey (C 1),
    grey-alpha (2), RGB (3) or RGBA (4) PNG."""
    if not data.startswith(SIGNATURE):
        raise PNGError("not a PNG image (its first bytes are not the PNG signature)")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PNGError(f"PNG chunk {kind!r} is cut short")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise PNGError("PNG without an IHDR or IDAT chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype == 3:
        raise PNGError("palette PNGs (colour type 3) are not supported: send 8-bit grey, "
                       "RGB or RGBA")
    if ctype not in _CHANNELS:
        raise PNGError(f"unknown PNG colour type {ctype}")
    if depth != 8:
        raise PNGError(f"{depth}-bit PNGs are not supported: send 8-bit samples")
    if interlace:
        raise PNGError("interlaced (Adam7) PNGs are not supported")
    c = _CHANNELS[ctype]
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise PNGError(f"PNG image data does not inflate: {e}") from e
    return _unfilter(raw, h, w * c, c).reshape(h, w, c)
