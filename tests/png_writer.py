"""Minimal PNG encoder (numpy + zlib) with a chosen filter a row.

Test and smoke-run infrastructure for the port's PNG reader
(videollama2_tpu_torch/media/image_io.py): PIL's encoder never emits the
Average filter (type 3) or Adam7 interlacing, and writes neither 16-bit
color nor 2- and 4-bit gray; the GPU host has no PIL at all. So files are
written here in every color type and bit depth, plain or Adam7, with every
filter type (None, Sub, Up, Average, Paeth) in turn. The filtered bytes
are computed from whole arrays, since encoding (unlike decoding) reads
only original pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

ALL_FILTERS = (0, 1, 2, 3, 4)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


# Adam7's passes: (first column, first row, column step, row step)
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _pack(arr: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, row_bytes] bytes at `depth` bits a sample
    (big-endian at 16, most significant bits first below 8)."""
    h, w, c = arr.shape
    if depth == 16:
        return arr.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth == 8:
        return arr.astype(np.uint8).reshape(h, w * c)
    shifts = np.arange(depth - 1, -1, -1)
    bits = (arr.reshape(h, w * c, 1).astype(np.uint8) >> shifts) & 1
    return np.packbits(bits.reshape(h, w * c * depth).astype(np.uint8),
                       axis=1)


def _filter_rows(rows: np.ndarray, bpp: int, filters) -> bytes:
    """Packed rows -> the filtered stream, row y with filter
    filters[y % len(filters)]."""
    h = rows.shape[0]
    rows = rows.astype(np.int32)
    left = np.zeros_like(rows)
    left[:, bpp:] = rows[:, :-bpp]
    up = np.zeros_like(rows)
    up[1:] = rows[:-1]
    upleft = np.zeros_like(rows)
    upleft[1:, bpp:] = rows[:-1, :-bpp]
    p = left + up - upleft
    pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - upleft)
    paeth = np.where((pa <= pb) & (pa <= pc), left,
                     np.where(pb <= pc, up, upleft))
    predictors = (np.zeros_like(rows), left, up, (left + up) // 2, paeth)
    return b"".join(
        bytes([f]) + ((rows[y] - predictors[f][y]) % 256).astype(
            np.uint8).tobytes()
        for y, f in ((y, filters[y % len(filters)]) for y in range(h)))


def encode_png(pixels: np.ndarray, filters=ALL_FILTERS, *, depth: int = 8,
               palette=None, interlace: bool = False, chunks=()) -> bytes:
    """Samples -> PNG bytes. `pixels` is [H, W] (gray, or palette indices
    with `palette`) or [H, W, C] (C 2 gray + alpha, 3 RGB, 4 RGBA), values
    below 2 ** depth (uint16 at depth 16). `interlace` writes Adam7;
    `chunks` are (type, body) pairs put before IDAT (e.g. tRNS). Row y of
    each pass uses filters[y % len(filters)]."""
    arr = np.asarray(pixels)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, c = arr.shape
    color_type = 3 if palette is not None else {1: 0, 2: 4, 3: 2, 4: 6}[c]
    bpp = max(1, c * depth // 8)
    raw = b""
    for x0, y0, dx, dy in ADAM7 if interlace else ((0, 0, 1, 1),):
        sub = arr[y0::dy, x0::dx]
        if sub.shape[0] and sub.shape[1]:  # an empty pass writes nothing
            raw += _filter_rows(_pack(sub, depth), bpp, filters)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0,
                       int(interlace))
    out = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
    if palette is not None:
        out += _chunk(b"PLTE", np.asarray(palette, np.uint8).tobytes())
    for kind, body in chunks:
        out += _chunk(kind, body)
    return (out + _chunk(b"IDAT", zlib.compress(raw, 6))
            + _chunk(b"IEND", b""))


def encode_bmp(pixels: np.ndarray) -> bytes:
    """[H, W, 3] RGB uint8 -> an uncompressed 24-bit bottom-up BMP."""
    arr = np.asarray(pixels, np.uint8)
    h, w, _ = arr.shape
    stride = (w * 3 + 3) // 4 * 4
    rows = np.zeros((h, stride), np.uint8)
    rows[:, :w * 3] = arr[::-1, :, ::-1].reshape(h, w * 3)
    data = rows.tobytes()
    header = struct.pack("<IiiHHIIiiII", 40, w, h, 1, 24, 0, len(data),
                         2835, 2835, 0, 0)
    return (b"BM" + struct.pack("<IHHI", 14 + 40 + len(data), 0, 0, 54)
            + header + data)
