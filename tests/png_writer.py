"""Minimal PNG encoder (numpy + zlib) with a chosen filter a row.

Test and smoke-run infrastructure for the port's PNG reader
(videollama2_tpu_torch/media/image_io.py): PIL's encoder never emits the
Average filter (type 3), and the GPU host has no PIL at all, so frames are
written here with every filter type (None, Sub, Up, Average, Paeth) in
turn. The filtered bytes are computed from whole arrays, since encoding
(unlike decoding) reads only original pixels.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

ALL_FILTERS = (0, 1, 2, 3, 4)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body)))


def encode_png(pixels: np.ndarray, filters=ALL_FILTERS) -> bytes:
    """[H, W, 3] RGB or [H, W] gray uint8 -> PNG bytes, 8 bits a sample,
    not interlaced; row y uses filters[y % len(filters)]."""
    arr = np.asarray(pixels, np.uint8)
    gray = arr.ndim == 2
    if gray:
        arr = arr[..., None]
    h, w, bpp = arr.shape
    rows = arr.reshape(h, w * bpp).astype(np.int32)
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
    raw = b"".join(
        bytes([f]) + ((rows[y] - predictors[f][y]) % 256).astype(
            np.uint8).tobytes()
        for y, f in ((y, filters[y % len(filters)]) for y in range(h)))
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 0 if gray else 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b""))


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
