"""Still-image decoding of the port's media layer, without PIL.

Reads the formats a frame directory or a base64 image of a serving request
uses, on every host (the GPU host has no PIL): PNG (8-bit gray, gray +
alpha, RGB and RGBA; palette at 1, 2, 4 or 8 bits; not interlaced),
binary PPM / PGM (maxval 255) and uncompressed 24- and 32-bit BMP. Each
gives what `PIL.Image.open(f).convert("RGB")` gives, bit for bit: alpha is
dropped, not composited; gray is repeated to three channels; a palette is
looked up. PNG rows are unfiltered by a small C++ helper
(csrc/png_unfilter.cc, built at first use by media/_native.py): the
Average and Paeth filters depend on the byte just decoded.

JPEG, GIF and every other format raise NotImplementedError naming the
format; nothing is decoded by a substitute.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import Union

import numpy as np

from . import _native

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (0 gray, 2 RGB, 3 palette, 4 gray+alpha, 6 RGBA)
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}

_unfilter = None
_unfilter_lock = threading.Lock()


def _png_unfilter():
    global _unfilter
    with _unfilter_lock:
        if _unfilter is None:
            fn = _native.load("png_unfilter.cc").png_unfilter
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_long,
                           ctypes.c_int, ctypes.c_void_p]
            _unfilter = fn
    return _unfilter


def _image_format(data: bytes) -> str:
    """The format of an encoded image by its leading bytes."""
    if data.startswith(PNG_SIGNATURE):
        return "PNG"
    if data[:2] in (b"P5", b"P6"):
        return "PNM"
    if data[:2] == b"BM":
        return "BMP"
    if data[:3] == b"\xff\xd8\xff":
        return "JPEG"
    if data[:6] in (b"GIF87a", b"GIF89a"):
        return "GIF"
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        return "WebP"
    if data[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if data[:2] in (b"P1", b"P2", b"P3", b"P4"):
        return "ASCII or bitmap PNM"
    return "unknown"


def read_image(src: Union[str, os.PathLike, bytes]) -> np.ndarray:
    """A path or an encoded image's bytes -> [H, W, 3] uint8 RGB."""
    if isinstance(src, (bytes, bytearray, memoryview)):
        data = bytes(src)
    else:
        with open(src, "rb") as f:
            data = f.read()
    fmt = _image_format(data)
    if fmt == "PNG":
        return _read_png(data)
    if fmt == "PNM":
        return _read_pnm(data)
    if fmt == "BMP":
        return _read_bmp(data)
    raise NotImplementedError(
        f"{fmt} images are not decoded by the port yet (it reads PNG, "
        "binary PPM/PGM and uncompressed 24/32-bit BMP)")


def as_rgb(img) -> np.ndarray:
    """Gray [H, W] or [H, W, 1], gray + alpha, RGB or RGBA uint8 -> RGB, as
    PIL's convert("RGB") gives it: gray repeated, alpha dropped."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] in (1, 2):
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


def _read_png(data: bytes) -> np.ndarray:
    pos, header, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG chunk")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r}: bad CRC")
        pos += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if interlace:
        raise NotImplementedError("interlaced PNG is not decoded by the "
                                  "port yet")
    supported = depth == 8 or (ctype == 3 and depth in (1, 2, 4))
    if ctype not in _PNG_CHANNELS or not supported:
        raise NotImplementedError(f"PNG of color type {ctype} at bit depth "
                                  f"{depth} is not decoded by the port yet")
    channels = _PNG_CHANNELS[ctype]
    row_bytes = (width * channels * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (row_bytes + 1):
        raise ValueError("PNG image data is truncated")
    rows = np.empty((height, row_bytes), np.uint8)
    bad = _png_unfilter()(raw, height, row_bytes,
                          max(1, channels * depth // 8),
                          rows.ctypes.data_as(ctypes.c_void_p))
    if bad:
        raise ValueError(f"PNG row {bad - 1}: unknown filter type")
    if ctype != 3:
        return as_rgb(rows.reshape(height, width, channels))
    if palette is None:
        raise ValueError("palette PNG without PLTE")
    if depth < 8:
        bits = np.unpackbits(rows, axis=1).reshape(height, -1, depth)
        weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
        rows = (bits * weights).sum(axis=-1, dtype=np.uint8)
    lut = np.zeros((256, 3), np.uint8)   # indices past PLTE read black
    lut[:len(palette)] = palette[:256]
    return lut[rows[:, :width]]


def _read_pnm(data: bytes) -> np.ndarray:
    """Binary PGM (P5) or PPM (P6), maxval 255."""
    fields, pos = [], 2
    while len(fields) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(data) and data[end:end + 1].isdigit():
            end += 1
        if end == pos:
            raise ValueError("malformed PNM header")
        fields.append(int(data[pos:end]))
        pos = end
    width, height, maxval = fields
    if maxval != 255:
        raise NotImplementedError(f"PNM with maxval {maxval} is not decoded "
                                  "by the port yet (255 is)")
    channels = 3 if data[:2] == b"P6" else 1
    n = width * height * channels
    pixels = np.frombuffer(data, np.uint8, count=n, offset=pos + 1)
    return as_rgb(pixels.reshape(height, width, channels))


def _read_bmp(data: bytes) -> np.ndarray:
    """Uncompressed (BI_RGB) 24- or 32-bit BMP; 32-bit reads as BGRX."""
    offset, = struct.unpack("<I", data[10:14])
    dib, = struct.unpack("<I", data[14:18])
    if dib < 40:
        raise NotImplementedError("BMP with an OS/2 core header is not "
                                  "decoded by the port yet")
    width, height, _, bits, compression = struct.unpack("<iiHHI",
                                                        data[18:34])
    if compression != 0 or bits not in (24, 32):
        raise NotImplementedError(f"BMP of {bits} bits with compression "
                                  f"{compression} is not decoded by the port "
                                  "yet (uncompressed 24/32-bit is)")
    rows, stride = abs(height), (width * bits + 31) // 32 * 4
    buf = np.frombuffer(data, np.uint8, count=rows * stride, offset=offset)
    px = buf.reshape(rows, stride)[:, :width * bits // 8]
    px = px.reshape(rows, width, bits // 8)[..., 2::-1]
    if height > 0:   # bottom-up rows
        px = px[::-1]
    return np.ascontiguousarray(px)
