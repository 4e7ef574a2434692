"""Still-image decoding of the port's media layer, without PIL.

Reads the formats a frame directory or a base64 image of a serving request
uses, on every host (the GPU host has no PIL), each to what
`PIL.Image.open(f).convert("RGB")` gives, bit for bit:
  - PNG: every color type at every bit depth (gray at 1, 2, 4, 8 and 16
    bits, palette at 1-8, RGB, gray + alpha and RGBA at 8 and 16), plain
    or Adam7. Alpha and tRNS are dropped, not composited; gray is repeated
    to three channels; low-bit gray scales as PIL's raw modes ("1" 0 or
    255, "L;2" x 85, "L;4" x 17); 16-bit gray clips at 255 as PIL's
    "I;16" does; 16-bit color keeps the high byte.
  - JPEG: baseline, extended sequential and progressive Huffman files,
    8-bit, in gray, YCbCr, RGB, CMYK or YCCK, at any integral chroma
    factors: libjpeg-turbo's default decode (ISLOW IDCT, its upsampling
    and color tables), CMYK through PIL's inverted raw mode.
  - GIF: the first frame (later frames are not decoded).
  - WebP (media/webp.py): lossy (VP8, through libwebp's fancy upsampling
    and fixed-point YUV -> RGB) and lossless (VP8L), simple or extended
    (VP8X, with ALPH decoded then dropped, metadata chunks skipped), and
    an animation's first frame on its canvas.
  - TIFF (media/tiff.py): the first image of a classic little- or
    big-endian file, uncompressed, PackBits, LZW or Deflate, predictor 1
    or 2, strips or tiles, chunky or planar; bilevel, gray, palette, RGB
    and CMYK at the depths PIL opens, with or without extra samples; the
    Orientation tag applied as PIL applies it.
  - binary PPM / PGM (maxval 255) and uncompressed 24- and 32-bit BMP.
Small C++ helpers, built at first use by media/_native.py, do the loops
numpy cannot: csrc/png_unfilter.cc (the Average and Paeth filters depend
on the byte just decoded), csrc/jpeg_decode.cc (entropy decoding, the
IDCT, upsampling, color), csrc/webp_decode.cc (VP8L, ALPH, VP8 and the
upsampler), csrc/tiff_lzw.cc and csrc/gif_lzw.cc (via
media/video_reader.py). None links an image library.

Still refused, with NotImplementedError naming them: arithmetic, lossless,
hierarchical and 12-bit JPEG, progressive JPEG left short of full
refinement (libjpeg-turbo would smooth its blocks), JPEG at fractional
chroma ratios; TIFF with JPEG, CCITT, LZMA, ZSTD, WebP or any other
compression, in YCbCr, CIELab or another color space, with float, signed,
12- or 32-bit samples, the floating-point predictor or old-style LZW,
uncompressed planar 16-bit TIFF (PIL misreads it) and BigTIFF; BMP with
compression or a palette, PNM with another maxval, ASCII PNM and GIFs
whose first frame reaches past the screen. Nothing is decoded by a
substitute; a malformed file raises ValueError.
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
_jpeg = None


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


def _jpeg_lib():
    global _jpeg
    with _unfilter_lock:
        if _jpeg is None:
            lib = _native.load("jpeg_decode.cc")
            lib.jpeg_info.restype = ctypes.c_int
            lib.jpeg_info.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int), ctypes.c_char_p, ctypes.c_int]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [
                ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                ctypes.c_long, ctypes.c_char_p, ctypes.c_int]
            _jpeg = lib
    return _jpeg


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
    if data[:4] in (b"II*\x00", b"MM\x00*", b"MM*\x00", b"II\x00*"):
        return "TIFF"
    if data[:4] in (b"II+\x00", b"MM\x00+"):
        return "BigTIFF"
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
    if fmt == "JPEG":
        return _read_jpeg(data)
    if fmt == "GIF":
        from .video_reader import read_gif_still
        return read_gif_still(data)
    if fmt == "WebP":
        from .webp import read_webp
        return read_webp(data, MAX_PIXELS)
    if fmt == "TIFF":
        from .tiff import read_tiff
        return read_tiff(data, MAX_PIXELS)
    raise NotImplementedError(
        f"{fmt} images are not decoded by the port yet (it reads PNG, "
        "baseline and progressive JPEG, GIF, WebP, classic TIFF, binary "
        "PPM/PGM and uncompressed 24/32-bit BMP)")


def as_rgb(img) -> np.ndarray:
    """Gray [H, W] or [H, W, 1], gray + alpha, RGB or RGBA uint8 -> RGB, as
    PIL's convert("RGB") gives it: gray repeated, alpha dropped."""
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = arr[..., None]
    if arr.shape[-1] in (1, 2):
        return np.repeat(arr[..., :1], 3, axis=-1)
    return np.ascontiguousarray(arr[..., :3])


# Adam7's passes: (first column, first row, column step, row step)
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
# the (bit depth, color type) pairs of the PNG specification, all of which
# PIL opens
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# low-bit gray as PIL's "1", "L;2" and "L;4" raw modes scale it
_GRAY_SCALE = {1: 255, 2: 85, 4: 17}
# PIL's decompression-bomb limit (2 x Image.MAX_IMAGE_PIXELS)
MAX_PIXELS = 178956970


def _png_samples(rows: np.ndarray, width: int, channels: int,
                 depth: int) -> np.ndarray:
    """Unfiltered rows of one pass -> [h, width, channels] samples (uint16
    at depth 16)."""
    h = rows.shape[0]
    if depth == 8:
        return rows.reshape(h, width, channels)
    if depth == 16:
        return rows.view(">u2").reshape(h, width, channels)
    bits = np.unpackbits(rows, axis=1)[:, :width * depth]
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits.reshape(h, width, depth) * weights).sum(
        axis=-1, dtype=np.uint8)[..., None]


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
        if kind == b"IHDR" and length == 13:
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            if length % 3:
                raise ValueError("PNG palette of a length not a multiple "
                                 "of 3")
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError("PNG without IHDR or IDAT")
    width, height, depth, ctype, _, _, interlace = header
    if depth not in _PNG_DEPTHS.get(ctype, ()):
        raise ValueError(f"PNG of color type {ctype} at bit depth {depth}: "
                         "not a combination the PNG specification allows")
    if interlace > 1:
        raise ValueError(f"PNG interlace method {interlace}")
    if not width or not height or width * height > MAX_PIXELS:
        raise ValueError(f"PNG of {width}x{height}: an empty image or more "
                         f"than {MAX_PIXELS} pixels")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    channels = _PNG_CHANNELS[ctype]
    pixel_bits = channels * depth
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as e:
        raise ValueError(f"PNG image data: {e}") from None
    samples, offset = None, 0
    for x0, y0, dx, dy in _ADAM7 if interlace else ((0, 0, 1, 1),):
        pw, ph = (width - x0 + dx - 1) // dx, (height - y0 + dy - 1) // dy
        if pw <= 0 or ph <= 0:   # an empty pass has no bytes at all
            continue
        row_bytes = (pw * pixel_bits + 7) // 8
        need = ph * (row_bytes + 1)
        if len(raw) < offset + need:
            raise ValueError("PNG image data is truncated")
        src = np.frombuffer(raw, np.uint8, count=need, offset=offset)
        offset += need
        rows = np.empty((ph, row_bytes), np.uint8)
        bad = _png_unfilter()(src.ctypes.data, ph, row_bytes,
                              max(1, pixel_bits // 8),
                              rows.ctypes.data_as(ctypes.c_void_p))
        if bad:
            raise ValueError(f"PNG row {bad - 1}: unknown filter type")
        px = _png_samples(rows, pw, channels, depth)
        if not interlace:
            samples = px
            break
        if samples is None:
            samples = np.empty((height, width, px.shape[-1]), px.dtype)
        samples[y0::dy, x0::dx] = px
    if ctype == 3:
        lut = np.zeros((256, 3), np.uint8)   # indices past PLTE read black
        lut[:len(palette)] = palette[:256]
        return lut[samples[..., 0]]
    if depth == 16:
        if ctype == 0:   # PIL's "I;16" -> "RGB" clips, it does not scale
            samples = np.minimum(samples, 255).astype(np.uint8)
        else:            # "RGB;16B", "LA;16B", "RGBA;16B": the high byte
            samples = (samples >> 8).astype(np.uint8)
    elif ctype == 0 and depth < 8:
        samples = samples * np.uint8(_GRAY_SCALE[depth])
    return as_rgb(samples)


def _jpeg_status(status: int, msg) -> None:
    text = msg.value.decode(errors="replace")
    if status == 2:
        raise NotImplementedError(
            f"{text} is not decoded by the port yet (8-bit baseline and "
            "progressive Huffman JPEG in gray, YCbCr, RGB, CMYK or YCCK is)")
    if status:
        raise ValueError(text)


def _read_jpeg(data: bytes) -> np.ndarray:
    """Baseline or progressive Huffman JPEG (csrc/jpeg_decode.cc):
    libjpeg-turbo's ISLOW IDCT, upsampling and color tables, as PIL decodes
    by default."""
    lib = _jpeg_lib()
    msg = ctypes.create_string_buffer(256)
    w, h = ctypes.c_int(), ctypes.c_int()
    _jpeg_status(lib.jpeg_info(data, len(data), ctypes.byref(w),
                               ctypes.byref(h), msg, len(msg)), msg)
    out = np.empty((h.value, w.value, 3), np.uint8)
    _jpeg_status(lib.jpeg_decode(data, len(data),
                                 out.ctypes.data_as(ctypes.c_void_p),
                                 out.size, msg, len(msg)), msg)
    return out


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
