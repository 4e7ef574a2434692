"""Baseline TIFF for media/image_io.py, without PIL or libtiff.

PIL reads a TIFF's first image file directory (IFD): its table of modes
(TiffImagePlugin.OPEN_INFO, keyed on photometric interpretation, sample
format, fill order, bits per sample and extra samples) picks a mode and
a raw mode; uncompressed data goes through PIL's own raw decoder, every
other compression through libtiff, which undoes the predictor and gives
16-bit samples in host order; after loading, the Orientation tag is
applied (ImageOps.exif_transpose). This module does the same for:

  - compression 1 (none), 32773 (PackBits), 5 (LZW, csrc/tiff_lzw.cc)
    and 8 / 32946 (Deflate, with zlib);
  - predictor 1, and 2 (horizontal differencing at 8 and 16 bits) where
    libtiff applies it: under LZW and Deflate only;
  - strips and tiles, chunky and planar, little- and big-endian, fill
    order 1 and 2;
  - photometric 0 and 1 (min-is-white, min-is-black) at 1, 2, 4, 8 and 16
    bits, with an optional alpha; 3 (palette, 1-8 bits); 2 (RGB at 8 and
    16 bits, with unspecified, associated or unassociated extra samples);
    5 (CMYK at 8 and 16 bits);
  - Orientation 1-8.

Each mode then converts to RGB as PIL's `convert("RGB")` does: "1" to 0
or 255, gray repeated, 16-bit gray clipped at 255 ("I;16"), 16-bit color
to its high byte, alpha dropped (associated alpha first divided out, as
PIL's "RGBa" raw mode does), the palette's 16-bit entries to their high
byte, CMYK through PIL's cmyk2rgb.

Still refused with NotImplementedError naming them: JPEG (6, 7), CCITT
(2, 3, 4) and every other compression (ZSTD, LZMA, WebP, ...); YCbCr,
CIELab and other photometric interpretations; floating-point and signed
samples; 12- and 32-bit samples; predictor 3; old-style LZW; BigTIFF.
Combinations PIL does not open either raise ValueError, as do malformed
files.
"""

from __future__ import annotations

import ctypes
import struct
import threading
import zlib

import numpy as np

from . import _native

_lzw = None
_lzw_lock = threading.Lock()

# tag numbers
WIDTH, LENGTH, BITS, COMPRESSION, PHOTOMETRIC, FILL_ORDER = (256, 257, 258,
                                                           259, 262, 266)
STRIP_OFFSETS, ORIENTATION, SAMPLES, ROWS_PER_STRIP = 273, 274, 277, 278
STRIP_BYTES, PLANAR, PREDICTOR, COLORMAP = 279, 284, 317, 320
TILE_WIDTH, TILE_LENGTH, TILE_OFFSETS, TILE_BYTES = 322, 323, 324, 325
EXTRA_SAMPLES, SAMPLE_FORMAT = 338, 339

_REFUSED_COMPRESSION = {
    2: "CCITT modified Huffman (compression 2)",
    3: "CCITT Group 3 (compression 3)", 4: "CCITT Group 4 (compression 4)",
    6: "old-style JPEG (compression 6)", 7: "JPEG (compression 7)",
    32809: "ThunderScan (compression 32809)",
    34676: "SGI LogLuv (compression 34676)",
    34677: "SGI LogLuv 24 (compression 34677)", 34925: "LZMA (compression "
    "34925)", 50000: "ZSTD (compression 50000)", 50001: "WebP (compression "
    "50001)", 32771: "NeXT 2-bit RLE (compression 32771)"}
_PHOTOMETRIC_NAMES = {4: "transparency mask (photometric 4)",
                      6: "YCbCr (photometric 6)", 8: "CIELab (photometric 8)",
                      9: "ICCLab (photometric 9)", 10: "ITULab (photometric "
                      "10)", 32844: "LogL (photometric 32844)",
                      32845: "LogLuv (photometric 32845)"}
# field types -> struct formats (5 and 10 are rationals, two longs each)
_TYPES = {1: "B", 2: "B", 3: "H", 4: "I", 5: "II", 6: "b", 7: "B", 8: "h",
          9: "i", 10: "ii", 11: "f", 12: "d", 13: "I"}


def _lzw_lib():
    global _lzw
    with _lzw_lock:
        if _lzw is None:
            fn = _native.load("tiff_lzw.cc").tiff_lzw
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_void_p,
                           ctypes.c_long]
            _lzw = fn
    return _lzw


def _ifd(data: bytes):
    """The first IFD: (byte order, {tag: tuple of values})."""
    bo = "<" if data[:2] == b"II" else ">"
    if len(data) < 8:
        raise ValueError("TIFF header truncated")
    off = struct.unpack(bo + "I", data[4:8])[0]
    if off + 2 > len(data):
        raise ValueError("TIFF: the first IFD lies past the end of the file")
    count = struct.unpack(bo + "H", data[off:off + 2])[0]
    if off + 2 + 12 * count > len(data):
        raise ValueError("TIFF: the first IFD is truncated")
    tags = {}
    for i in range(count):
        e = off + 2 + 12 * i
        tag, typ, n = struct.unpack(bo + "HHI", data[e:e + 8])
        fmt = _TYPES.get(typ)
        if fmt is None:
            continue   # an unknown type: PIL skips the entry
        size = struct.calcsize(bo + fmt) * n
        if size <= 4:
            raw = data[e + 8:e + 8 + size]
        else:
            vo = struct.unpack(bo + "I", data[e + 8:e + 12])[0]
            raw = data[vo:vo + size]
            if len(raw) < size:
                continue   # PIL drops a tag whose data lies past the end
        vals = struct.unpack(bo + fmt * n, raw)
        if typ in (5, 10):
            vals = tuple(vals[i] / vals[i + 1] if vals[i + 1] else 0
                         for i in range(0, len(vals), 2))
        tags[tag] = vals
    return bo, tags


def _one(tags: dict, tag: int, default=None):
    v = tags.get(tag)
    if v is None:
        return default
    if len(v) != 1:
        raise ValueError(f"TIFF tag {tag} holds {len(v)} values, not one")
    return v[0]


def _mode(bo: str, tags: dict):
    """PIL's _setup: the mode and sample layout of the IFD's pixel format,
    the samples a pixel, their bits, the photometric interpretation and
    the extra samples."""
    photo = _one(tags, PHOTOMETRIC, 0)
    fill = _one(tags, FILL_ORDER, 1)
    fmt = tags.get(SAMPLE_FORMAT, (1,))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps = tags.get(BITS, (1,))
    extra = tags.get(EXTRA_SAMPLES, ())
    spp = _one(tags, SAMPLES, 1)
    if spp > 6:
        raise ValueError(f"TIFF of {spp} samples a pixel")
    if spp < len(bps):
        bps = bps[:spp]
    elif spp > len(bps) and len(bps) == 1:
        bps = bps * spp
    if len(bps) != spp:
        raise ValueError("TIFF: BitsPerSample does not match "
                         "SamplesPerPixel")
    if photo in _PHOTOMETRIC_NAMES:
        raise NotImplementedError(f"TIFF in {_PHOTOMETRIC_NAMES[photo]} is "
                                  "not decoded by the port yet")
    if fmt[0] == 3:
        raise NotImplementedError("TIFF with floating-point samples is not "
                                  "decoded by the port yet")
    if fmt[0] == 2 and bps[0] != 8:
        raise NotImplementedError("TIFF with signed integer samples is not "
                                  "decoded by the port yet")
    if bps[0] in (12, 32) and photo in (0, 1):
        raise NotImplementedError(f"TIFF with {bps[0]}-bit samples is not "
                                  "decoded by the port yet")
    key = (bo, photo, fmt, fill, bps, extra)
    got = _OPEN_INFO.get(key)
    if got is None:
        raise ValueError(f"TIFF of a pixel format PIL does not open either "
                         f"(photometric {photo}, sample format {fmt}, fill "
                         f"order {fill}, bits {bps}, extra samples {extra})")
    return got[0], got[1], spp, bps[0], photo, extra


def _open_info() -> dict:
    """The entries of PIL's OPEN_INFO this module decodes, both byte
    orders: key -> (mode, layout), layout being what the samples are."""
    out = {}
    for bo in "<>":
        for fill in (1, 2):   # fill order 2: low-bit and 8-bit, and RGB
            for bits in (1, 2, 4, 8):
                out[(bo, 0, (1,), fill, (bits,), ())] = ("L", f"gray{bits}i")
                out[(bo, 1, (1,), fill, (bits,), ())] = ("L", f"gray{bits}")
                out[(bo, 3, (1,), fill, (bits,), ())] = ("P", f"pal{bits}")
            out[(bo, 2, (1,), fill, (8, 8, 8), ())] = ("RGB", "rgb")
        out[(bo, 1, (2,), 1, (8,), ())] = ("L", "gray8")
        out[(bo, 1, (1,), 1, (8, 8), (2,))] = ("LA", "gray8")
        out[(bo, 2, (1,), 1, (8, 8, 8, 8), ())] = ("RGBA", "rgb")
        for extra in ((0,), (0, 0), (0, 0, 0), (2,), (2, 0), (2, 0, 0),
                      (999,)):
            out[(bo, 2, (1,), 1, (8,) * (3 + len(extra)), extra)] = (
                "RGB", "rgb")
        for extra in ((1,), (1, 0), (1, 0, 0)):
            out[(bo, 2, (1,), 1, (8,) * (3 + len(extra)), extra)] = (
                "RGBa", "rgb")
        out[(bo, 2, (1,), 1, (16,) * 3, ())] = ("RGB", "rgb")
        out[(bo, 2, (1,), 1, (16,) * 4, ())] = ("RGBA", "rgb")
        for extra in ((0,), (2,)):
            out[(bo, 2, (1,), 1, (16,) * 4, extra)] = ("RGB", "rgb")
        out[(bo, 2, (1,), 1, (16,) * 4, (1,))] = ("RGBa", "rgb")
        out[(bo, 3, (1,), 1, (8, 8), (0,))] = ("P", "pal8")
        out[(bo, 3, (1,), 1, (8, 8), (2,))] = ("P", "pal8")
        out[(bo, 5, (1,), 1, (8,) * 4, ())] = ("CMYK", "cmyk")
        out[(bo, 5, (1,), 1, (8,) * 5, (0,))] = ("CMYK", "cmyk")
        out[(bo, 5, (1,), 1, (8,) * 6, (0, 0))] = ("CMYK", "cmyk")
        out[(bo, 5, (1,), 1, (16,) * 4, ())] = ("CMYK", "cmyk")
    # 16-bit gray: min-is-black both orders, min-is-white little-endian
    # only and not inverted; fill order 2 little-endian min-is-black only
    for key in (("<", 1, (1,), 1), (">", 1, (1,), 1), ("<", 0, (1,), 1),
                ("<", 1, (1,), 2)):
        out[key + ((16,), ())] = ("I;16", "gray16")
    return out


_OPEN_INFO = _open_info()


def _packbits(src: bytes, need: int) -> bytes:
    """libtiff's PackBitsDecode over one strip or tile."""
    out, pos, n = bytearray(), 0, len(src)
    while pos < n and len(out) < need:
        c = src[pos]
        pos += 1
        if c > 128:   # replicate the next byte 257 - c times
            if pos >= n:
                break
            out += src[pos:pos + 1] * min(257 - c, need - len(out))
            pos += 1
        elif c < 128:  # copy the next c + 1 bytes
            k = min(c + 1, need - len(out))
            if n - pos < k:
                break
            out += src[pos:pos + k]
            pos += k
    return bytes(out)


_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)], np.uint8)


def _decompress(raw: bytes, compression: int, need: int) -> bytes:
    if compression == 1:
        return raw[:need]
    if compression == 32773:
        return _packbits(raw, need)
    if compression == 5:
        if len(raw) >= 2 and raw[0] == 0 and raw[1] & 1:
            raise NotImplementedError("TIFF with old-style (LSB-first) LZW "
                                      "is not decoded by the port yet")
        out = np.empty(need, np.uint8)
        got = _lzw_lib()(raw, len(raw), out.ctypes.data_as(ctypes.c_void_p),
                         need)
        if got < 0:
            raise ValueError("TIFF: corrupt LZW data")
        return out[:got].tobytes()
    try:
        return zlib.decompressobj().decompress(raw, need)
    except zlib.error as e:
        raise ValueError(f"TIFF Deflate data: {e}") from None


def _unpredict(block: np.ndarray, rows: int, row_bytes: int, stride: int,
               bits: int, bo: str) -> np.ndarray:
    """libtiff's horAcc8 / horAcc16 over each row of a strip or tile;
    16-bit samples come back in host order as libtiff gives them."""
    if bits == 8:
        r = block.reshape(rows, row_bytes // stride, stride)
        return np.cumsum(r, axis=1, dtype=np.uint8).reshape(-1)
    r = block.view(bo + "u2").reshape(rows, row_bytes // 2 // stride, stride)
    return np.cumsum(r, axis=1, dtype=np.uint16).astype(
        "=u2").view(np.uint8).reshape(-1)


def read_tiff(data: bytes, max_pixels: int) -> np.ndarray:
    """A TIFF file's first image -> [H, W, 3] uint8, as PIL's
    `Image.open(f).convert("RGB")`."""
    bo, tags = _ifd(data)
    compression = _one(tags, COMPRESSION, 1)
    if compression in _REFUSED_COMPRESSION:
        raise NotImplementedError(
            f"TIFF with {_REFUSED_COMPRESSION[compression]} is not decoded "
            "by the port yet (none, PackBits, LZW and Deflate are)")
    if compression not in (1, 5, 8, 32773, 32946):
        raise ValueError(f"TIFF of unknown compression {compression}")
    mode, layout, spp, bits, photo, extra = _mode(bo, tags)
    width, height = _one(tags, WIDTH), _one(tags, LENGTH)
    if width is None or height is None:
        raise ValueError("TIFF without its dimensions")
    if not width or not height or width * height > max_pixels:
        raise ValueError(f"TIFF of {width}x{height}: an empty image or more "
                         f"than {max_pixels} pixels")
    planar = _one(tags, PLANAR, 1)
    if planar not in (1, 2):
        raise ValueError(f"TIFF planar configuration {planar}")
    planar = planar == 2 and spp > 1
    libtiff = compression != 1
    tiled = TILE_OFFSETS in tags
    if planar:
        mode = _planar_mode(mode, bits, photo, extra, libtiff, tiled)
    predictor = _one(tags, PREDICTOR, 1)
    if predictor == 3 and compression in (5, 8, 32946):
        raise NotImplementedError("TIFF with the floating-point predictor "
                                  "(3) is not decoded by the port yet")
    if predictor not in (1, 2) and compression in (5, 8, 32946):
        raise ValueError(f"TIFF predictor {predictor}")
    use_predictor = predictor == 2 and compression in (5, 8, 32946)
    if use_predictor and bits not in (8, 16):
        raise ValueError(f"TIFF: predictor 2 with {bits}-bit samples")
    fill = _one(tags, FILL_ORDER, 1)
    if fill == 2 and not libtiff and (layout == "gray8i" or (
            layout.startswith("pal") and bits < 8)):
        raise ValueError("uncompressed TIFF in fill order 2 of a layout "
                         "PIL does not open either")

    if tiled:
        tw, th = _one(tags, TILE_WIDTH), _one(tags, TILE_LENGTH)
        if not isinstance(tw, int) or not isinstance(th, int) or tw <= 0 \
                or th <= 0 or tw * th > 1 << 26:
            raise ValueError(f"TIFF: bad tile dimensions {tw}x{th}")
        offsets, counts = tags[TILE_OFFSETS], tags.get(TILE_BYTES)
    elif STRIP_OFFSETS in tags:
        tw = width
        th = min(_one(tags, ROWS_PER_STRIP, height), height)
        if th <= 0:
            raise ValueError("TIFF with zero rows a strip")
        offsets, counts = tags[STRIP_OFFSETS], tags.get(STRIP_BYTES)
    else:
        raise ValueError("TIFF without strip or tile offsets")
    across, down = -(-width // tw), -(-height // th)
    planes = spp if planar else 1
    if len(offsets) < across * down * planes:
        raise ValueError("TIFF: fewer strip or tile offsets than the image "
                         "needs")
    if libtiff and (counts is None or len(counts) < len(offsets)):
        raise ValueError("TIFF: missing strip or tile byte counts")
    band_spp = 1 if planar else spp
    row_bytes = (tw * band_spp * bits + 7) // 8
    samples = np.zeros((planes, height, width * band_spp), np.uint16
                       if bits == 16 else np.uint8)
    for plane in range(planes):
        for ty in range(down):
            for tx in range(across):
                i = (plane * down + ty) * across + tx
                rows = th if tiled else min(th, height - ty * th)
                need = rows * row_bytes
                off = offsets[i]
                if libtiff:
                    raw = data[off:off + counts[i]]
                    if len(raw) < counts[i]:
                        raise ValueError("TIFF: a strip or tile runs past "
                                         "the end of the file")
                else:
                    raw = data[off:off + need]
                if fill == 2:
                    raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
                block = _decompress(raw, compression, need)
                if len(block) < need:
                    raise ValueError("TIFF: not enough data in a strip or "
                                     "tile")
                block = np.frombuffer(block, np.uint8)
                if use_predictor:
                    block = _unpredict(block, rows, row_bytes, band_spp,
                                       bits, bo)
                    order = "="
                else:
                    order = bo
                px = _samples(block, rows, row_bytes, tw * band_spp, bits,
                              order)
                y0, x0 = ty * th, tx * tw * band_spp
                h = min(rows, height - y0)
                w = min(tw * band_spp, width * band_spp - x0)
                samples[plane, y0:y0 + h, x0:x0 + w] = px[:h, :w]
    if planar:
        samples = np.moveaxis(samples, 0, -1)
    else:
        samples = samples[0].reshape(height, width, spp)
    rgb = _to_rgb(samples, mode, layout, bits, tags, bo)
    return _orient(rgb, tags.get(ORIENTATION, (1,)))


def _planar_mode(mode: str, bits: int, photo: int, extra: tuple,
                 libtiff: bool, tiled: bool) -> str:
    """What PIL makes of planar data (PlanarConfiguration 2). Its own raw
    decoder unpacks each plane with one letter of the raw mode, so only
    RGB, RGBA and CMYK at 8 bits read; libtiff's path refuses unspecified
    extra samples in strips and, without ExtraSamples, reads RGBA planes
    as premultiplied."""
    if not libtiff:
        if bits == 16:
            raise NotImplementedError(
                "uncompressed planar TIFF at 16 bits is not decoded by the "
                "port yet (PIL reads each plane as 8-bit samples)")
        if photo in (1, 3) or 0 in extra or 1 in extra:
            raise ValueError("uncompressed planar TIFF of a layout PIL "
                             "does not open either")
        if tiled and mode != "CMYK" and not extra and len(mode) == 4:
            raise NotImplementedError(
                "uncompressed planar RGBA TIFF in tiles without "
                "ExtraSamples is not decoded by the port yet (PIL "
                "misreads its edge tiles)")
        return mode
    if 0 in extra and not tiled:
        raise ValueError("planar TIFF strips with unspecified extra "
                         "samples: PIL does not open them either")
    if 0 in extra and photo == 3:
        raise NotImplementedError(
            "planar palette TIFF tiles with an extra sample are not "
            "decoded by the port yet (PIL reads every other index)")
    if photo == 2 and not extra and len(mode) == 4:
        return "RGBa"
    return mode


def _samples(block: np.ndarray, rows: int, row_bytes: int, n: int,
             bits: int, order: str) -> np.ndarray:
    """One strip or tile's rows -> [rows, n] samples."""
    block = block[:rows * row_bytes].reshape(rows, row_bytes)
    if bits == 8:
        return block[:, :n]
    if bits == 16:
        return block.view(order + "u2")[:, :n].astype(np.uint16)
    px = np.unpackbits(block, axis=1)[:, :n * bits].reshape(rows, n, bits)
    weights = (1 << np.arange(bits - 1, -1, -1)).astype(np.uint8)
    return (px * weights).sum(axis=-1, dtype=np.uint8)


def _to_rgb(s: np.ndarray, mode: str, layout: str, bits: int, tags: dict,
            bo: str) -> np.ndarray:
    """Samples [H, W, spp] -> RGB as PIL's mode and convert("RGB")."""
    if layout.startswith("gray"):
        g = s[..., 0]
        if bits == 16:
            g = np.minimum(g, 255).astype(np.uint8)
        elif bits < 8:
            g = g * np.uint8(255 // ((1 << bits) - 1))
        if layout.endswith("i"):
            g = 255 - g
        return np.repeat(g[..., None], 3, axis=-1)
    if layout.startswith("pal"):
        cmap = tags.get(COLORMAP)
        if cmap is None or len(cmap) % 3:
            raise ValueError("palette TIFF without a ColorMap of three "
                             "equal parts")
        n = len(cmap) // 3
        lut = np.zeros((256, 3), np.uint8)
        pal = (np.array(cmap, np.int64).reshape(3, n).T // 256)[:256]
        lut[:len(pal)] = pal
        return lut[s[..., 0]]
    if bits == 16:
        s = (s >> 8).astype(np.uint8)
    if layout == "cmyk":
        c = s[..., :4].astype(np.int32)
        nk = 255 - c[..., 3:4]
        t = c[..., :3] * nk + 128
        return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)
    rgb = s[..., :3]
    if mode == "RGBa":   # PIL's premultiplied raw mode, divided out
        a = s[..., 3:4].astype(np.int32)
        div = np.clip(rgb.astype(np.int32) * 255 // np.maximum(a, 1), 0, 255)
        rgb = np.where(a == 255, rgb, np.where(a == 0, 0, div))
    return np.ascontiguousarray(rgb, dtype=np.uint8)


def _orient(rgb: np.ndarray, orientation) -> np.ndarray:
    """ImageOps.exif_transpose's transposition for tag 274."""
    o = orientation[0] if len(orientation) == 1 else None
    if o == 2:
        rgb = rgb[:, ::-1]
    elif o == 3:
        rgb = rgb[::-1, ::-1]
    elif o == 4:
        rgb = rgb[::-1]
    elif o == 5:
        rgb = rgb.transpose(1, 0, 2)
    elif o == 6:
        rgb = rgb.transpose(1, 0, 2)[:, ::-1]
    elif o == 7:
        rgb = rgb[::-1, ::-1].transpose(1, 0, 2)
    elif o == 8:
        rgb = rgb.transpose(1, 0, 2)[::-1]
    return np.ascontiguousarray(rgb)
