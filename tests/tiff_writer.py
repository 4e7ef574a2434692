"""Baseline TIFF files without PIL or libtiff, for the layouts PIL's
writer never makes: big-endian files beyond 16-bit gray, tiles, planar
data, predictor 2 under every compression, fill order 2, low-bit gray and
palette, CMYK and RGB with extra samples at 16 bits, and chosen strip
heights. Compressions: none (1), LZW (5, MSB-first with libtiff's early
code change and table resets), Deflate (8 or 32946) and PackBits (32773).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_SHORT, _LONG = 3, 4
_REVERSE = np.array([int(f"{i:08b}"[::-1], 2) for i in range(256)],
                    np.uint8)


class _Bits:
    """MSB-first bit writer."""

    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code: int, nbits: int) -> None:
        self.acc = (self.acc << nbits) | code
        self.n += nbits
        while self.n >= 8:
            self.n -= 8
            self.out.append((self.acc >> self.n) & 0xFF)
        self.acc &= (1 << self.n) - 1

    def finish(self) -> bytes:
        if self.n:
            self.out.append((self.acc << (8 - self.n)) & 0xFF)
        return bytes(self.out)


def lzw_encode(data: bytes) -> bytes:
    """One strip as libtiff's LZWEncode writes it: a clear code first,
    the width grown when the next entry needs it, a clear code when the
    table fills (at 4094 entries), EOI last."""
    bits, nbits = _Bits(), 9
    table, free = {}, 258
    bits.put(256, nbits)
    if not data:
        bits.put(257, nbits)
        return bits.finish()
    w = data[0]
    for c in data[1:]:
        key = (w, c)
        if key in table:
            w = table[key]
            continue
        bits.put(w, nbits)
        table[key] = free
        free += 1
        if free == 4094:
            bits.put(256, nbits)
            table, free, nbits = {}, 258, 9
        elif free > (1 << nbits) - 1:
            nbits += 1
        w = c
    bits.put(w, nbits)
    free += 1
    if free == 4094:
        bits.put(256, nbits)
        nbits = 9
    elif free > (1 << nbits) - 1:
        nbits += 1
    bits.put(257, nbits)
    return bits.finish()


def packbits_encode(data: bytes) -> bytes:
    out, i, n = bytearray(), 0, len(data)
    while i < n:
        run = 1
        while i + run < n and run < 128 and data[i + run] == data[i]:
            run += 1
        if run >= 2:
            out += bytes([257 - run, data[i]])
            i += run
            continue
        j = i + 1
        while j < n and j - i < 128 and not (j + 1 < n
                                              and data[j] == data[j + 1]):
            j += 1
        out += bytes([j - i - 1]) + data[i:j]
        i = j
    return bytes(out)


def _compress(raw: bytes, compression: int) -> bytes:
    if compression == 1:
        return raw
    if compression == 5:
        return lzw_encode(raw)
    if compression in (8, 32946):
        return zlib.compress(raw)
    if compression == 32773:
        return packbits_encode(raw)
    raise ValueError(compression)


def _pack_rows(px: np.ndarray, bits: int, order: str) -> np.ndarray:
    """[rows, n] samples -> [rows, row bytes]."""
    if bits == 8:
        return px.astype(np.uint8)
    if bits in (16, 32):
        return px.astype(f"{order}u{bits // 8}").view(np.uint8)
    rows, n = px.shape
    b = ((px[..., None].astype(np.uint16) >> np.arange(bits - 1, -1, -1))
         & 1).astype(np.uint8).reshape(rows, n * bits)
    return np.packbits(b, axis=1)


def _predict(px: np.ndarray, stride: int, bits: int) -> np.ndarray:
    """Horizontal differencing over [rows, n] samples, stride apart."""
    rows, n = px.shape
    r = px.astype(np.int64).reshape(rows, n // stride, stride)
    d = r.copy()
    d[:, 1:] = r[:, 1:] - r[:, :-1]
    return (d % (1 << bits)).reshape(rows, n)


def encode_tiff(samples: np.ndarray, *, photometric: int, bits: int = 8,
                byteorder: str = "<", compression: int = 1,
                predictor: int = 1, extra=(), sample_format=None,
                planar: bool = False, rows_per_strip=None, tile=None,
                colormap=None, orientation=None, fill_order=None,
                pages=()) -> bytes:
    """samples: [H, W] or [H, W, spp] integers below 2**bits. `tile`:
    (width, length); `pages`: further (samples, kwargs) images after the
    first, each its own IFD."""
    bo = byteorder
    images = [(samples, dict(photometric=photometric, bits=bits,
                             compression=compression, predictor=predictor,
                             extra=extra, sample_format=sample_format,
                             planar=planar, rows_per_strip=rows_per_strip,
                             tile=tile, colormap=colormap,
                             orientation=orientation,
                             fill_order=fill_order))] + list(pages)
    out = bytearray((b"II*\x00" if bo == "<" else b"MM\x00*") + b"\0" * 4)
    ifd_link = 4
    for px, kw in images:
        px = np.asarray(px)
        if px.ndim == 2:
            px = px[..., None]
        h, w, spp = px.shape
        b = kw.get("bits", 8)
        entries = _strips(out, px, b, bo, kw)
        if len(out) & 1:
            out.append(0)
        struct.pack_into(bo + "I", out, ifd_link, len(out))
        ifd_link = _write_ifd(out, bo, h, w, spp, b, kw, entries)
    return bytes(out)


def _strips(out: bytearray, px: np.ndarray, bits: int, bo: str,
            kw: dict) -> dict:
    h, w, spp = px.shape
    planar = kw.get("planar", False) and spp > 1
    planes = [px[..., i:i + 1] for i in range(spp)] if planar else [px]
    tile = kw.get("tile")
    tw, th = tile if tile else (w, kw.get("rows_per_strip") or h)
    offsets, counts = [], []
    for plane in planes:
        band = plane.shape[2]
        for y0 in range(0, h, th):
            for x0 in range(0, w, tw):
                block = plane[y0:y0 + th, x0:x0 + tw]
                if tile:   # tiles are whole, padded with zeros
                    full = np.zeros((th, tw, band), block.dtype)
                    full[:block.shape[0], :block.shape[1]] = block
                    block = full
                rows = block.reshape(block.shape[0], -1)
                if kw.get("predictor", 1) == 2:
                    rows = _predict(rows, band, bits)
                data = _compress(_pack_rows(rows, bits, bo).tobytes(),
                                 kw.get("compression", 1))
                if kw.get("fill_order") == 2:   # bits reversed as stored
                    data = _REVERSE[np.frombuffer(data, np.uint8)].tobytes()
                offsets.append(len(out))
                counts.append(len(data))
                out += data
    if tile:
        return {322: (_SHORT, [tw]), 323: (_SHORT, [th]),
                324: (_LONG, offsets), 325: (_LONG, counts)}
    return {273: (_LONG, offsets), 278: (_SHORT, [th]),
            279: (_LONG, counts)}


def _write_ifd(out: bytearray, bo: str, h: int, w: int, spp: int, bits: int,
               kw: dict, entries: dict) -> int:
    tags = dict(entries)
    tags[256] = (_LONG, [w])
    tags[257] = (_LONG, [h])
    tags[258] = (_SHORT, [bits] * spp)
    tags[259] = (_SHORT, [kw.get("compression", 1)])
    tags[262] = (_SHORT, [kw["photometric"]])
    tags[277] = (_SHORT, [spp])
    if kw.get("planar") and spp > 1:
        tags[284] = (_SHORT, [2])
    if kw.get("predictor", 1) != 1:
        tags[317] = (_SHORT, [kw["predictor"]])
    if kw.get("extra"):
        tags[338] = (_SHORT, list(kw["extra"]))
    if kw.get("sample_format") is not None:
        tags[339] = (_SHORT, [kw["sample_format"]] * spp)
    if kw.get("colormap") is not None:
        tags[320] = (_SHORT, [int(v) for v in np.asarray(
            kw["colormap"]).T.reshape(-1)])
    if kw.get("orientation") is not None:
        tags[274] = (_SHORT, [kw["orientation"]])
    if kw.get("fill_order") is not None:
        tags[266] = (_SHORT, [kw["fill_order"]])
    start = len(out)
    n = len(tags)
    out += struct.pack(bo + "H", n) + b"\0" * (12 * n + 4)
    for i, (tag, (typ, vals)) in enumerate(sorted(tags.items())):
        fmt = "H" if typ == _SHORT else "I"
        payload = struct.pack(bo + fmt * len(vals), *vals)
        e = start + 2 + 12 * i
        struct.pack_into(bo + "HHI", out, e, tag, typ, len(vals))
        if len(payload) <= 4:
            out[e + 8:e + 8 + len(payload)] = payload
        else:
            if len(out) & 1:
                out.append(0)
            struct.pack_into(bo + "I", out, e + 8, len(out))
            out += payload
    return start + 2 + 12 * n
