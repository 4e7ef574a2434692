"""Minimal baseline JPEG encoder (numpy): the example tables of the JPEG
standard's Annex K (quantization scaled by libjpeg's quality rule, the
typical Huffman tables), 8-bit gray or YCbCr at 4:4:4, 4:2:2 or 4:2:0.

Test and smoke-run infrastructure for the port's JPEG decoder
(videollama2_tpu_torch/media/csrc/jpeg_decode.cc): the GPU host has no
PIL, so JPEG frames are written here. The transform is a float DCT and
chroma is box-averaged; what matters is a valid baseline stream, which
any decoder reads to the same pixels.
"""

from __future__ import annotations

import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# Annex K.1 (natural order)
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array(
    [17, 18, 24, 47] + [99] * 4 + [18, 21, 26, 66] + [99] * 4
    + [24, 26, 56] + [99] * 5 + [47, 66] + [99] * 38)

_AC_SYMBOLS_LUMA = bytes.fromhex(
    "01020300041105122131410613516107227114328191a1082342b1c11552d1f0"
    "2433627282090a161718191a25262728292a3435363738393a43444546474849"
    "4a535455565758595a636465666768696a737475767778797a83848586878889"
    "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5"
    "c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8"
    "f9fa")
_AC_SYMBOLS_CHROMA = bytes.fromhex(
    "000102031104052131061241510761711322328108144291a1b1c109233352f0"
    "156272d10a162434e125f11718191a262728292a35363738393a434445464748"
    "494a535455565758595a636465666768696a737475767778797a828384858687"
    "88898a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3"
    "c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8"
    "f9fa")
# Annex K.3: (code counts by length 1-16, symbols)
DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], bytes(range(12)))
DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
             bytes(range(12)))
AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d],
           _AC_SYMBOLS_LUMA)
AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77],
             _AC_SYMBOLS_CHROMA)

SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2)}


def _codes(table):
    """symbol -> (code, length) of a canonical Huffman table."""
    counts, symbols = table
    out, code, k = {}, 0, 0
    for length, n in enumerate(counts, start=1):
        for _ in range(n):
            out[symbols[k]] = (code, length)
            code += 1
            k += 1
        code <<= 1
    return out


def quant_table(base: np.ndarray, quality: int) -> np.ndarray:
    """libjpeg's jpeg_quality_scaling, baseline (values 1-255)."""
    quality = min(max(quality, 1), 100)
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((base * scale + 50) // 100, 1, 255)


def _dct_matrix() -> np.ndarray:
    u = np.arange(8)[:, None]
    x = np.arange(8)[None, :]
    m = np.sqrt(2 / 8) * np.cos((2 * x + 1) * u * np.pi / 16)
    m[0] /= np.sqrt(2)
    return m


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] (multiples of 8) -> [H/8, W/8, 8, 8]."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def _size(v: int) -> int:
    return abs(v).bit_length()


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def encode_jpeg(pixels: np.ndarray, quality: int = 75,
                subsampling: str = "4:2:0") -> bytes:
    """[H, W, 3] RGB or [H, W] gray uint8 -> baseline JPEG bytes."""
    arr = np.asarray(pixels, np.uint8)
    gray = arr.ndim == 2
    H, W = arr.shape[:2]
    hs, vs = (1, 1) if gray else SAMPLING[subsampling]
    mh, mw = 8 * vs, 8 * hs
    ph, pw = -H % mh, -W % mw
    if gray:
        planes = [np.pad(arr.astype(np.float64), ((0, ph), (0, pw)),
                         mode="edge")]
    else:
        rgb = np.pad(arr.astype(np.float64), ((0, ph), (0, pw), (0, 0)),
                     mode="edge")
        r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
        y = 0.299 * r + 0.587 * g + 0.114 * b
        cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128
        cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128

        def down(c):
            h, w = c.shape
            return c.reshape(h // vs, vs, w // hs, hs).mean(axis=(1, 3))
        planes = [y, down(cb), down(cr)]
    qts = [quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)]
    m = _dct_matrix()
    coefs = []   # per component [by, bx, 64] zigzag quantized
    for i, plane in enumerate(planes):
        blocks = _blocks(plane - 128.0)
        f = np.einsum("ux,abxy,vy->abuv", m, blocks, m)
        q = qts[min(i, 1)].reshape(8, 8)
        qc = np.round(f / q).astype(np.int64).reshape(f.shape[:2] + (64,))
        coefs.append(qc[..., ZIGZAG])
    factors = [(hs, vs)] + [(1, 1)] * (len(planes) - 1)
    mcu_y, mcu_x = (H + mh - 1) // mh, (W + mw - 1) // mw
    order = []   # (component, block row, block col) in scan order
    for my in range(mcu_y):
        for mx in range(mcu_x):
            for c, (h, v) in enumerate(factors):
                for yy in range(v):
                    for xx in range(h):
                        order.append((c, my * v + yy, mx * h + xx))
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)),
              (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    values, lengths = [], []

    def put(code_len, extra=None, size=0):
        values.append(code_len[0])
        lengths.append(code_len[1])
        if size:
            values.append(extra)
            lengths.append(size)

    pred = [0] * len(planes)
    for c, by, bx in order:
        blk = coefs[c][by, bx]
        dc_codes, ac_codes = tables[min(c, 1)]
        diff = int(blk[0]) - pred[c]
        pred[c] = int(blk[0])
        s = _size(diff)
        put(dc_codes[s], diff if diff >= 0 else diff + (1 << s) - 1, s)
        run = 0
        nz = np.flatnonzero(blk[1:]) + 1
        last = 0
        for k in nz.tolist():
            run = k - last - 1
            while run > 15:
                put(ac_codes[0xF0])
                run -= 16
            v = int(blk[k])
            s = _size(v)
            put(ac_codes[(run << 4) | s], v if v >= 0 else v + (1 << s) - 1,
                s)
            last = k
        if last != 63:
            put(ac_codes[0x00])
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    shifts = np.arange(15, -1, -1)
    bits = (values[:, None] >> shifts[None, :]) & 1
    keep = shifts[None, :] < lengths[:, None]
    stream = bits[keep].astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    data = np.packbits(stream)
    ff = np.flatnonzero(data == 0xFF)
    data = np.insert(data, ff + 1, 0).tobytes()

    out = b"\xff\xd8" + _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00"
                                 b"\x01\x00\x00")
    for i in range(min(len(planes), 2)):
        out += _segment(0xDB, bytes([i]) + bytes(
            qts[i].reshape(64)[ZIGZAG].astype(np.uint8).tolist()))
    sof = struct.pack(">BHHB", 8, H, W, len(planes))
    for c, (h, v) in enumerate(factors):
        sof += bytes([c + 1, (h << 4) | v, min(c, 1)])
    out += _segment(0xC0, sof)
    for i, (dc, ac) in enumerate(((DC_LUMA, AC_LUMA),
                                  (DC_CHROMA, AC_CHROMA))[:min(len(planes),
                                                              2)]):
        out += _segment(0xC4, bytes([i]) + bytes(dc[0]) + dc[1])
        out += _segment(0xC4, bytes([0x10 | i]) + bytes(ac[0]) + ac[1])
    sos = bytes([len(planes)])
    for c in range(len(planes)):
        sos += bytes([c + 1, (min(c, 1) << 4) | min(c, 1)])
    out += _segment(0xDA, sos + b"\x00\x3f\x00")
    return out + data + b"\xff\xd9"
