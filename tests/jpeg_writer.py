"""Minimal JPEG encoder (numpy): the example quantization tables of the
JPEG standard's Annex K scaled by libjpeg's quality rule; baseline with
Annex K's typical Huffman tables, or progressive (any scan script, as
libjpeg's jcphuff.c codes it, one optimal Huffman table a scan); 8-bit
gray, YCbCr at 4:4:4, 4:2:2, 4:2:0, 4:4:0 or 4:1:1, or any planes with
any sampling factors, ids and APP segments (RGB-coded, CMYK, YCCK).

Test and smoke-run infrastructure for the port's JPEG decoder
(videollama2_tpu_torch/media/csrc/jpeg_decode.cc): the GPU host has no
PIL, and PIL's encoder writes no progressive script but libjpeg's, no
YCCK and no 4:4:0 or 4:1:1, so those files are written here. The
transform is a float DCT and chroma is box-averaged; what matters is a
valid stream, which any decoder reads to the same pixels.
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

SAMPLING = {"4:4:4": (1, 1), "4:2:2": (2, 1), "4:2:0": (2, 2),
            "4:4:0": (1, 2), "4:1:1": (4, 1)}


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


def segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def ycbcr(rgb: np.ndarray):
    """[H, W, 3] RGB -> the three JFIF planes Y, Cb, Cr (float)."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    return [0.299 * r + 0.587 * g + 0.114 * b,
            -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
            0.5 * r - 0.418688 * g - 0.081312 * b + 128]


def _quantized(planes, factors, qts):
    """Full-size sample planes -> per component [by, bx, 64] quantized
    coefficients in zigzag order over the MCU-padded block grid (chroma
    box-averaged to its sampling factors)."""
    H, W = planes[0].shape
    hmax = max(h for h, _ in factors)
    vmax = max(v for _, v in factors)
    ph, pw = -H % (8 * vmax), -W % (8 * hmax)
    m = _dct_matrix()
    coefs = []
    for i, (plane, (h, v)) in enumerate(zip(planes, factors)):
        p = np.pad(np.asarray(plane, np.float64), ((0, ph), (0, pw)),
                   mode="edge")
        rv, rh = vmax // v, hmax // h
        p = p.reshape(p.shape[0] // rv, rv, p.shape[1] // rh,
                      rh).mean(axis=(1, 3))
        f = np.einsum("ux,abxy,vy->abuv", m, _blocks(p - 128.0), m)
        q = qts[min(i, 1)].reshape(8, 8)
        qc = np.round(f / q).astype(np.int64).reshape(f.shape[:2] + (64,))
        coefs.append(qc[..., ZIGZAG])
    return coefs, hmax, vmax


def _stuff(values, lengths) -> bytes:
    """Codes (value, bit length) -> entropy-coded bytes, padded with ones,
    0xFF stuffed."""
    values = np.asarray(values, np.int64)
    lengths = np.asarray(lengths, np.int64)
    shifts = np.arange(15, -1, -1)
    bits = (values[:, None] >> shifts[None, :]) & 1
    keep = shifts[None, :] < lengths[:, None]
    stream = bits[keep].astype(np.uint8)
    stream = np.concatenate([stream, np.ones(-len(stream) % 8, np.uint8)])
    data = np.packbits(stream)
    ff = np.flatnonzero(data == 0xFF)
    return np.insert(data, ff + 1, 0).tobytes()


def _header(planes, factors, qts, marker, app, ids) -> bytes:
    out = b"\xff\xd8" + app
    for i in range(min(len(planes), 2)):
        out += segment(0xDB, bytes([i]) + bytes(
            qts[i].reshape(64)[ZIGZAG].astype(np.uint8).tolist()))
    H, W = planes[0].shape
    sof = struct.pack(">BHHB", 8, H, W, len(planes))
    for c, (h, v) in enumerate(factors):
        sof += bytes([ids[c], (h << 4) | v, min(c, 1)])
    return out + segment(marker, sof)


JFIF = segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")


def adobe(transform: int) -> bytes:
    """An APP14 Adobe segment naming the color transform (0 none: RGB or
    CMYK; 1 YCbCr; 2 YCCK)."""
    return segment(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                    + bytes([transform]))


def encode_planes(planes, factors, quality: int = 75, *, app=JFIF,
                  ids=None, script=None, before_scan=None) -> bytes:
    """Full-size [H, W] sample planes (one a component) with their (h, v)
    sampling factors -> JPEG bytes: baseline with the Annex K Huffman
    tables, or, with `script`, progressive (SOF2) with one optimal
    Huffman table a scan. `script` lists scans (components, Ss, Se, Ah,
    Al); `before_scan` maps a scan's index to raw segments written before
    it (e.g. a DQT)."""
    qts = [quant_table(LUMA_Q, quality), quant_table(CHROMA_Q, quality)]
    coefs, hmax, vmax = _quantized(planes, factors, qts)
    ids = ids or list(range(1, len(planes) + 1))
    if script is None:
        out = _header(planes, factors, qts, 0xC0, app, ids)
        for i, (dc, ac) in enumerate(((DC_LUMA, AC_LUMA),
                                      (DC_CHROMA, AC_CHROMA))[
                                          :min(len(planes), 2)]):
            out += segment(0xC4, bytes([i]) + bytes(dc[0]) + dc[1])
            out += segment(0xC4, bytes([0x10 | i]) + bytes(ac[0]) + ac[1])
        sos = bytes([len(planes)])
        for c in range(len(planes)):
            sos += bytes([ids[c], (min(c, 1) << 4) | min(c, 1)])
        out += segment(0xDA, sos + b"\x00\x3f\x00")
        return out + _baseline_scan(coefs, factors) + b"\xff\xd9"
    out = _header(planes, factors, qts, 0xC2, app, ids)
    H, W = planes[0].shape
    for n, (comps, ss, se, ah, al) in enumerate(script):
        out += (before_scan or {}).get(n, b"")
        tokens = _progressive_tokens(coefs, factors, hmax, vmax, H, W,
                                     comps, ss, se, ah, al)
        syms = [t for t, _, _ in tokens if t >= 0]
        counts, symbols, codes = _optimal_table(syms)
        dc_scan = ss == 0
        if syms:   # a DC refinement scan codes no symbol
            out += segment(0xC4, bytes([(0 if dc_scan else 0x10)])
                            + bytes(counts) + bytes(symbols))
        sos = bytes([len(comps)])
        for c in comps:
            sos += bytes([ids[c], 0x00])
        out += segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        values, lengths = [], []
        for sym, extra, nbits in tokens:
            if sym >= 0:
                code, length = codes[sym]
                values.append(code)
                lengths.append(length)
            if nbits:
                values.append(extra & ((1 << nbits) - 1))
                lengths.append(nbits)
        out += _stuff(values, lengths) if values else b""
    return out + b"\xff\xd9"


def _baseline_scan(coefs, factors) -> bytes:
    mcu_y = coefs[0].shape[0] // factors[0][1]
    mcu_x = coefs[0].shape[1] // factors[0][0]
    tables = [(_codes(DC_LUMA), _codes(AC_LUMA)),
              (_codes(DC_CHROMA), _codes(AC_CHROMA))]
    values, lengths = [], []

    def put(code_len, extra=None, size=0):
        values.append(code_len[0])
        lengths.append(code_len[1])
        if size:
            values.append(extra)
            lengths.append(size)

    pred = [0] * len(coefs)
    for my in range(mcu_y):
        for mx in range(mcu_x):
            for c, (h, v) in enumerate(factors):
                for yy in range(v):
                    for xx in range(h):
                        blk = coefs[c][my * v + yy, mx * h + xx]
                        dc_codes, ac_codes = tables[min(c, 1)]
                        diff = int(blk[0]) - pred[c]
                        pred[c] = int(blk[0])
                        s = _size(diff)
                        put(dc_codes[s],
                            diff if diff >= 0 else diff + (1 << s) - 1, s)
                        last = 0
                        for k in (np.flatnonzero(blk[1:]) + 1).tolist():
                            run = k - last - 1
                            while run > 15:
                                put(ac_codes[0xF0])
                                run -= 16
                            val = int(blk[k])
                            s = _size(val)
                            put(ac_codes[(run << 4) | s],
                                val if val >= 0 else val + (1 << s) - 1, s)
                            last = k
                        if last != 63:
                            put(ac_codes[0x00])
    return _stuff(values, lengths)


def _progressive_tokens(coefs, factors, hmax, vmax, H, W, comps, ss, se,
                        ah, al):
    """One progressive scan as (symbol or -1, extra bits, bit count)
    tokens, as libjpeg's jcphuff.c encodes it (EOB runs, ZRLs folded into
    an EOB run, correction bits after the code they follow)."""
    if len(comps) == 1:
        c = comps[0]
        h, v = factors[c]
        dw, dh = -(-W * h // hmax), -(-H * v // vmax)   # ceilings
        nbx, nby = -(-dw // 8), -(-dh // 8)
        blocks = [(c, by, bx) for by in range(nby) for bx in range(nbx)]
    else:
        blocks = []
        for my in range(coefs[comps[0]].shape[0] // factors[comps[0]][1]):
            for mx in range(coefs[comps[0]].shape[1]
                            // factors[comps[0]][0]):
                for c in comps:
                    h, v = factors[c]
                    blocks += [(c, my * v + yy, mx * h + xx)
                               for yy in range(v) for xx in range(h)]
    tokens = []
    if ss == 0:
        pred = {c: 0 for c in comps}
        for c, by, bx in blocks:
            value = int(coefs[c][by, bx, 0])
            if ah:
                tokens.append((-1, (value >> al) & 1, 1))
                continue
            value >>= al
            diff = value - pred[c]
            pred[c] = value
            s = _size(diff)
            tokens.append((s, diff if diff >= 0 else diff + (1 << s) - 1, s))
        return tokens
    eobrun, pending = 0, []   # pending: correction bits of the EOB run

    def flush():
        nonlocal eobrun, pending
        if eobrun:
            nbits = eobrun.bit_length() - 1
            tokens.append((nbits << 4, eobrun, nbits))
            tokens.extend((-1, b, 1) for b in pending)
            eobrun, pending = 0, []

    for c, by, bx in blocks:
        band = coefs[c][by, bx, ss:se + 1].tolist()
        if ah == 0:
            run = 0
            for val in band:
                mag = abs(val) >> al
                if mag == 0:
                    run += 1
                    continue
                flush()
                while run > 15:
                    tokens.append((0xF0, 0, 0))
                    run -= 16
                s = _size(mag)
                tokens.append(((run << 4) | s,
                               mag if val > 0 else ~mag, s))
                run = 0
            if run:
                eobrun += 1
                if eobrun == 0x7FFF:
                    flush()
            continue
        mags = [abs(val) >> al for val in band]
        eob = max((k for k, mag in enumerate(mags) if mag == 1), default=-1)
        run, corrections = 0, []
        for k, (val, mag) in enumerate(zip(band, mags)):
            if mag == 0:
                run += 1
                continue
            while run > 15 and k <= eob:
                flush()
                tokens.append((0xF0, 0, 0))
                run -= 16
                tokens.extend((-1, b, 1) for b in corrections)
                corrections = []
            if mag > 1:
                corrections.append(mag & 1)
                continue
            flush()
            tokens.append(((run << 4) | 1, 1 if val > 0 else 0, 1))
            tokens.extend((-1, b, 1) for b in corrections)
            corrections, run = [], 0
        if run or corrections:
            eobrun += 1
            pending += corrections
            if eobrun == 0x7FFF or len(pending) > 1000 - 64 + 1:
                flush()
    flush()
    return tokens


def _optimal_table(symbols):
    """libjpeg's jpeg_gen_optimal_table: code counts by length 1-16, the
    symbols in code order and symbol -> (code, length), for the symbol
    frequencies of one scan."""
    freq = [0] * 257
    for s in symbols:
        freq[s] += 1
    if not symbols:
        return [0] * 16, [], {}
    freq[256] = 1   # a reserved code point: no code is all ones
    codesize, others = [0] * 257, [-1] * 257
    while True:
        c1 = c2 = -1
        v1 = v2 = 1 << 62
        for i in range(257):
            if freq[i] and freq[i] <= v1:
                v2, c2, v1, c1 = v1, c1, freq[i], i
            elif freq[i] and freq[i] <= v2:
                v2, c2 = freq[i], i
        if c2 < 0:
            break
        freq[c1] += freq[c2]
        freq[c2] = 0
        codesize[c1] += 1
        while others[c1] >= 0:
            c1 = others[c1]
            codesize[c1] += 1
        others[c1] = c2
        codesize[c2] += 1
        while others[c2] >= 0:
            c2 = others[c2]
            codesize[c2] += 1
    bits = [0] * 33
    for size in codesize:
        if size:
            bits[size] += 1
    for i in range(32, 16, -1):
        while bits[i] > 0:
            j = i - 2
            while bits[j] == 0:
                j -= 1
            bits[i] -= 2
            bits[i - 1] += 1
            bits[j + 1] += 2
            bits[j] -= 1
    i = 16
    while bits[i] == 0:
        i -= 1
    bits[i] -= 1
    order = [s for size in range(1, 33) for s in range(256)
             if codesize[s] == size]
    table = (bits[1:17], bytes(order))
    return bits[1:17], order, _codes(table)


def encode_jpeg(pixels: np.ndarray, quality: int = 75,
                subsampling: str = "4:2:0", script=None) -> bytes:
    """[H, W, 3] RGB or [H, W] gray uint8 -> JPEG bytes (JFIF YCbCr or
    gray): baseline, or progressive with a `script` of scans
    (PROGRESSIVE, or e.g. progressive_script(...))."""
    arr = np.asarray(pixels, np.uint8).astype(np.float64)
    if arr.ndim == 2:
        return encode_planes([arr], [(1, 1)], quality, script=script)
    hs, vs = SAMPLING[subsampling]
    return encode_planes(ycbcr(arr), [(hs, vs), (1, 1), (1, 1)], quality,
                         script=script)


# libjpeg's jpeg_simple_progression script for three components and for
# one: (components, Ss, Se, Ah, Al) a scan
PROGRESSIVE = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
               ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
               ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
               ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
               ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))
PROGRESSIVE_GRAY = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                    ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                    ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))
