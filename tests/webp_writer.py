"""WebP files without PIL or libwebp, for the parts of the format PIL's
encoder never writes: VP8 key frames with the simple loop filter,
sharpness, loop-filter deltas, explicit segment maps and quantizers, skip
flags, coefficient-probability updates and several token partitions
(RFC 6386), and the RIFF chunks around them (VP8X, ALPH, ANIM, ANMF).

The VP8 writer does not compress an image: it writes seeded modes and
small seeded coefficients, which any decoder turns into the same pixels,
so PIL's decode of the file is the reference. Its probability tables are
read from videollama2_tpu_torch/media/csrc/webp_decode.cc: a wrong entry
there makes the writer encode symbols libwebp reads differently, and the
comparison with PIL fails.
"""

from __future__ import annotations

import os
import re
import struct

import numpy as np

_SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "videollama2_tpu_torch", "media", "csrc", "webp_decode.cc")


def _table(name: str, shape) -> np.ndarray:
    with open(_SRC) as f:
        text = f.read()
    body = re.search(name + r"\[[^=]*= \{(.*?)\n\};", text, re.S).group(1)
    return np.array([int(v) for v in re.findall(r"\d+", body)],
                    np.int64).reshape(shape)


DC_TABLE = _table("kDcTable", (128,))
AC_TABLE = _table("kAcTable", (128,))
COEFFS_PROBA0 = _table("kCoeffsProba0", (4, 8, 3, 11))
COEFFS_UPDATE = _table("kCoeffsUpdateProba", (4, 8, 3, 11))
BMODES_PROBA = _table("kBModesProba", (10, 10, 9))
BANDS = (0, 1, 2, 3, 6, 4, 5, 6, 6, 6, 6, 6, 6, 6, 6, 7, 0)
ZIGZAG = (0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15)
CAT_PROBS = ((173, 148, 140), (176, 155, 140, 135), (180, 157, 141, 134, 130),
             (254, 254, 243, 230, 196, 177, 153, 140, 133, 130, 129))
# libwebp's mode numbers: DC, TM, VE, HE, RD, VR, LD, VL, HD, HU; the
# 16x16 and chroma modes are the first four
_BMODE_PATHS = {0: ((0, 0),), 1: ((1, 0), (0, 1)), 2: ((1, 0), (1, 1), (0, 2)),
                3: ((1, 0), (1, 1), (1, 2), (0, 3), (0, 4)),
                4: ((1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (0, 5)),
                5: ((1, 0), (1, 1), (1, 2), (0, 3), (1, 4), (1, 5)),
                6: ((1, 0), (1, 1), (1, 2), (1, 3), (0, 6)),
                7: ((1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (0, 7)),
                8: ((1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7), (0, 8)),
                9: ((1, 0), (1, 1), (1, 2), (1, 3), (1, 6), (1, 7), (1, 8))}
_YMODE_BITS = {0: ((0, 156), (0, 163)), 2: ((0, 156), (1, 163)),
               3: ((1, 156), (0, 128)), 1: ((1, 156), (1, 128))}
_UVMODE_BITS = {0: ((0, 142),), 2: ((1, 142), (0, 114)),
                3: ((1, 142), (1, 114), (0, 183)),
                1: ((1, 142), (1, 114), (1, 183))}


class BoolEncoder:
    """RFC 6386 section 7.3's boolean entropy encoder."""

    def __init__(self):
        self.out = bytearray()
        self.range, self.bottom, self.bit_count = 255, 0, 24

    def _carry(self):
        i = len(self.out) - 1
        while self.out[i] == 255:
            self.out[i] = 0
            i -= 1
        self.out[i] += 1

    def put(self, bit: int, prob: int) -> None:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            if self.bottom & (1 << 31):
                self._carry()
            self.bottom = (self.bottom << 1) & 0xFFFFFFFF
            self.bit_count -= 1
            if not self.bit_count:
                self.out.append((self.bottom >> 24) & 0xFF)
                self.bottom &= (1 << 24) - 1
                self.bit_count = 8

    def literal(self, value: int, nbits: int) -> None:
        for b in range(nbits - 1, -1, -1):
            self.put((value >> b) & 1, 128)

    def signed(self, value: int, nbits: int) -> None:
        self.literal(abs(value), nbits)
        self.put(int(value < 0), 128)

    def flag_signed(self, value: int, nbits: int) -> None:
        self.put(int(value != 0), 128)
        if value:
            self.signed(value, nbits)

    def finish(self) -> bytes:
        c, v = self.bit_count, self.bottom
        if v & (1 << (32 - c)):
            self._carry()
        v = (v << (c & 7)) & 0xFFFFFFFF
        for _ in range(c >> 3):
            v = (v << 8) & 0xFFFFFFFF
        for _ in range(4):
            self.out.append((v >> 24) & 0xFF)
            v = (v << 8) & 0xFFFFFFFF
        return bytes(self.out)


def _put_value(enc: BoolEncoder, v: int, p) -> int:
    """A token's magnitude (1 to 2114); returns the next context."""
    if v == 1:
        enc.put(0, p[2])
        return 1
    enc.put(1, p[2])
    if v <= 4:
        enc.put(0, p[3])
        if v == 2:
            enc.put(0, p[4])
        else:
            enc.put(1, p[4])
            enc.put(v - 3, p[5])
    elif v <= 10:
        enc.put(1, p[3])
        enc.put(0, p[6])
        if v <= 6:
            enc.put(0, p[7])
            enc.put(v - 5, 159)
        else:
            enc.put(1, p[7])
            enc.put((v - 7) >> 1, 165)
            enc.put((v - 7) & 1, 145)
    else:
        enc.put(1, p[3])
        enc.put(1, p[6])
        cat = 0 if v < 19 else 1 if v < 35 else 2 if v < 67 else 3
        enc.put(cat >> 1, p[8])
        enc.put(cat & 1, p[9 + (cat >> 1)])
        extra = v - (3 + (8 << cat))
        probs = CAT_PROBS[cat]
        for i, prob in enumerate(probs):
            enc.put((extra >> (len(probs) - 1 - i)) & 1, prob)
    return 2


def _put_block(enc: BoolEncoder, proba, ctx: int, levels, first: int) -> bool:
    """One block's levels (zigzag order) from position `first`; returns
    whether any was coded (the next blocks' context)."""
    nonzero = [i for i in range(first, 16) if levels[i]]
    last = nonzero[-1] if nonzero else -1
    n, p = first, proba[BANDS[first]][ctx]
    while n < 16:
        if n > last:
            enc.put(0, p[0])
            break
        enc.put(1, p[0])
        while not levels[n]:
            enc.put(0, p[1])
            n += 1
            p = proba[BANDS[n]][0]
        enc.put(1, p[1])
        v = abs(int(levels[n]))
        ctx = _put_value(enc, v, p)
        enc.put(int(levels[n] < 0), 128)
        n += 1
        p = proba[BANDS[n]][ctx]
    return last >= 0


def _levels(rng, first: int, big: float, dq) -> np.ndarray:
    """Seeded levels whose dequantized values stay within +-1023, the
    range real coefficients keep (libwebp's SIMD transforms use 16-bit
    lanes, which a larger value would overflow)."""
    lv = np.zeros(16, np.int64)
    for i in range(first, 16):
        if rng.random() < (0.6 if i == 0 else 0.25 if i < 4 else 0.06):
            mag = int(rng.geometric(0.55))
            if rng.random() < big:
                mag = int(rng.integers(11, 2115))
            mag = max(1, min(mag, 1023 // dq[i > 0]))
            lv[i] = mag if rng.random() < 0.5 else -mag
    return lv


def _quantizers(q: int, d) -> tuple:
    """libwebp's VP8ParseQuant for one segment: (y1, y2, uv) steps, each
    (dc, ac)."""
    def clip(v, m=127):
        return min(max(v, 0), m)
    y2_ac = int(AC_TABLE[clip(q + d[2])]) * 101581 >> 16
    return ((int(DC_TABLE[clip(q + d[0])]), int(AC_TABLE[clip(q)])),
            (2 * int(DC_TABLE[clip(q + d[1])]), max(y2_ac, 8)),
            (int(DC_TABLE[clip(q + d[3], 117)]),
             int(AC_TABLE[clip(q + d[4])])))


def encode_vp8(width: int, height: int, seed: int = 0, *, simple=False,
               level=20, sharpness=0, ref_lf_delta=None, mode_lf_delta=None,
               partitions_log2=0, segments=None, base_q=12,
               q_deltas=(0, 0, 0, 0, 0), skip_prob=None, updates=0.0,
               big=0.01, i4x4_share=0.5) -> bytes:
    """A VP8 key frame's bytes (a VP8 chunk's payload). `segments`:
    None, or a dict with "absolute" (bool), "quant" and "filter" (4
    values each) and "map" (3 tree probabilities, or None to keep the map
    off); `q_deltas`: y1 dc, y2 dc, y2 ac, uv dc, uv ac."""
    rng = np.random.default_rng(seed)
    hdr = BoolEncoder()
    hdr.literal(0, 1)  # color space
    hdr.literal(0, 1)  # clamping type
    hdr.put(int(segments is not None), 128)
    seg_map = None
    if segments is not None:
        seg_map = segments.get("map")
        hdr.put(int(seg_map is not None), 128)
        hdr.put(1, 128)  # update the segment data
        hdr.put(int(segments["absolute"]), 128)
        for q in segments["quant"]:
            hdr.flag_signed(q, 7)
        for f in segments["filter"]:
            hdr.flag_signed(f, 6)
        if seg_map is not None:
            for p in seg_map:
                hdr.put(int(p != 255), 128)
                if p != 255:
                    hdr.literal(p, 8)
    hdr.put(int(simple), 128)
    hdr.literal(level, 6)
    hdr.literal(sharpness, 3)
    deltas = ref_lf_delta is not None or mode_lf_delta is not None
    hdr.put(int(deltas), 128)
    if deltas:
        hdr.put(1, 128)
        for d in tuple(ref_lf_delta or (0,) * 4) + tuple(mode_lf_delta
                                                         or (0,) * 4):
            hdr.flag_signed(d, 6)
    hdr.literal(partitions_log2, 2)
    hdr.literal(base_q, 7)
    for d in q_deltas:
        hdr.flag_signed(d, 4)
    hdr.put(0, 128)  # refresh_entropy_probs
    proba = COEFFS_PROBA0.copy()
    for t, b, c, p in np.ndindex(4, 8, 3, 11):
        upd = rng.random() < updates
        hdr.put(int(upd), int(COEFFS_UPDATE[t, b, c, p]))
        if upd:
            proba[t, b, c, p] = int(rng.integers(1, 256))
            hdr.literal(int(proba[t, b, c, p]), 8)
    hdr.put(int(skip_prob is not None), 128)
    if skip_prob is not None:
        hdr.literal(skip_prob, 8)

    if segments is None:
        dqs = [_quantizers(base_q, q_deltas)] * 4
    else:
        dqs = [_quantizers(q + (0 if segments["absolute"] else base_q),
                           q_deltas) for q in segments["quant"]]
    mb_w, mb_h = (width + 15) // 16, (height + 15) // 16
    nparts = 1 << partitions_log2
    parts = [BoolEncoder() for _ in range(nparts)]
    intra_t = [0] * (4 * mb_w)
    nz_top = [[0] * 9 for _ in range(mb_w)]   # 4 y, 2 u, 2 v, y2
    for mb_y in range(mb_h):
        tok = parts[mb_y % nparts]
        intra_l = [0] * 4
        nz_left = [0] * 9
        for mb_x in range(mb_w):
            s = 0
            if seg_map is not None:
                s = int(rng.integers(4))
                if s < 2:
                    hdr.put(0, seg_map[0])
                    hdr.put(s, seg_map[1])
                else:
                    hdr.put(1, seg_map[0])
                    hdr.put(s - 2, seg_map[2])
            skip = skip_prob is not None and rng.random() < 0.3
            if skip_prob is not None:
                hdr.put(int(skip), skip_prob)
            i4x4 = rng.random() < i4x4_share
            hdr.put(int(not i4x4), 145)
            top = intra_t[4 * mb_x:4 * mb_x + 4]
            if i4x4:
                for y in range(4):
                    left = intra_l[y]
                    for x in range(4):
                        m = int(rng.integers(10))
                        for bit, node in _BMODE_PATHS[m]:
                            hdr.put(bit, int(BMODES_PROBA[top[x], left, node]))
                        top[x] = left = m
                    intra_l[y] = left
            else:
                m = int(rng.integers(4))
                for bit, prob in _YMODE_BITS[m]:
                    hdr.put(bit, prob)
                top = [m] * 4
                intra_l = [m] * 4
            intra_t[4 * mb_x:4 * mb_x + 4] = top
            for bit, prob in _UVMODE_BITS[int(rng.integers(4))]:
                hdr.put(bit, prob)
            tnz, lnz = nz_top[mb_x], nz_left
            if skip:
                for i in range(8):
                    tnz[i] = lnz[i] = 0
                if not i4x4:
                    tnz[8] = lnz[8] = 0
                continue
            first = 0
            if not i4x4:
                coded = _put_block(tok, proba[1], tnz[8] + lnz[8],
                                   _levels(rng, 0, big, dqs[s][1]), 0)
                tnz[8] = lnz[8] = int(coded)
                first = 1
            ytype = 3 if i4x4 else 0
            for y in range(4):
                for x in range(4):
                    coded = _put_block(tok, proba[ytype], tnz[x] + lnz[y],
                                       _levels(rng, first, big, dqs[s][0]), first)
                    tnz[x] = lnz[y] = int(coded)
            for ch in (4, 6):
                for y in range(2):
                    for x in range(2):
                        coded = _put_block(tok, proba[2],
                                           tnz[ch + x] + lnz[ch + y],
                                           _levels(rng, 0, big, dqs[s][2]),
                                           0)
                        tnz[ch + x] = lnz[ch + y] = int(coded)
    first_part = hdr.finish()
    tokens = [p.finish() for p in parts]
    tag = (1 << 4) | (len(first_part) << 5)   # key frame, profile 0, shown
    out = bytearray(struct.pack("<I", tag)[:3])
    out += b"\x9d\x01\x2a" + struct.pack("<HH", width, height)
    out += first_part
    for t in tokens[:-1]:
        out += struct.pack("<I", len(t))[:3]
    for t in tokens:
        out += t
    return bytes(out)


def chunk(fourcc: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return (fourcc + struct.pack("<I", len(payload)) + payload
            + b"\x00" * (len(payload) & 1))


def riff(*chunks: bytes) -> bytes:
    body = b"WEBP" + b"".join(chunks)
    return b"RIFF" + struct.pack("<I", len(body)) + body


def vp8x(width: int, height: int, flags: int) -> bytes:
    """A VP8X chunk (flags: 0x02 animation, 0x10 alpha, 0x20 ICC, 0x08
    EXIF, 0x04 XMP)."""
    return chunk(b"VP8X", bytes([flags, 0, 0, 0])
                 + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little"))


def anmf(x: int, y: int, width: int, height: int, *frame_chunks: bytes,
         duration: int = 100, flags: int = 0) -> bytes:
    """An animation frame at (x, y) (both even) holding the given chunks."""
    return chunk(b"ANMF", (x // 2).to_bytes(3, "little")
                 + (y // 2).to_bytes(3, "little")
                 + (width - 1).to_bytes(3, "little")
                 + (height - 1).to_bytes(3, "little")
                 + duration.to_bytes(3, "little") + bytes([flags])
                 + b"".join(frame_chunks))


def image_chunks(webp: bytes) -> list:
    """The chunks after a RIFF file's header (and its VP8X chunk)."""
    pos, out = 12, []
    while pos + 8 <= len(webp):
        size = struct.unpack("<I", webp[pos + 4:pos + 8])[0]
        end = pos + 8 + size + (size & 1)
        if webp[pos:pos + 4] != b"VP8X":
            out.append(webp[pos:end])
        pos = end
    return out
