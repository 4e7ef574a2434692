"""WebP stills for media/image_io.py, without PIL or libwebp.

PIL opens a WebP file through libwebp's WebPAnimDecoder: the demuxer
(demux.c) checks the RIFF container, then the first frame is decoded into
an RGBA canvas of the VP8X size that starts as transparent black, with the
default decoder options. This module walks the container as the demuxer
does, refusing with ValueError what it refuses, and hands the first
frame's chunks to csrc/webp_decode.cc:

  - simple files: one VP8 (lossy) or VP8L (lossless) chunk;
  - extended files (VP8X): an optional ALPH chunk and a VP8 chunk, or a
    VP8L chunk; ICCP, EXIF, XMP and unknown chunks are skipped (PIL
    applies none of them); an ALPH chunk is read only where the VP8X
    alpha flag is set, as the demuxer drops it otherwise;
  - animations (ANIM, ANMF): the first frame, drawn at its offset, with
    zeros around it; later frames are checked, not decoded.

Alpha is decoded, so that a bad ALPH chunk fails as it does in PIL, and
then dropped: `convert("RGB")` of a non-premultiplied RGBA canvas keeps
the color channels as they are.
"""

from __future__ import annotations

import ctypes
import struct
import threading

import numpy as np

from . import _native

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
# VP8X flags: animation, XMP, EXIF, alpha, ICC profile; the rest reserved
_ANIMATION, _ALPHA, _VALID_FLAGS = 0x02, 0x10, 0x3E

_lib = None
_lib_lock = threading.Lock()


def _webp_lib():
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = _native.load("webp_decode.cc")
            c_int, c_long, c_char_p, c_void_p = (
                ctypes.c_int, ctypes.c_long, ctypes.c_char_p, ctypes.c_void_p)
            lib.webp_vp8l.restype = c_int
            lib.webp_vp8l.argtypes = [c_char_p, c_long, c_int, c_int,
                                      c_void_p, c_char_p, c_int]
            lib.webp_vp8.restype = c_int
            lib.webp_vp8.argtypes = [c_char_p, c_long, c_long, c_int, c_int,
                                     c_void_p, c_char_p, c_int]
            lib.webp_alpha.restype = c_int
            lib.webp_alpha.argtypes = [c_char_p, c_long, c_int, c_int,
                                       c_void_p, c_char_p, c_int]
            _lib = lib
    return _lib


class _Frame:
    """One frame's image-bearing chunks: (payload offset, payload size,
    padded size) of its ALPH and VP8 / VP8L chunks."""

    def __init__(self, x=0, y=0):
        self.x, self.y = x, y
        self.width = self.height = 0
        self.alpha = None
        self.image = None
        self.lossless = False


def _le24(b: bytes) -> int:
    return b[0] | (b[1] << 8) | (b[2] << 16)


def _features(buf: bytes, off: int, size: int, padded: int, fourcc: bytes):
    """WebPGetFeatures on one VP8 / VP8L chunk: (width, height)."""
    payload = buf[off:off + padded]
    if fourcc == b"VP8L":
        if len(payload) < 5 or payload[0] != 0x2F or payload[4] >> 5:
            raise ValueError("WebP: bad VP8L header")
        bits = int.from_bytes(payload[1:5], "little")
        return (bits & 0x3FFF) + 1, ((bits >> 14) & 0x3FFF) + 1
    if len(payload) < 10:
        raise ValueError("WebP: VP8 chunk shorter than its frame header")
    bits = _le24(payload)
    if payload[3:6] != b"\x9d\x01\x2a":
        raise ValueError("WebP: bad VP8 start code")
    if bits & 1:
        raise ValueError("WebP: VP8 chunk without a key frame")
    if (bits >> 1) & 7 > 3 or not (bits >> 4) & 1 or bits >> 5 >= size:
        raise ValueError("WebP: bad VP8 frame tag")
    w, h = (struct.unpack("<H", payload[6:8])[0] & 0x3FFF,
            struct.unpack("<H", payload[8:10])[0] & 0x3FFF)
    if not w or not h:
        raise ValueError("WebP: VP8 frame of zero width or height")
    return w, h


def _chunk(buf: bytes, pos: int, end: int):
    """(fourcc, payload size, padded size) of the chunk at pos, checked to
    fit before end, as the demuxer's SizeIsInvalid."""
    fourcc = buf[pos:pos + 4]
    size = struct.unpack("<I", buf[pos + 4:pos + 8])[0]
    if size > _MAX_CHUNK_PAYLOAD:
        raise ValueError("WebP: chunk size out of range")
    padded = size + (size & 1)
    if padded > end - pos - 8:
        raise ValueError(f"WebP: {fourcc!r} chunk runs past the RIFF end")
    return fourcc, size, padded


def _store_frame(buf: bytes, pos: int, end: int, min_size: int,
                 frame: _Frame) -> int:
    """demux.c StoreFrame: the ALPH and image chunks from pos; returns the
    position of the first chunk it did not take."""
    if end - pos < 8 or end - pos < min_size:
        raise ValueError("WebP: frame data truncated")
    while True:
        fourcc, size, padded = _chunk(buf, pos, end)
        if fourcc == b"ALPH" and frame.alpha is None:
            frame.alpha = (pos + 8, size, padded)
        elif fourcc in (b"VP8 ", b"VP8L") and frame.image is None:
            if fourcc == b"VP8L" and frame.alpha is not None:
                raise ValueError("WebP: VP8L image after an ALPH chunk")
            frame.width, frame.height = _features(buf, pos + 8, size, padded,
                                                  fourcc)
            frame.image = (pos + 8, size, padded)
            frame.lossless = fourcc == b"VP8L"
        else:
            return pos
        pos += 8 + padded
        if pos == end:
            return pos
        if end - pos < 8:
            raise ValueError("WebP: a partial chunk header at the RIFF end")


def _demux(buf: bytes):
    """The container -> (canvas width, height, first frame)."""
    if len(buf) < 20:
        raise ValueError("WebP file shorter than its RIFF header")
    riff_size = struct.unpack("<I", buf[4:8])[0]
    if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
        raise ValueError(f"WebP: RIFF size {riff_size}")
    end = riff_size + 8
    if len(buf) < end:
        raise ValueError("WebP file truncated before its RIFF end")
    first = buf[12:16]
    if first in (b"VP8 ", b"VP8L"):
        frame = _Frame()
        _store_frame(buf, 12, end, 0, frame)
        if frame.image is None:
            raise ValueError("WebP without an image chunk")
        frame.alpha = None  # no VP8X alpha flag
        return frame.width, frame.height, frame
    if first != b"VP8X":
        raise ValueError(f"WebP: unknown first chunk {first!r}")
    _, size, padded = _chunk(buf, 12, end)
    if size < 10:
        raise ValueError("WebP: VP8X chunk too short")
    flags = buf[20]
    cw, ch = 1 + _le24(buf[24:27]), 1 + _le24(buf[27:30])
    if cw * ch >= _MAX_IMAGE_AREA:
        raise ValueError("WebP: canvas too large")
    animated = bool(flags & _ANIMATION)
    pos = 20 + padded
    if end - pos < 8:
        raise ValueError("WebP: VP8X file without chunks")
    frames, anim = [], False
    while True:
        fourcc, size, padded = _chunk(buf, pos, end)
        if fourcc == b"VP8X":
            raise ValueError("WebP: a second VP8X chunk")
        if fourcc in (b"ALPH", b"VP8 ", b"VP8L"):
            if anim or animated or frames:
                raise ValueError("WebP: an image chunk outside ANMF in an "
                                 "animation, or a second image")
            frame = _Frame()
            pos = _store_frame(buf, pos, end, 0, frame)
            if not flags & _ALPHA:
                frame.alpha = None
            frames.append(frame)
        elif fourcc == b"ANIM":
            if padded < 6:
                raise ValueError("WebP: ANIM chunk too short")
            anim = True
            pos += 8 + padded
        elif fourcc == b"ANMF":
            if not anim:
                raise ValueError("WebP: ANMF before ANIM")
            if padded < 16:
                raise ValueError("WebP: ANMF chunk too short")
            head = buf[pos + 8:pos + 24]
            frame = _Frame(2 * _le24(head[0:3]), 2 * _le24(head[3:6]))
            if (1 + _le24(head[6:9])) * (1 + _le24(head[9:12])) \
                    >= _MAX_IMAGE_AREA:
                raise ValueError("WebP: ANMF frame too large")
            start = pos + 24
            pos = _store_frame(buf, start, end, padded - 16, frame)
            if pos - start > padded - 16:
                raise ValueError("WebP: ANMF frame runs past its chunk")
            if animated and (frame.image or frame.alpha):
                if frames and frames[-1].image is None:
                    raise ValueError("WebP: a frame after an incomplete "
                                     "one")
                frames.append(frame)
        else:  # ICCP, EXIF, XMP, unknown: skipped
            pos += 8 + padded
        if pos == end:
            break
        if end - pos < 8:
            raise ValueError("WebP: a partial chunk header at the RIFF end")
    if not frames:
        raise ValueError("WebP: VP8X file without a frame")
    if flags & ~_VALID_FLAGS & 0xFF:
        raise ValueError(f"WebP: reserved VP8X flags set ({flags:#x})")
    for f in frames:
        if f.image is None:
            raise ValueError("WebP: a frame without an image chunk")
        if f.alpha is not None and f.alpha[0] > f.image[0]:
            raise ValueError("WebP: ALPH after the image chunk")
        if animated:
            inside = f.x + f.width <= cw and f.y + f.height <= ch
        else:
            inside = (f.x, f.y, f.width, f.height) == (0, 0, cw, ch)
        if not inside:
            raise ValueError("WebP: a frame outside the canvas")
    return cw, ch, frames[0]


def _check(status: int, msg) -> None:
    if status:
        raise ValueError(msg.value.decode(errors="replace"))


def read_webp(data: bytes, max_pixels: int) -> np.ndarray:
    """A RIFF WebP file -> [H, W, 3] uint8, PIL's `convert("RGB")` of its
    first frame."""
    cw, ch, frame = _demux(data)
    if cw * ch > max_pixels:
        raise ValueError(f"WebP of {cw}x{ch}: more than {max_pixels} pixels")
    lib = _webp_lib()
    msg = ctypes.create_string_buffer(256)
    w, h = frame.width, frame.height
    off, size, padded = frame.image
    payload = data[off:off + padded]
    rgb = np.empty((h, w, 3), np.uint8)
    ptr = rgb.ctypes.data_as(ctypes.c_void_p)
    if frame.lossless:
        _check(lib.webp_vp8l(payload, padded, w, h, ptr, msg, len(msg)), msg)
    else:
        _check(lib.webp_vp8(payload, padded, size, w, h, ptr, msg, len(msg)),
               msg)
        if frame.alpha is not None:
            a_off, a_size, _ = frame.alpha
            alpha = np.empty((h, w), np.uint8)
            _check(lib.webp_alpha(data[a_off:a_off + a_size], a_size, w, h,
                                  alpha.ctypes.data_as(ctypes.c_void_p), msg,
                                  len(msg)), msg)
    if (frame.x, frame.y, w, h) == (0, 0, cw, ch):
        return rgb
    canvas = np.zeros((ch, cw, 3), np.uint8)
    canvas[frame.y:frame.y + h, frame.x:frame.x + w] = rgb
    return canvas
