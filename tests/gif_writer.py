"""Minimal GIF89a encoder (numpy): LZW, global and local palettes,
transparency, disposal methods and interlacing.

Test and smoke-run infrastructure for the port's GIF reader
(videollama2_tpu_torch/media/video_reader.py): the GPU host has no PIL or
imageio, so GIF videos are written here, with every frame option the
reader must compose as PIL does. `encode_gif` takes palette indices;
`encode_rgb_gif` maps RGB frames onto a fixed 6x6x6 color cube first.
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence

import numpy as np

_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))


def _bits_for(n_colors: int) -> int:
    """The palette size field: 2 ** (field + 1) entries hold n_colors."""
    field = 0
    while (2 << field) < n_colors:
        field += 1
    return field


def _palette_bytes(palette: np.ndarray) -> bytes:
    pal = np.asarray(palette, np.uint8).reshape(-1, 3)
    field = _bits_for(len(pal))
    padded = np.zeros((2 << field, 3), np.uint8)
    padded[:len(pal)] = pal
    return padded.tobytes()


def lzw_encode(indices: np.ndarray, min_code_size: int) -> bytes:
    """Palette indices (flat) -> the LZW code stream in data sub-blocks
    (giflib's code-width rule: a code is widened once the next free code
    no longer fits; a clear code when the table is full)."""
    clear, eoi = 1 << min_code_size, (1 << min_code_size) + 1
    out = bytearray()
    acc = nbits = 0
    size = min_code_size + 1
    next_code = eoi + 1
    table: dict = {}

    def emit(code):
        nonlocal acc, nbits, size
        acc |= code << nbits
        nbits += size
        while nbits >= 8:
            out.append(acc & 255)
            acc >>= 8
            nbits -= 8
        if next_code >= (1 << size) and size < 12:
            size += 1

    emit(clear)
    data = np.asarray(indices, np.uint8).reshape(-1).tolist()
    prefix = data[0]
    for c in data[1:]:
        key = (prefix << 8) | c
        code = table.get(key)
        if code is not None:
            prefix = code
            continue
        emit(prefix)
        if next_code >= 4095:
            emit(clear)
            table.clear()
            next_code = eoi + 1
            size = min_code_size + 1
        else:
            table[key] = next_code
            next_code += 1
        prefix = c
    emit(prefix)
    emit(eoi)
    if nbits:
        out.append(acc & 255)
    blocks = bytearray([min_code_size])
    for i in range(0, len(out), 255):
        chunk = out[i:i + 255]
        blocks.append(len(chunk))
        blocks += chunk
    blocks.append(0)
    return bytes(blocks)


def encode_gif(frames: Sequence[dict], size, global_palette=None,
               background: int = 0, loop: bool = True) -> bytes:
    """frames: dicts with "indices" ([h, w] uint8) and optional "x", "y"
    (offsets), "palette" (a local [n, 3] palette), "transparency" (an
    index), "disposal" (0-3), "interlace" and "delay" (1/100 s). size:
    (width, height) of the logical screen."""
    W, H = size
    flags = 0
    head = b"GIF89a" + struct.pack("<HH", W, H)
    gpal = b""
    if global_palette is not None:
        gpal = _palette_bytes(global_palette)
        flags = 0x80 | 0x70 | _bits_for(len(gpal) // 3)
    out = bytearray(head + bytes([flags, background, 0]) + gpal)
    if loop:
        out += b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"
    for fr in frames:
        idx = np.asarray(fr["indices"], np.uint8)
        h, w = idx.shape
        trans = fr.get("transparency")
        gce = ((fr.get("disposal", 0) & 7) << 2) | (1 if trans is not None
                                                   else 0)
        out += b"\x21\xf9\x04" + struct.pack(
            "<BHB", gce, fr.get("delay", 4), trans or 0) + b"\x00"
        iflags = 0
        lpal = b""
        if fr.get("palette") is not None:
            lpal = _palette_bytes(fr["palette"])
            iflags = 0x80 | _bits_for(len(lpal) // 3)
        if fr.get("interlace"):
            iflags |= 0x40
            idx = idx[[r for s, st in _INTERLACE for r in range(s, h, st)]]
        out += b"\x2c" + struct.pack("<HHHHB", fr.get("x", 0), fr.get("y", 0),
                                     w, h, iflags) + lpal
        n_colors = max(len(lpal) // 3, len(gpal) // 3, int(idx.max()) + 1)
        out += lzw_encode(idx, max(2, _bits_for(n_colors) + 1))
    out += b"\x3b"
    return bytes(out)


def cube_palette() -> np.ndarray:
    """The 216 colors of a 6x6x6 cube (levels 0, 51, ..., 255)."""
    lv = np.arange(6) * 51
    r, g, b = np.meshgrid(lv, lv, lv, indexing="ij")
    return np.stack([r, g, b], -1).reshape(-1, 3).astype(np.uint8)


def encode_rgb_gif(frames: Sequence[np.ndarray],
                   disposal: Optional[List[int]] = None) -> bytes:
    """[T, H, W, 3] uint8 RGB frames -> a GIF on the cube palette (each
    channel rounded to the nearest of 6 levels)."""
    arr = np.asarray(frames, np.uint8)
    q = (arr.astype(np.int32) * 5 + 127) // 255
    idx = (q[..., 0] * 36 + q[..., 1] * 6 + q[..., 2]).astype(np.uint8)
    return encode_gif(
        [{"indices": f, "disposal": (disposal or [1] * len(idx))[i]}
         for i, f in enumerate(idx)],
        (arr.shape[2], arr.shape[1]), global_palette=cube_palette())
