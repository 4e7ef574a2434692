"""Video frame extraction (port of videollama2_tpu/media/video_reader.py):
a ctypes binding over the C++ libavcodec decoder.

Replaces decord (reference mm_utils.py:154-177). The library is the port's
own build of media/csrc/video_decoder.cc (a byte-identical copy of the JAX
package's), made with g++ at first use by media/_native.py. Where it cannot
be built (a host without libavcodec's headers), every container path raises
a RuntimeError that names libavcodec and the compiler's first error line.
Frame directories are decoded by the port's still-image reader
(media/image_io.py). GIF, which the JAX package reads through imageio
over PIL, is read here (read_gif: LZW in csrc/gif_lzw.cc, PIL's rules of
disposal and compositing in numpy) to the same frames, at JAX's 25 fps.
"""

from __future__ import annotations

import ctypes
import os
import struct
import threading
from typing import List, Optional, Sequence

import numpy as np

from . import _native
from . import image_io
from . import sampler as sampler_lib

_LIBS = ("avformat", "avcodec", "avutil", "swscale", "swresample")
_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    """The decoder library with its signatures; raises RuntimeError when it
    cannot be built or loaded."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = _native.load("video_decoder.cc", _LIBS, needs="libavcodec")
        lib.vd_open.restype = ctypes.c_void_p
        lib.vd_open.argtypes = [ctypes.c_char_p]
        lib.vd_close.argtypes = [ctypes.c_void_p]
        lib.vd_num_frames.restype = ctypes.c_long
        lib.vd_num_frames.argtypes = [ctypes.c_void_p]
        lib.vd_fps.restype = ctypes.c_double
        lib.vd_fps.argtypes = [ctypes.c_void_p]
        lib.vd_width.restype = ctypes.c_int
        lib.vd_width.argtypes = [ctypes.c_void_p]
        lib.vd_height.restype = ctypes.c_int
        lib.vd_height.argtypes = [ctypes.c_void_p]
        lib.vd_get_batch.restype = ctypes.c_int
        lib.vd_get_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.POINTER(ctypes.c_ubyte)]
        lib.vd_get_batch_i420.restype = ctypes.c_int
        lib.vd_get_batch_i420.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long), ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte)]
        lib.ad_decode.restype = ctypes.c_long
        lib.ad_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_float))]
        lib.ad_free.argtypes = [ctypes.POINTER(ctypes.c_float)]
        lib.ad_has_audio.restype = ctypes.c_int
        lib.ad_has_audio.argtypes = [ctypes.c_char_p]
        _lib = lib
        return _lib


def decoder_available() -> bool:
    """Whether this host can build and load the container decoder."""
    try:
        _load_lib()
    except RuntimeError:
        return False
    return True


class VideoReader:
    """decord.VideoReader-equivalent over the C++ decoder."""

    def __init__(self, path: str):
        lib = _load_lib()
        self._lib = lib
        self._ctx = lib.vd_open(path.encode())
        if not self._ctx:
            raise IOError(f"cannot open video: {path}")
        self.num_frames = int(lib.vd_num_frames(self._ctx))
        self.fps = float(lib.vd_fps(self._ctx))
        self.width = int(lib.vd_width(self._ctx))
        self.height = int(lib.vd_height(self._ctx))

    def __len__(self) -> int:
        return self.num_frames

    def get_avg_fps(self) -> float:
        return self.fps

    def _decode_batch(self, indices: Sequence[int], frame_shape, call):
        """Sorted-index decode via `call(idx_ptr, n, out_ptr)`, the
        original order restored; a truncated stream repeats its last
        decoded frame (JAX `_decode_batch`)."""
        idx = np.asarray(sorted(int(i) for i in indices), dtype=np.int64)
        order = np.argsort(np.argsort([int(i) for i in indices]))
        out = np.empty((len(idx),) + frame_shape, dtype=np.uint8)
        n = call(idx.ctypes.data_as(ctypes.POINTER(ctypes.c_long)), len(idx),
                 out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if n < len(idx):
            if n == 0:
                raise IOError("failed to decode any frames")
            out[n:] = out[n - 1]
        return out[order] if not np.all(order == np.arange(len(idx))) else out

    def get_batch(self, indices: Sequence[int]) -> np.ndarray:
        """Decode frames at `indices` -> [N, H, W, 3] uint8 (RGB)."""
        return self._decode_batch(
            indices, (self.height, self.width, 3),
            lambda ip, n, op: self._lib.vd_get_batch(self._ctx, ip, n, op))

    def get_batch_i420(self, indices: Sequence[int], size: int,
                       clip_crop: bool = True) -> np.ndarray:
        """Decode frames at `indices`, scale (and center-crop for CLIP when
        clip_crop) straight to packed full-range I420 at size x size in
        C++ (media/wire.py's layout). Returns [N, size*3/2, size] uint8."""
        if size % 4:
            raise ValueError(f"I420 size must be a multiple of 4: {size}")
        return self._decode_batch(
            indices, (size * 3 // 2, size),
            lambda ip, n, op: self._lib.vd_get_batch_i420(
                self._ctx, ip, n, size, int(clip_crop), op))

    def close(self):
        if getattr(self, "_ctx", None):
            self._lib.vd_close(self._ctx)
            self._ctx = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    """A container's audio track -> [n] float32 mono at sample_rate
    (libavcodec decode + libswresample in media/csrc ad_decode). Raises
    IOError when the decoder ran and found no decodable audio stream, and
    RuntimeError when the decoder is unavailable."""
    lib = _load_lib()
    buf = ctypes.POINTER(ctypes.c_float)()
    n = lib.ad_decode(path.encode(), int(sample_rate), ctypes.byref(buf))
    if n < 0 or not buf:
        raise IOError(f"no decodable audio track in {path}")
    try:
        return np.ctypeslib.as_array(buf, shape=(n,)).copy()
    finally:
        lib.ad_free(buf)


def has_audio(path: str) -> bool:
    """True when the container carries a decodable audio stream; raises
    RuntimeError when the decoder is unavailable."""
    if not os.path.isfile(path):
        return False
    return bool(_load_lib().ad_has_audio(path.encode()))


_gif_fn = None


def _gif_lzw():
    global _gif_fn
    with _lib_lock:
        if _gif_fn is None:
            fn = _native.load("gif_lzw.cc").gif_lzw
            fn.restype = ctypes.c_long
            fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                           ctypes.c_void_p, ctypes.c_long]
            _gif_fn = fn
    return _gif_fn


def _sub_blocks(data: bytes, pos: int):
    """The joined data sub-blocks from `pos` and the position after
    their terminator."""
    parts = []
    while pos < len(data):
        n = data[pos]
        pos += 1
        if n == 0:
            break
        parts.append(data[pos:pos + n])
        pos += n
    return b"".join(parts), pos


def _palette_lut(palette: bytes) -> np.ndarray:
    """Index -> RGB; indices past the palette read black, as PIL's."""
    lut = np.zeros((256, 3), np.uint8)
    p = np.frombuffer(palette, np.uint8).reshape(-1, 3)[:256]
    lut[:len(p)] = p
    return lut


def _palette_needed(p: bytes) -> bool:
    """False for a palette that maps every index i to (i, i, i): PIL then
    reads the frame as gray."""
    return any(not (i // 3 == p[i] == p[i + 1] == p[i + 2])
               for i in range(0, len(p), 3))


_INTERLACE = ((0, 8), (4, 8), (2, 4), (1, 2))
# PIL's decompression-bomb limit (2 x Image.MAX_IMAGE_PIXELS): a larger
# screen or image raises ValueError before anything is allocated
GIF_MAX_PIXELS = 178956970


def _gif_frames(data: bytes):
    """Yield (extent, indices [h, w], local palette (None: absent, False:
    a gray ramp), transparency index or None, disposal bits) per image;
    an image whose code stream ends before its last pixel raises."""
    pos = 13
    flags = data[10]
    if flags & 128:
        pos += 3 << ((flags & 7) + 1)
    transparency, disposal = None, 0
    while pos < len(data):
        kind = data[pos]
        pos += 1
        if kind == 0x3B:  # trailer
            return
        if kind == 0x21:  # extension
            label = data[pos]
            first_len = data[pos + 1]
            if label == 0xF9 and first_len >= 4:
                block = data[pos + 2:pos + 2 + first_len]
                transparency = block[3] if block[0] & 1 else None
                disposal = (block[0] >> 2) & 7
            _, pos = _sub_blocks(data, pos + 1)
            continue
        if kind != 0x2C:
            raise ValueError(f"GIF: unknown block 0x{kind:02x}")
        x0, y0, w, h, iflags = struct.unpack("<HHHHB", data[pos:pos + 9])
        pos += 9
        palette = None
        if iflags & 128:
            n = 3 << ((iflags & 7) + 1)
            raw = data[pos:pos + n]
            pos += n
            palette = raw if _palette_needed(raw) else False
        if w * h > GIF_MAX_PIXELS:
            raise ValueError(f"GIF image of {w}x{h}: more than "
                             f"{GIF_MAX_PIXELS} pixels")
        code_size = data[pos]
        lzw, pos = _sub_blocks(data, pos + 1)
        idx = np.empty(w * h, np.uint8)
        got = _gif_lzw()(lzw, len(lzw), code_size,
                         idx.ctypes.data_as(ctypes.c_void_p), w * h)
        if got < 0:
            raise ValueError("GIF: corrupt LZW data")
        if got < w * h:
            raise ValueError(f"GIF: image data ends after {got} of "
                             f"{w * h} pixels")
        idx = idx.reshape(h, w)
        if iflags & 64:
            order = [r for start, step in _INTERLACE
                     for r in range(start, h, step)]
            out = np.empty_like(idx)
            out[order] = idx
            idx = out
        yield (x0, y0, x0 + w, y0 + h), idx, palette, transparency, disposal
        transparency, disposal = None, 0


def _gif_screen(data: bytes, what: str):
    """-> (width, height, global palette or None, background index) of the
    logical screen; a screen past PIL's decompression-bomb limit raises
    ValueError."""
    W, H, flags = struct.unpack("<HHB", data[6:11])
    if W * H > GIF_MAX_PIXELS:
        raise ValueError(f"GIF screen of {W}x{H}: more than "
                         f"{GIF_MAX_PIXELS} pixels ({what})")
    global_palette, background = None, 0
    if flags & 128:
        background = data[11]
        raw = data[13:13 + (3 << ((flags & 7) + 1))]
        if _palette_needed(raw):
            global_palette = raw
    return W, H, global_palette, background


def _check_extent(ext, W: int, H: int, what: str) -> None:
    if ext[2] > W or ext[3] > H:
        raise NotImplementedError(
            f"GIF frames past the logical screen ({what}) are not decoded "
            "by the port yet")


def read_gif_still(data: bytes) -> np.ndarray:
    """A GIF given as an image -> [H, W, 3] uint8 RGB: its first frame, as
    `PIL.Image.open(f).convert("RGB")` gives it (the screen filled with the
    transparent index, else 0, the image pasted in, its palette's colors
    or gray without one); later frames are not decoded. A first image past
    the logical screen raises NotImplementedError; a truncated or corrupt
    stream ValueError."""
    try:
        W, H, global_palette, _ = _gif_screen(data, "GIF image")
        for ext, idx, palette, trans, _ in _gif_frames(data):
            _check_extent(ext, W, H, "GIF image")
            x0, y0, x1, y1 = ext
            canvas = np.full((H, W), trans if trans is not None else 0,
                             np.uint8)
            canvas[y0:y1, x0:x1] = idx
            palette = global_palette if palette is None else palette
            if palette:
                return _palette_lut(palette)[canvas]
            return np.repeat(canvas[..., None], 3, axis=-1)
    except (IndexError, struct.error) as e:
        raise ValueError(f"truncated GIF: {e}") from None
    raise ValueError("GIF without an image")


def read_gif(path: str) -> List[np.ndarray]:
    """Every frame of a GIF as [H, W, 3] uint8 RGB: the frames JAX's
    `_read_gif` gives (imageio over PIL's GifImagePlugin, gray repeated to
    three channels, alpha dropped). PIL's rules, kept here: the first frame
    is the palette's colors (or gray without a palette); later frames are
    composited onto the canvas, their transparent pixels leaving it as it
    was; a disposal method sticks until a later frame names another (0
    keeps it); method 2 fills the frame's extent with the transparent
    index's color (else the background index's) before the next frame, in
    the colors of the frame it disposes; method 3 puts back the extent as
    it was before that frame. Frames reaching past the logical screen and
    gray GIFs that later gain a palette raise NotImplementedError."""
    if not os.path.isfile(path):
        raise IOError(f"cannot open GIF video: {path}")
    with open(path, "rb") as f:
        data = f.read()
    if data[:6] not in (b"GIF87a", b"GIF89a"):
        raise ValueError(f"not a GIF: {path}")
    W, H, global_palette, background = _gif_screen(data, path)
    frames: List[np.ndarray] = []
    canvas = mode = lut = None
    info_transparency = None   # PIL's info["transparency"] (first frame's)
    disposal_method = 0
    dispose = None             # (array, extent) to paste before the next
    for k, (ext, idx, palette, trans, bits) in enumerate(_gif_frames(data)):
        x0, y0, x1, y1 = ext
        _check_extent(ext, W, H, path)
        if bits:
            disposal_method = bits
        if dispose is not None:
            arr, (dx0, dy0, dx1, dy1) = dispose
            canvas[dy0:dy1, dx0:dx1] = arr
        frame_palette = palette if palette is not None else global_palette
        if k == 0:
            mode = "P" if frame_palette else "L"
            canvas = np.full((H, W), trans if trans is not None else 0,
                             np.uint8)
            if frame_palette:
                lut = _palette_lut(frame_palette)
        elif mode == "P":
            canvas, mode = lut[canvas], "RGB"
            info_transparency = None
        elif mode == "L" and frame_palette:
            raise NotImplementedError(
                f"a gray GIF whose later frames carry a palette ({path}) "
                "is not decoded by the port yet")

        def rgb(color):
            if frame_palette:
                if color * 3 + 3 > len(frame_palette):
                    color = 0
                return np.frombuffer(frame_palette[color * 3:color * 3 + 3],
                                     np.uint8)
            return np.array([color] * 3, np.uint8)

        dispose = None
        shape = (y1 - y0, x1 - x0) + ((3,) if mode == "RGB" else ())
        if disposal_method == 2:
            color = info_transparency if info_transparency is not None \
                else trans
            if color is None:
                color = background
            fill = rgb(color) if mode == "RGB" else color
            dispose = np.broadcast_to(np.asarray(fill, np.uint8),
                                      shape).copy(), ext
        elif disposal_method == 3:
            if k:
                dispose = canvas[y0:y1, x0:x1].copy(), ext
            elif trans is not None:
                dispose = np.full(shape, trans, np.uint8), ext

        region = canvas[y0:y1, x0:x1]
        if k == 0:
            region[...] = idx
            if trans is not None:
                info_transparency = trans
        elif mode == "L":
            keep = idx != trans
            region[keep] = idx[keep]
        else:
            colors = (_palette_lut(frame_palette)[idx] if frame_palette
                      else np.repeat(idx[..., None], 3, axis=-1))
            keep = idx != trans
            region[keep] = colors[keep]
        if mode == "P":
            frames.append(lut[canvas])
        elif mode == "L":
            frames.append(np.repeat(canvas[..., None], 3, axis=-1))
        else:
            frames.append(canvas.copy())
    return frames


def probe_video(video_path: str):
    """-> (num_frames, fps) for a file or frame directory, with the fps
    conventions of read_video_frames."""
    if os.path.isdir(video_path):
        return len(sorted(os.listdir(video_path))), 3.0
    if video_path.endswith(".gif"):
        return len(read_gif(video_path)), 25.0
    vr = VideoReader(video_path)
    try:
        return len(vr), vr.get_avg_fps()
    finally:
        vr.close()


def read_video_frames(video_path: str, num_frames: Optional[int],
                      s: Optional[float] = None,
                      e: Optional[float] = None) -> List[np.ndarray]:
    """Open a video (container file or frame directory), sample indices
    with reference parity and decode only those frames. Mirrors
    mm_utils.py:142-177."""
    if os.path.isdir(video_path):
        frame_files = sorted(os.listdir(video_path))
        fps, total = 3, len(frame_files)
        idx = sampler_lib.sample_indices(total, fps, num_frames, s, e)
        return [image_io.read_image(os.path.join(video_path, frame_files[i]))
                for i in idx]
    if video_path.endswith(".gif"):
        all_frames = read_gif(video_path)
        idx = sampler_lib.sample_indices(len(all_frames), 25, num_frames,
                                         s, e)
        return [all_frames[i] for i in idx]
    vr = VideoReader(video_path)
    try:
        idx = sampler_lib.sample_indices(len(vr), vr.get_avg_fps(),
                                         num_frames, s, e)
        batch = vr.get_batch(idx)
    finally:
        vr.close()
    return list(batch)
