"""Video frame extraction (port of videollama2_tpu/media/video_reader.py):
a ctypes binding over the C++ libavcodec decoder.

Replaces decord (reference mm_utils.py:154-177). The library is the port's
own build of media/csrc/video_decoder.cc (a byte-identical copy of the JAX
package's), made with g++ at first use by media/_native.py. Where it cannot
be built (a host without libavcodec's headers), every container path raises
a RuntimeError that names libavcodec and the compiler's first error line.
Frame directories are decoded by the port's still-image reader
(media/image_io.py); GIF, which the JAX package reads through imageio,
raises NotImplementedError.
"""

from __future__ import annotations

import ctypes
import os
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


def _gif_not_ported(path: str):
    raise NotImplementedError(f"GIF video ({path}) is not decoded by the "
                              "port yet: pass a container the decoder reads, "
                              "a frame directory or decoded frames")


def probe_video(video_path: str):
    """-> (num_frames, fps) for a file or frame directory, with the fps
    conventions of read_video_frames."""
    if os.path.isdir(video_path):
        return len(sorted(os.listdir(video_path))), 3.0
    if video_path.endswith(".gif"):
        _gif_not_ported(video_path)
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
        _gif_not_ported(video_path)
    vr = VideoReader(video_path)
    try:
        idx = sampler_lib.sample_indices(len(vr), vr.get_avg_fps(),
                                         num_frames, s, e)
        batch = vr.get_batch(idx)
    finally:
        vr.close()
    return list(batch)
