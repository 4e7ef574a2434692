"""Image and video preprocessing: pad, resize, normalize (port of
videollama2_tpu/media/preprocess.py, without PIL).

Parity: videollama2/mm_utils.py:27-38 (expand2square), :91-103
(process_image), :132-202 (process_video) and the HF CLIP / SigLIP image
processors they delegate to:

  * CLIP: resize the shortest edge to `image_size` (bicubic) and center
    crop, rescale 1/255, normalize with CLIP's mean and std.
  * SigLIP: resize to (image_size, image_size) (bicubic), rescale,
    normalize with (0.5, 0.5, 0.5).

Frames are uint8 RGB numpy arrays [H, W, 3]. The padding and the crop are
exact numpy with the JAX package's integer arithmetic; the bicubic resize
(`resize_bicubic`) is PIL's `Image.BICUBIC` resample redone bit for bit
in C++ on the host CPU (csrc/resample.cc, built at first use by
media/_native.py): its a = -0.5 cubic over the antialiased support, its
taps rounded to 22-bit fixed point, a horizontal pass clipped to uint8,
then a vertical one. `out_dtype="uint8"` ships the resized RGB and normalizes on the device
(models/videollama2.encode_frames); "float32" normalizes that same uint8
here. Outputs are channels-last [T, H, W, 3].
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Sequence, Tuple

import numpy as np

from ..constants import MAX_FRAMES, NUM_FRAMES
from ..core.config import VisionConfig
from . import _native, image_io, sampler as sampler_lib, video_reader, wire


def expand2square(img: np.ndarray,
                  background_color: Tuple[int, int, int]) -> np.ndarray:
    """Pad to square with the dataset mean color (mm_utils.py:27-38)."""
    height, width = img.shape[:2]
    if width == height:
        return img
    side = max(width, height)
    out = np.empty((side, side, 3), np.uint8)
    out[:] = np.asarray(background_color, np.uint8)
    if width > height:
        top = (width - height) // 2
        out[top:top + height] = img
    else:
        left = (height - width) // 2
        out[:, left:left + width] = img
    return out


_resample = None
_resample_lock = threading.Lock()


def _resample_fn():
    global _resample
    with _resample_lock:
        if _resample is None:
            fn = _native.load("resample.cc").resample_bicubic
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_long, ctypes.c_int,
                           ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                           ctypes.c_int, ctypes.c_int]
            _resample = fn
    return _resample


def resize_bicubic(frames: np.ndarray, height: int, width: int) -> np.ndarray:
    """[N, H, W, 3] uint8 -> [N, height, width, 3] uint8, equal to PIL's
    `Image.resize((width, height), Image.BICUBIC)` of each frame
    (csrc/resample.cc, frames split among the host's cores)."""
    src = np.ascontiguousarray(frames, dtype=np.uint8)
    n, h, w = src.shape[:3]
    out = np.empty((n, height, width, 3), np.uint8)
    if _resample_fn()(src.ctypes.data, n, h, w, out.ctypes.data, height,
                      width, os.cpu_count() or 1):
        raise ValueError(f"cannot resize {src.shape} to {height}x{width}")
    return out


def _resize_clip(frames: np.ndarray, size: int) -> np.ndarray:
    """HF CLIPImageProcessor: shortest-edge resize + center crop."""
    h, w = frames.shape[1:3]
    short, long = (w, h) if w <= h else (h, w)
    new_long = int(size * long / short)
    nw, nh = (size, new_long) if w <= h else (new_long, size)
    frames = resize_bicubic(frames, nh, nw)
    left = (nw - size) // 2
    top = (nh - size) // 2
    return frames[:, top:top + size, left:left + size]


def _resize_siglip(frames: np.ndarray, size: int) -> np.ndarray:
    return resize_bicubic(frames, size, size)


def preprocess_frames(frames: Sequence[np.ndarray], cfg: VisionConfig,
                      aspect_ratio: Optional[str] = None,
                      out_dtype: str = "float32") -> np.ndarray:
    """RGB frames -> [T, H, W, 3]: normalized float32, or ("uint8") the
    resized RGB that the device normalizes. Frames of one shape are
    resized together."""
    mean = np.asarray(cfg.image_mean, dtype=np.float32)
    std = np.asarray(cfg.image_std, dtype=np.float32)
    frames = [image_io.as_rgb(f) for f in frames]
    if aspect_ratio == "pad":
        fill = tuple(int(x * 255) for x in cfg.image_mean)
        frames = [expand2square(f, fill) for f in frames]
    resize = _resize_clip if cfg.variant == "clip" else _resize_siglip
    out, start = [], 0
    for i in range(1, len(frames) + 1):
        if i == len(frames) or frames[i].shape != frames[start].shape:
            out.append(resize(np.stack(frames[start:i]), cfg.image_size))
            start = i
    arr = np.concatenate(out, axis=0)
    if out_dtype == "uint8":
        return np.ascontiguousarray(arr)
    return (arr.astype(np.float32) / 255.0 - mean) / std


def create_photo_grid(arr, rows: Optional[int] = None,
                      cols: Optional[int] = None) -> np.ndarray:
    """Arrange t frames into a (rows x cols) photo grid (mm_utils.py:41-88:
    rows = ceil(sqrt(t)), cols = ceil(t / rows), row-major fill, black
    padding cells, list-of-frames input accepted)."""
    if isinstance(arr, list):
        arr = np.stack([np.asarray(a) for a in arr])
    t, h, w, c = arr.shape
    if rows is None and cols is None:
        rows = int(np.ceil(np.sqrt(t)))
        cols = int(np.ceil(t / rows))
    elif rows is None:
        rows = int(np.ceil(t / cols))
    elif cols is None:
        cols = int(np.ceil(t / rows))
    if rows * cols < t:
        raise ValueError(f"Not enough grid cells ({rows}x{cols}) to hold "
                         f"all images ({t}).")
    num_pad = rows * cols - t
    if num_pad > 0:
        pad = np.zeros((num_pad, h, w, c), dtype=arr.dtype)
        arr = np.concatenate([arr, pad], axis=0)
    return (arr.reshape(rows, cols, h, w, c)
            .transpose(0, 2, 1, 3, 4)
            .reshape(rows * h, cols * w, c))


def process_image(image_path, cfg: VisionConfig,
                  aspect_ratio: Optional[str] = "pad",
                  out_dtype: str = "float32") -> np.ndarray:
    """Parity: mm_utils.py:91-103. An image path, an encoded image's bytes
    or an array -> [1, H, W, 3]."""
    if isinstance(image_path, np.ndarray):
        image = image_path
    else:
        image = image_io.read_image(image_path)
    return preprocess_frames([image], cfg, aspect_ratio, out_dtype)


def process_video(video_path, cfg: VisionConfig, s: Optional[float] = None,
                  e: Optional[float] = None,
                  aspect_ratio: Optional[str] = "pad",
                  num_frames: Optional[int] = NUM_FRAMES,
                  out_dtype: str = "float32") -> np.ndarray:
    """Parity: mm_utils.py:132-202. A container path or frame directory, an
    ndarray stack, a list of frames or a list of image paths ->
    [T, H, W, 3]."""
    if isinstance(video_path, str):
        video_data = video_reader.read_video_frames(
            video_path, num_frames=num_frames, s=s, e=e)
    elif isinstance(video_path, np.ndarray) or (
            isinstance(video_path, list) and isinstance(video_path[0],
                                                        np.ndarray)):
        video_data = [image_io.as_rgb(f) for f in video_path]
    elif isinstance(video_path, list) and isinstance(video_path[0], str):
        video_data = [image_io.read_image(f) for f in video_path]
    else:
        raise ValueError(f"Unsupported video path type: {type(video_path)}")

    # zero-frame padding for short videos (mm_utils.py:190-192); the
    # reference sizes the pad by PIL's (width, height) as an array shape,
    # so a non-square clip's pad frame is its transpose
    while num_frames is not None and len(video_data) < num_frames:
        h, w = video_data[-1].shape[:2]
        video_data.append(np.zeros((w, h, 3), dtype=np.uint8))
    video_data = video_data[:MAX_FRAMES]  # (mm_utils.py:193-194)

    return preprocess_frames(video_data, cfg, aspect_ratio, out_dtype)


def process_video_i420(video_path, cfg: VisionConfig,
                       s: Optional[float] = None, e: Optional[float] = None,
                       num_frames: Optional[int] = NUM_FRAMES) -> np.ndarray:
    """process_video for the I420 wire: packed planar YUV 4:2:0
    [T, image_size*3/2, image_size] uint8 (media/wire.py's layout).

    A container path is decoded, scaled (and for CLIP center-cropped, the
    crop offset rounded down to even) straight into full-range I420 in C++
    (vd_get_batch_i420: swscale bicubic in YUV, no host RGB), with black
    I420 frames (Y 0, U and V 128) padding a short clip; frame directories
    and decoded frames go through process_video and wire.rgb_to_i420.
    """
    if (isinstance(video_path, str) and not os.path.isdir(video_path)
            and not video_path.endswith(".gif")):
        vr = video_reader.VideoReader(video_path)
        try:
            idx = sampler_lib.sample_indices(len(vr), vr.get_avg_fps(),
                                             num_frames, s, e)
            buf = vr.get_batch_i420(idx, cfg.image_size,
                                    clip_crop=(cfg.variant == "clip"))
        finally:
            vr.close()
        S = cfg.image_size
        if num_frames is not None and buf.shape[0] < num_frames:
            pad = np.zeros((num_frames - buf.shape[0], S * 3 // 2, S),
                           dtype=np.uint8)
            pad[:, S:] = 128
            buf = np.concatenate([buf, pad], axis=0)
        return buf[:MAX_FRAMES]

    rgb = process_video(video_path, cfg, s=s, e=e, aspect_ratio=None,
                        num_frames=num_frames, out_dtype="uint8")
    return wire.rgb_to_i420(rgb)
