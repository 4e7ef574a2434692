"""Frame-index sampling with exact reference parity.

Parity: videollama2/mm_utils.py:106-129 — uniform mode picks the midpoint of
each of `num_frames` equal segments over [0, duration-1] and rounds with a
+1e-6 nudge; fps mode samples one frame per second starting at the segment
midpoint.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..constants import NUM_FRAMES_PER_SECOND


def frame_sample(duration: int, mode: str = "uniform",
                 num_frames: Optional[int] = None,
                 fps: Optional[float] = None) -> np.ndarray:
    if mode == "uniform":
        assert num_frames is not None, \
            "Number of frames must be provided for uniform sampling."
        seg_size = float(duration - 1) / num_frames
        mids = [(seg_size * i + seg_size * (i + 1)) / 2
                for i in range(num_frames)]
        return np.round(np.array(mids) + 1e-6).astype(int)
    if mode == "fps":
        assert fps is not None, "FPS must be provided for FPS sampling."
        segment_len = min(fps // NUM_FRAMES_PER_SECOND, duration)
        return np.arange(segment_len // 2, duration, segment_len, dtype=int)
    raise ImportError(f"Unsupported frame sampling mode: {mode}")


def clip_frame_range(num_frames_of_video: int, fps: float,
                     s: Optional[float], e: Optional[float]):
    """Start/end-bounded frame range (mm_utils.py:134-162)."""
    if s is not None and e is not None:
        s = max(s, 0.0)
        e = max(e, 0.0)
        if s > e:
            s, e = e, s
        elif s == e:
            e = s + 1
    f_start = 0 if s is None else max(int(s * fps) - 1, 0)
    f_end = (num_frames_of_video - 1 if e is None
             else min(int(e * fps) - 1, num_frames_of_video - 1))
    return f_start, f_end


def sample_indices(num_frames_of_video: int, fps: float,
                   num_frames: Optional[int],
                   s: Optional[float] = None,
                   e: Optional[float] = None) -> np.ndarray:
    """Full sampling pipeline: range clip + frame_sample (mm_utils.py:159-169)."""
    f_start, f_end = clip_frame_range(num_frames_of_video, fps, s, e)
    frame_indices = np.arange(f_start, f_end + 1)
    duration = len(frame_indices)
    if num_frames is None:
        local = frame_sample(duration, mode="fps", fps=fps)
    else:
        local = frame_sample(duration, mode="uniform", num_frames=num_frames)
    return frame_indices[local]
