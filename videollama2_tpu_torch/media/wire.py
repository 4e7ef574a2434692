"""The I420 frame wire format of the PyTorch port.

Frames may cross the host->device boundary as planar YUV 4:2:0 (1.5 bytes a
pixel instead of 3) and are converted back to RGB on the device
(models/videollama2._i420_to_rgb). This is the port's own copy of the JAX
package's `media/wire.py`: the BT.601 full-range coefficients and the numpy
pack and unpack, held equal to the original by tests/test_torch_config.py.

Layout (one [..., H*3/2, W] uint8 buffer, H % 4 == 0 and W even):
  rows [0, H)            Y plane, full resolution
  rows [H, H + H/4)      U plane, (H/2 x W/2) raveled into W-wide rows
  rows [H + H/4, H*3/2)  V plane, same packing
"""

from __future__ import annotations

import numpy as np

# BT.601 full-range (JPEG) RGB<->YCbCr
_FWD = np.array([[0.299, 0.587, 0.114],
                 [-0.168736, -0.331264, 0.5],
                 [0.5, -0.418688, -0.081312]], dtype=np.float32)
INV_R_CR = 1.402
INV_G_CB = 0.344136
INV_G_CR = 0.714136
INV_B_CB = 1.772


def rgb_to_i420(frames: np.ndarray) -> np.ndarray:
    """Pack uint8 RGB [..., H, W, 3] into I420 uint8 [..., H*3/2, W], the
    chroma 2x2 box-averaged."""
    if frames.dtype != np.uint8 or frames.shape[-1] != 3:
        raise ValueError(f"expected uint8 [..., H, W, 3], got "
                         f"{frames.dtype} {frames.shape}")
    H, W = frames.shape[-3], frames.shape[-2]
    if H % 4 or W % 2:
        raise ValueError(f"I420 packing needs H % 4 == 0 and even W; "
                         f"got {H}x{W}")
    lead = frames.shape[:-3]
    rgb = frames.reshape((-1, H, W, 3)).astype(np.float32)
    ycc = rgb @ _FWD.T
    y = np.clip(np.rint(ycc[..., 0]), 0, 255)
    cb = ycc[..., 1].reshape(-1, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    cr = ycc[..., 2].reshape(-1, H // 2, 2, W // 2, 2).mean(axis=(2, 4))
    cb = np.clip(np.rint(cb + 128.0), 0, 255)
    cr = np.clip(np.rint(cr + 128.0), 0, 255)
    n = y.shape[0]
    out = np.empty((n, H * 3 // 2, W), dtype=np.uint8)
    out[:, :H] = y
    out[:, H:H + H // 4] = cb.reshape(n, H // 4, W)
    out[:, H + H // 4:] = cr.reshape(n, H // 4, W)
    return out.reshape(lead + (H * 3 // 2, W))


def i420_to_rgb(buf: np.ndarray) -> np.ndarray:
    """Unpack I420 uint8 [..., H*3/2, W] to float32 RGB [..., H, W, 3] in
    [0, 255], chroma upsampled nearest; the device unpack equals it."""
    H = buf.shape[-2] * 2 // 3
    W = buf.shape[-1]
    lead = buf.shape[:-2]
    b = buf.reshape((-1,) + buf.shape[-2:]).astype(np.float32)
    y = b[:, :H]
    cb = b[:, H:H + H // 4].reshape(-1, H // 2, W // 2) - 128.0
    cr = b[:, H + H // 4:].reshape(-1, H // 2, W // 2) - 128.0
    cb = cb.repeat(2, axis=1).repeat(2, axis=2)
    cr = cr.repeat(2, axis=1).repeat(2, axis=2)
    r = y + INV_R_CR * cr
    g = y - INV_G_CB * cb - INV_G_CR * cr
    bl = y + INV_B_CB * cb
    rgb = np.clip(np.stack([r, g, bl], axis=-1), 0.0, 255.0)
    return rgb.reshape(lead + (H, W, 3))
