"""Convolutions on channels-last layouts (port of videollama2_tpu/ops/conv.py).

The public functions keep the JAX package's layouts (NHWC/HWIO and
NDHWC/DHWIO) so both packages take the same arrays. Inside, the tensors are
viewed as torch's NCHW/OIHW without a copy of the activations (a permuted
channels-last tensor is torch's channels_last memory format) and handed to
torch's convolution; the JAX package wrote no Pallas kernel here either.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
import torch.nn.functional as F


def _tup(x, n):
    return tuple(x) if isinstance(x, (tuple, list)) else (x,) * n


def conv2d(x: torch.Tensor, kernel: torch.Tensor, bias=None,
           stride: Union[int, Tuple[int, int]] = 1,
           padding: Union[int, Tuple[int, int]] = 0,
           groups: int = 1) -> torch.Tensor:
    """x: [N, H, W, C_in]; kernel: [kh, kw, C_in/groups, C_out]."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1)
    b = bias.to(x.dtype) if bias is not None else None
    out = F.conv2d(x.permute(0, 3, 1, 2), w, b, stride=_tup(stride, 2),
                   padding=_tup(padding, 2), groups=groups)
    return out.permute(0, 2, 3, 1)


def conv3d(x: torch.Tensor, kernel: torch.Tensor, bias=None,
           stride: Union[int, Sequence[int]] = 1,
           padding: Union[int, Sequence[int]] = 0) -> torch.Tensor:
    """x: [N, T, H, W, C_in]; kernel: [kt, kh, kw, C_in, C_out]."""
    w = kernel.to(x.dtype).permute(4, 3, 0, 1, 2)
    b = bias.to(x.dtype) if bias is not None else None
    out = F.conv3d(x.permute(0, 4, 1, 2, 3), w, b, stride=_tup(stride, 3),
                   padding=_tup(padding, 3))
    return out.permute(0, 2, 3, 4, 1)


def avg_pool3d(x: torch.Tensor, window: Sequence[int]) -> torch.Tensor:
    """nn.AvgPool3d(window) with stride=window, no padding.
    x: [N, T, H, W, C]. The CPU has no half-precision avg_pool3d: there
    bf16 / fp16 input is averaged in fp32 and rounded back, as CUDA's
    kernel accumulates in fp32."""
    y = x.permute(0, 4, 1, 2, 3)
    if y.device.type == "cpu" and y.dtype in (torch.bfloat16, torch.float16):
        return F.avg_pool3d(y.float(), tuple(window)).to(
            x.dtype).permute(0, 2, 3, 4, 1)
    return F.avg_pool3d(y, tuple(window)).permute(0, 2, 3, 4, 1)
