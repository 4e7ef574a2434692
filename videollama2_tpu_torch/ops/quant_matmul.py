"""matmul_q8: a non-layered int8 weight-only matmul (port of
videollama2_tpu/ops/quant_matmul.py::matmul_q8).

y[R, F] = (x[R, D] @ bf16(q[D, F])) * scale[F], fp32 accumulation, cast to
x's dtype. No path of either package calls it: the JAX package keeps it
beside the layered kernels, and its tests are its only caller. On the GPU
it runs K4's kernel (the split-K core `csrc/splitk_matmul.cuh`, entry
`vl2_matmul_q8` in `csrc/decode_matmul.cu`), which already takes one
[D, F] int8 matrix with its [F] scales: a layered pack's layer li is
exactly that, so no kernel source of its own is needed. At an LM head's
widths (250 column tiles or more) the split plan has one split and the
blocks write y from their registers. F must be a multiple of 128. The
plain version below is the same function in PyTorch; the wrapper runs it
only for CPU tensors.
"""

from __future__ import annotations

import torch

from . import _build
from .decode_matmul import MAX_ROWS, launch_matmul


def matmul_q8_plain(x: torch.Tensor, q: torch.Tensor,
                    scale: torch.Tensor) -> torch.Tensor:
    """(x @ q.to(x.dtype)) in fp32 accumulation, times fp32 scale, cast to
    x's dtype."""
    y = (x.float() @ q.to(x.dtype).float()) * scale.float().reshape(-1)
    return y.to(x.dtype)


def matmul_q8(x: torch.Tensor, q: torch.Tensor,
              scale: torch.Tensor) -> torch.Tensor:
    """x: [R, D]; q: [D, F] int8; scale: [F] or [1, F]. Returns [R, F] in
    x's dtype. On CUDA, rows go to the kernel 64 at a time (its row limit),
    one launch each, as layer 0 of a one-layer pack."""
    if x.device.type == "cpu":
        return matmul_q8_plain(x, q, scale)
    if q.dim() != 2 or scale.numel() != q.shape[-1] or x.dim() != 2:
        raise ValueError(f"x [R, D], q [D, F] and [F] scales expected, got "
                         f"{tuple(x.shape)}, {tuple(q.shape)} and "
                         f"{tuple(scale.shape)}")
    y = torch.empty((x.shape[0], q.shape[1]), dtype=x.dtype, device=x.device)
    for r0 in range(0, x.shape[0], MAX_ROWS):
        launch_matmul("matmul_q8", 8, x[r0:r0 + MAX_ROWS], q[None],
                      scale.reshape(1, 1, -1), 0, y[r0:r0 + MAX_ROWS])
        _build.count_launch(matmul_q8)
    return y


matmul_q8.launches = 0
