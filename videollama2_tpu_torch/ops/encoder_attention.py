"""K1: non-causal attention for the vision towers.

CUDA kernel: `csrc/encoder_attention.cu` (built by `ops/_build.py`), which
replaces videollama2_tpu/ops/encoder_attention.py::encoder_attention. The
source's header says what bounds it on the H100 and how its design answers.
The plain version below is the same function in PyTorch; the wrapper runs it
only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import attend_plain

SUPPORTED_HEAD_DIMS = (64, 72)   # CLIP-L, SigLIP-SO400M
MAX_SEQ = 1024


def encoder_attention_plain(q, k, v, valid_len=None, scale=None):
    """Plain version: softmax(q k^T * scale + key-column mask) v."""
    return attend_plain(q, k, v, valid_len=valid_len, causal=False,
                        scale=scale)


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q/k/v: [B, S, H, D] with S <= 1024; valid_len: [B] keys per row.

    Returns [B, S, H, D] in q's dtype. Query rows past valid_len are
    computed like any other (they see the valid keys); callers ignore them.
    """
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, valid_len, scale)
    if q.device.type != "cuda":
        raise ValueError(f"encoder_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, q.device)
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS or S > MAX_SEQ:
        raise ValueError(f"encoder_attention takes D in {SUPPORTED_HEAD_DIMS}"
                         f" and S <= {MAX_SEQ}, got S={S} D={D}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("encoder_attention has no backward: the towers "
                           "it serves are frozen")
    if valid_len is not None:
        if (valid_len.device != q.device or valid_len.shape != (B,)
                or valid_len.dtype != torch.int32):
            raise ValueError("valid_len must be int32 [B] on q's device")
        valid_len = valid_len.contiguous()
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    lib = _build.library()
    err = lib.vl2_encoder_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_len.data_ptr() if valid_len is not None else None,
        B, S, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "encoder_attention")
    encoder_attention.launches += 1
    return out


encoder_attention.launches = 0
