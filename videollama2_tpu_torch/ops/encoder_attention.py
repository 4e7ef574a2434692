"""K1 and K10: non-causal attention for the vision towers.

CUDA kernels (built by `ops/_build.py`): `csrc/encoder_attention.cu` (K1),
which replaces videollama2_tpu/ops/encoder_attention.py::encoder_attention,
and `csrc/encoder_attention_pairs.cu` (K10), which replaces its head-pair
form `_encoder_attention_packed`, reached as there through
`encoder_attention(..., pack_pairs=True)` (off by default; no model path
sets it). The sources' headers say what bounds them on the H100 and how
their designs answer. Both compute one function; the plain versions below
are that function in PyTorch, and the wrappers run them only for CPU
tensors.
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


def encoder_attention_pairs_plain(q, k, v, valid_len=None, scale=None):
    """Plain version of K10: the head-pair form computes the same function
    as K1, so its plain version is K1's."""
    return encoder_attention_plain(q, k, v, valid_len, scale)


def _launch(entry: str, q, k, v, valid_len, scale) -> torch.Tensor:
    """Check a CUDA call of K1 or K10 and launch it once; counts nothing."""
    if q.device.type != "cuda":
        raise ValueError(f"{entry}: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, q.device)
    B, S, H, D = q.shape
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v shapes differ: {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS or S > MAX_SEQ:
        raise ValueError(f"{entry} takes D in {SUPPORTED_HEAD_DIMS} and "
                         f"S <= {MAX_SEQ}, got S={S} D={D}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(f"{entry} has no backward: the towers it serves "
                           "are frozen")
    if valid_len is not None:
        if (valid_len.device != q.device or valid_len.shape != (B,)
                or valid_len.dtype != torch.int32):
            raise ValueError("valid_len must be int32 [B] on q's device")
        valid_len = valid_len.contiguous()
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = getattr(_build.library(), f"vl2_{entry}")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_len.data_ptr() if valid_len is not None else None,
        B, S, H, D, *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        float(scale), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, entry)
    return out


def encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      valid_len: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None,
                      pack_pairs: bool = False) -> torch.Tensor:
    """q/k/v: [B, S, H, D] with S <= 1024; valid_len: [B] keys per row.

    Returns [B, S, H, D] in q's dtype. Query rows past valid_len are
    computed like any other (they see the valid keys); callers ignore them.
    pack_pairs takes the head-pair kernel (K10, `encoder_attention_pairs`),
    as the JAX keyword takes its packed kernel; the default is K1.
    """
    if pack_pairs:
        return encoder_attention_pairs(q, k, v, valid_len, scale)
    if q.device.type == "cpu":
        return encoder_attention_plain(q, k, v, valid_len, scale)
    out = _launch("encoder_attention", q, k, v, valid_len, scale)
    encoder_attention.launches += 1
    return out


def encoder_attention_pairs(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor,
                            valid_len: Optional[torch.Tensor] = None,
                            scale: Optional[float] = None) -> torch.Tensor:
    """K10: encoder_attention over head pairs (2p, 2p + 1); H must be even.
    Same arguments and result as encoder_attention."""
    if q.dim() != 4 or q.shape[2] % 2:
        raise ValueError(f"encoder_attention_pairs takes [B, S, H, D] with "
                         f"an even H, got {tuple(q.shape)}")
    if q.device.type == "cpu":
        return encoder_attention_pairs_plain(q, k, v, valid_len, scale)
    out = _launch("encoder_attention_pairs", q, k, v, valid_len, scale)
    encoder_attention_pairs.launches += 1
    return out


encoder_attention.launches = 0
encoder_attention_pairs.launches = 0
