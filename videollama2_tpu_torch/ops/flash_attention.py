"""K2: causal GQA flash attention (forward) for the LLM prefill.

CUDA kernel: `csrc/flash_attention.cu` (built by `ops/_build.py`), which
replaces the forward of videollama2_tpu/ops/flash_attention.py::
flash_attention without its LSE output (the LSE comes with the backward).
The source's header says what bounds it on the H100 and how its design
answers. The plain version below is the same function in PyTorch; the
wrapper runs it only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import attend_plain

SUPPORTED_HEAD_DIMS = (64, 128)


def flash_attention_plain(q, k, v, valid_len=None, causal=True, scale=None):
    """Plain version: masked softmax attention with GQA. A row whose keys
    are all masked (valid_len == 0) returns mean(v) over all Sk keys."""
    return attend_plain(q, k, v, valid_len=valid_len, causal=causal,
                        scale=scale)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; valid_len: [B] or None.

    Query head h attends kv head h // (Hq / Hkv); causal masking is
    top-left aligned (key j visible to query i when j <= i). Returns
    [B, Sq, Hq, D] in q's dtype.
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid_len, causal, scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        _build.check_operand(name, t, q.device)
    B, Sq, Hq, D = q.shape
    _, Sk, Hkv, _ = k.shape
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or Hq % Hkv):
        raise ValueError(f"bad q/k/v shapes {tuple(q.shape)} "
                         f"{tuple(k.shape)} {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention takes D in {SUPPORTED_HEAD_DIMS},"
                         f" got {D}")
    if valid_len is not None:
        if (valid_len.device != q.device or valid_len.shape != (B,)
                or valid_len.dtype != torch.int32):
            raise ValueError("valid_len must be int32 [B] on q's device")
        valid_len = valid_len.contiguous()
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lib = _build.library()
    err = lib.vl2_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        valid_len.data_ptr() if valid_len is not None else None,
        B, Sq, Sk, Hq, Hkv, D, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], float(scale), int(bool(causal)),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
