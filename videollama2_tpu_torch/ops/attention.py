"""Attention: the plain PyTorch reference and the dispatch to the kernels.

Port of videollama2_tpu/ops/attention.py. `attend` carries structured mask
information (causal flag, per-batch valid lengths, sliding window) so the
CUDA kernels can skip masked key tiles; `attend_plain` materializes the same
mask and gives the same result up to floating-point tolerance.
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30  # large finite negative: a fully masked row yields mean(v)


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        scale: Optional[float] = None) -> torch.Tensor:
    """Reference multi-head attention with an explicit mask.

    q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; mask broadcastable to
    [B, Hq, Sq, Sk] (True = attend), given as [B, 1 or Hq, Sq, Sk].
    Products of the input dtype accumulate in fp32 and the softmax is fp32,
    as in the JAX package; GQA folds the query group into the product.
    """
    if scale is None:
        scale = q.shape[-1] ** -0.5
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    rep = Hq // Hkv
    qg = q.reshape(B, Sq, Hkv, rep, D)
    logits = torch.einsum("bqhrd,bkhd->bhrqk", qg.float(), k.float()) * scale
    if mask is not None:
        if mask.shape[1] == 1:
            m = mask[:, :, None]
        else:
            m = mask.reshape(B, Hkv, rep, Sq, -1)
        logits = logits.masked_fill(~m, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhrqk,bkhd->bqhrd", probs.to(v.dtype).float(),
                       v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def attend_plain(q, k, v, valid_len=None, causal: bool = True,
                 window: Optional[int] = None,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Structured-mask attention, plain PyTorch (JAX `attend_xla`)."""
    B, Sq = q.shape[0], q.shape[1]
    Sk = k.shape[1]
    mask = None
    if causal or valid_len is not None or window is not None:
        qi = torch.arange(Sq, device=q.device)[:, None]
        ki = torch.arange(Sk, device=q.device)[None, :]
        m = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
        if causal:
            m = m & (qi >= ki)
        if window is not None:
            m = m & (qi - ki < window)
        mask = m[None, None].expand(B, 1, Sq, Sk)
        if valid_len is not None:
            mask = mask & (ki[None, None] < valid_len[:, None, None, None])
    return mha(q, k, v, mask=mask, scale=scale)


def attend(q, k, v, valid_len=None, causal: bool = True,
           window: Optional[int] = None,
           scale: Optional[float] = None) -> torch.Tensor:
    """Attention entry point of every full-sequence forward.

    The routing follows the JAX package's TPU rule without its padding, and
    with the tower's head dims: a call without a sliding window and with at
    least 128 queries goes to a kernel when one takes its head dim. A
    non-causal square call of up to 1024 tokens with equal heads and a head
    dim K1 takes (64 for CLIP, 72 for SigLIP, which JAX leaves to XLA) goes
    to the encoder kernel; another with a head dim that is a multiple of 64
    to the flash kernel. Everything else takes the plain path, as JAX sends
    it to XLA. Each kernel's wrapper then runs the CUDA kernel for CUDA
    tensors and its plain version for CPU tensors. When a gradient is needed
    (grad mode on and q, k or v requiring one), the flash route goes through
    `FlashAttention`, whose backward runs the K8/K9 kernels; the encoder
    route is never differentiated (the towers are frozen).
    """
    from . import encoder_attention as enc
    Sq, Sk, D = q.shape[1], k.shape[1], q.shape[-1]
    if window is None and Sq >= 128:
        if (not causal and Sq == Sk and Sq <= enc.MAX_SEQ
                and q.shape[2] == k.shape[2]
                and D in enc.SUPPORTED_HEAD_DIMS):
            return enc.encoder_attention(q, k, v, valid_len, scale)
        if D % 64 == 0:
            from .flash_attention import FlashAttention, flash_attention
            if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                            or v.requires_grad):
                return FlashAttention.apply(q, k, v, valid_len, causal, scale)
            return flash_attention(q, k, v, valid_len, causal, scale)
    return attend_plain(q, k, v, valid_len=valid_len, causal=causal,
                        window=window, scale=scale)
