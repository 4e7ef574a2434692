"""K2, K8, K9: causal GQA flash attention, forward and backward.

CUDA kernels: `csrc/flash_attention.cu` (K2, the forward, optionally with
its per-row log-sum-exp), `csrc/flash_attention_bwd.cu` (K8: dq and delta)
and `csrc/flash_attention_dkv.cu` (K9: dk/dv), built by `ops/_build.py`.
All three load their tiles by TMA, so q/k/v (and the contiguous o and do
of the backward) must pass `_build.check_operand` (every stride and the
base a multiple of 16 bytes), which is what TMA takes. They replace the Pallas kernels of
videollama2_tpu/ops/flash_attention.py: `flash_attention` (with
`return_lse`) and the two kernels of `flash_attention_bwd`; `FlashAttention`
is the port of its `flash_attention_vjp`. The sources' headers say what
bounds each kernel on the H100 and how its design answers. The plain
versions below are the same functions in PyTorch; the wrappers run them
only for CPU tensors, and on CUDA tensors launch the kernels or raise.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF, attend_plain

SUPPORTED_HEAD_DIMS = (64, 128)


def _mask(Sq: int, Sk: int, valid_len, causal: bool, device):
    """[B or 1, Sq, Sk] bool: key j visible to query i (j < valid_len and,
    causal, j <= i)."""
    qi = torch.arange(Sq, device=device)[:, None]
    ki = torch.arange(Sk, device=device)[None, :]
    m = (qi >= ki) if causal else torch.ones((Sq, Sk), dtype=torch.bool,
                                             device=device)
    m = m[None]
    if valid_len is not None:
        m = m & (ki[None] < valid_len[:, None, None])
    return m


def _scores(q, k, valid_len, causal, scale):
    """Masked scaled fp32 scores [B, Hkv, rep, Sq, Sk] (masked: -1e30)."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, Hkv, Hq // Hkv, D)
    s = torch.einsum("bqhrd,bkhd->bhrqk", qg, k.float()) * scale
    m = _mask(Sq, Sk, valid_len, causal, q.device)
    return s.masked_fill(~m[:, None, None], NEG_INF)


def flash_attention_plain(q, k, v, valid_len=None, causal=True, scale=None,
                          return_lse: bool = False):
    """Plain version: masked softmax attention with GQA. A row whose keys
    are all masked (valid_len == 0) returns mean(v) over all Sk keys and,
    with return_lse, lse = -1e30. lse is fp32 [B, Hq, Sq]."""
    out = attend_plain(q, k, v, valid_len=valid_len, causal=causal,
                       scale=scale)
    if not return_lse:
        return out
    B, Sq, Hq, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    lse = torch.logsumexp(_scores(q, k, valid_len, causal, scale), dim=-1)
    return out, lse.reshape(B, Hq, Sq)


def attention_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(do * o) in fp32, [B, Sq, Hq, D] -> [B, Hq, Sq]."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2)


def _bwd_plain(q, k, v, lse, do, delta, valid_len, causal, scale,
               dq_part=True, dkv_part=True):
    """FlashAttention-2's backward with the explicit mask, in fp32, one
    batch row at a time (bounds the [Hq, Sq, Sk] intermediates). Returns
    (dq, dk, dv), None for a part not asked for."""
    B, Sq, Hq, D = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rep = Hq // Hkv
    scale = D ** -0.5 if scale is None else scale

    def empty(t):
        return torch.empty(t.shape, dtype=torch.float32, device=q.device)
    dq = empty(q) if dq_part else None
    dk, dv = (empty(k), empty(v)) if dkv_part else (None, None)
    for b in range(B):
        vl = None if valid_len is None else valid_len[b:b + 1]
        qb = q[b].float().reshape(Sq, Hkv, rep, D)
        kb, vb = k[b].float(), v[b].float()
        dob = do[b].float().reshape(Sq, Hkv, rep, D)
        s = torch.einsum("qhrd,khd->hrqk", qb, kb) * scale
        m = _mask(Sq, Sk, vl, causal, q.device)[0]
        # explicit zeroing, not exp of a masked score: a fully masked row
        # carries lse = -1e30, where exp(s - lse) overflows
        p = torch.where(m, torch.exp(s - lse[b].reshape(Hkv, rep, Sq, 1)),
                        torch.zeros((), device=q.device))
        dp = torch.einsum("qhrd,khd->hrqk", dob, vb)
        ds = p * (dp - delta[b].reshape(Hkv, rep, Sq, 1)) * scale
        if dq_part:
            dq[b] = torch.einsum("hrqk,khd->qhrd", ds, kb).reshape(Sq, Hq, D)
        if dkv_part:
            dk[b] = torch.einsum("hrqk,qhrd->khd", ds, qb)
            dv[b] = torch.einsum("hrqk,qhrd->khd", p, dob)
    return tuple(None if t is None else t.to(ref.dtype)
                 for t, ref in ((dq, q), (dk, k), (dv, v)))


def flash_attention_bwd_dq_plain(q, k, v, o, lse, do, valid_len=None,
                                 causal=True, scale=None):
    """Plain version of K8: (dq, delta)."""
    delta = attention_delta(o, do)
    return _bwd_plain(q, k, v, lse, do, delta, valid_len, causal, scale,
                      dkv_part=False)[0], delta


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, valid_len=None,
                                  causal=True, scale=None):
    """Plain version of K9: (dk, dv) from K8's delta."""
    return _bwd_plain(q, k, v, lse, do, delta, valid_len, causal, scale,
                      dq_part=False)[1:]


def flash_attention_bwd_plain(q, k, v, o, lse, do, valid_len=None,
                              causal=True, scale=None):
    """Plain version of the backward: (dq, dk, dv) from the forward's o and
    lse ([B, Hq, Sq]) and the output gradient do. GQA: dk/dv sum their
    group's query heads in fp32. Rows masked entirely get zero gradients."""
    return _bwd_plain(q, k, v, lse, do, attention_delta(o, do), valid_len,
                      causal, scale)


def _check_qkv(q, k, v, valid_len):
    """Checks shared by the three kernels; returns the dims and valid_len
    (int32 [B] contiguous, or None). A kernel call is not differentiable:
    it refuses inputs that need a gradient (FlashAttention calls the
    kernels with grad mode off)."""
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention: the kernel call is not "
                           "differentiable; use FlashAttention.apply")
    if valid_len is not None:
        if (valid_len.device != q.device or valid_len.shape != (B,)
                or valid_len.dtype != torch.int32):
            raise ValueError("valid_len must be int32 [B] on q's device")
        valid_len = valid_len.contiguous()
    return B, Sq, Sk, Hq, Hkv, D, valid_len


def _on_cuda(name: str, q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {q.device}")


def _check_rows(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    """o / do: bf16 [B, Sq, Hq, D] on device, made contiguous, with a base
    TMA and the kernels' 16-byte loads take."""
    if t.device != device or t.dtype != torch.bfloat16 \
            or tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be bf16 {tuple(shape)} on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    t = t.contiguous()
    _build.check_operand(name, t, device)
    return t


def _check_rowstat(name: str, t: torch.Tensor, shape, device) -> None:
    """lse / delta: fp32 contiguous [B, Hq, Sq] on device."""
    if t.device != device or t.dtype != torch.float32 \
            or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous fp32 {tuple(shape)} "
                         f"on {device}")


def _strides(q, k, v):
    return (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    valid_len: Optional[torch.Tensor] = None,
                    causal: bool = True,
                    scale: Optional[float] = None,
                    return_lse: bool = False):
    """q: [B, Sq, Hq, D]; k/v: [B, Sk, Hkv, D]; valid_len: [B] or None.

    Query head h attends kv head h // (Hq / Hkv); causal masking is
    top-left aligned (key j visible to query i when j <= i). Returns
    [B, Sq, Hq, D] in q's dtype and, with return_lse, the per-row
    log-sum-exp of the scaled masked scores as fp32 [B, Hq, Sq].
    """
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, valid_len, causal, scale,
                                     return_lse)
    _on_cuda("flash_attention", q)
    B, Sq, Sk, Hq, Hkv, D, valid_len = _check_qkv(q, k, v, valid_len)
    if scale is None:
        scale = D ** -0.5
    out = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _build.library().vl2_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        valid_len.data_ptr() if valid_len is not None else None,
        B, Sq, Sk, Hq, Hkv, D, *_strides(q, k, v), float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


def flash_attention_bwd_dq(q, k, v, o, lse, do, valid_len=None, causal=True,
                           scale=None):
    """K8: (dq [B, Sq, Hq, D], delta fp32 [B, Hq, Sq]); K9 reads delta."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, o, lse, do, valid_len,
                                            causal, scale)
    _on_cuda("flash_attention_bwd_dq", q)
    B, Sq, Sk, Hq, Hkv, D, valid_len = _check_qkv(q, k, v, valid_len)
    o = _check_rows("o", o, q.shape, q.device)
    do = _check_rows("do", do, q.shape, q.device)
    _check_rowstat("lse", lse, (B, Hq, Sq), q.device)
    scale = D ** -0.5 if scale is None else scale
    dq = torch.empty((B, Sq, Hq, D), dtype=q.dtype, device=q.device)
    delta = torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
    err = _build.library().vl2_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        valid_len.data_ptr() if valid_len is not None else None,
        B, Sq, Sk, Hq, Hkv, D, *_strides(q, k, v), float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_dq")
    flash_attention_bwd_dq.launches += 1
    return dq, delta


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid_len=None,
                            causal=True, scale=None):
    """K9: (dk, dv) [B, Sk, Hkv, D], each query group summed in fp32."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                             valid_len, causal, scale)
    _on_cuda("flash_attention_bwd_dkv", q)
    B, Sq, Sk, Hq, Hkv, D, valid_len = _check_qkv(q, k, v, valid_len)
    do = _check_rows("do", do, q.shape, q.device)
    _check_rowstat("lse", lse, (B, Hq, Sq), q.device)
    _check_rowstat("delta", delta, (B, Hq, Sq), q.device)
    scale = D ** -0.5 if scale is None else scale
    dk = torch.empty((B, Sk, Hkv, D), dtype=k.dtype, device=q.device)
    dv = torch.empty((B, Sk, Hkv, D), dtype=v.dtype, device=q.device)
    err = _build.library().vl2_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        valid_len.data_ptr() if valid_len is not None else None,
        B, Sq, Sk, Hq, Hkv, D, *_strides(q, k, v), float(scale),
        int(bool(causal)), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(err, "flash_attention_bwd_dkv")
    flash_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_attention_bwd(q, k, v, o, lse, do, valid_len=None, causal=True,
                        scale=None):
    """(dq, dk, dv): K8 then K9 on CUDA tensors (do made contiguous once),
    the plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, lse, do, valid_len,
                                         causal, scale)
    do = do.contiguous()
    dq, delta = flash_attention_bwd_dq(q, k, v, o, lse, do, valid_len,
                                       causal, scale)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid_len,
                                     causal, scale)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention (JAX `flash_attention_vjp`): the
    forward runs K2 with its LSE and saves q, k, v, o and lse; the backward
    runs K8 and K9. On CPU tensors both halves are the plain versions.
    Under torch.utils.checkpoint the forward runs again during the
    backward, so a checkpointed layer launches K2 twice a step."""

    @staticmethod
    def forward(ctx, q, k, v, valid_len=None, causal=True, scale=None):
        scale = q.shape[-1] ** -0.5 if scale is None else scale
        out, lse = flash_attention(q, k, v, valid_len, causal, scale,
                                   return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse, valid_len)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse, valid_len = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do, valid_len,
                                         ctx.causal, ctx.scale)
        return dq, dk, dv, None, None, None


flash_attention.launches = 0
flash_attention_bwd_dq.launches = 0
flash_attention_bwd_dkv.launches = 0
