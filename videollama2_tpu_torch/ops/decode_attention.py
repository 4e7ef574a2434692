"""K3: one-token GQA decode attention over layer `layer` of the stacked
KV cache.

CUDA kernel: `csrc/decode_attention.cu` (built by `ops/_build.py`), which
replaces videollama2_tpu/ops/decode_attention.py::decode_attention_layered.
The source's header says what bounds it on the H100 and how its design
answers. The plain version below is the same function in PyTorch; the
wrapper runs it only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional

import torch

from . import _build
from .attention import NEG_INF

SUPPORTED_HEAD_DIMS = (64, 128)
SUPPORTED_GROUPS = (1, 2, 4, 7, 8)   # query heads per kv head
CHUNK = 128                       # cache rows a block (csrc kChunk)


def _keep(valid_len, write_pos: int, prompt_len: int,
          window: Optional[int], M: int) -> torch.Tensor:
    """[B, M] cache rows the current token attends (its own row excluded:
    it enters through the seed)."""
    col = torch.arange(M, device=valid_len.device)[None, :]
    valid = valid_len.long()[:, None]
    keep = (col < valid) | ((col >= prompt_len) & (col < write_pos))
    if window is not None:
        q_pos = valid + (write_pos - prompt_len)
        logical = torch.where(col < prompt_len, col,
                              valid + (col - prompt_len))
        keep = keep & (q_pos - logical < window)
    return keep


def decode_attention_plain(q, k_new, v_new, cache_k, cache_v, layer: int,
                           valid_len, write_pos: int, prompt_len: int,
                           window: Optional[int] = None, k_scale=None,
                           v_scale=None) -> torch.Tensor:
    """Plain version: a masked softmax over [cache rows of layer `layer`,
    the new token]. Scores and softmax in fp32; the k scale multiplies the
    scores before masking; p times the v scale is rounded to the values'
    dtype (q's for an int8 cache, the cache's otherwise) before the PV
    product; the new token's p * v_new stays fp32, as in the kernel's
    seeded state."""
    B, H, hd = q.shape
    K = k_new.shape[1]
    G = H // K
    M = cache_k.shape[2]
    scale = hd ** -0.5
    quantized = k_scale is not None
    qf = q.float().view(B, K, G, hd)
    kf = cache_k[layer].view(B, M, K, hd).float()
    vf = cache_v[layer].view(B, M, K, hd).float()
    s = torch.einsum("bkgd,bmkd->bkgm", qf, kf) * scale
    if quantized:
        s = s * k_scale[layer][:, :, None, :]
    keep = _keep(valid_len, write_pos, prompt_len, window, M)
    s = s.masked_fill(~keep[:, None, None, :], NEG_INF)
    s_new = (qf * k_new.float()[:, :, None, :]).sum(-1) * scale   # [B,K,G]
    m = torch.maximum(s.amax(-1), s_new)
    p = torch.exp(s - m[..., None])
    p_new = torch.exp(s_new - m)
    denom = p.sum(-1) + p_new
    value_dtype = q.dtype if quantized else cache_v.dtype
    p_in = (p * v_scale[layer][:, :, None, :]) if quantized else p
    pv = torch.einsum("bkgm,bmkd->bkgd", p_in.to(value_dtype).float(), vf)
    acc = pv + p_new[..., None] * v_new.float()[:, :, None, :]
    return (acc / denom[..., None]).to(q.dtype).reshape(B, H, hd)


def _check(name: str, t: torch.Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def decode_attention_layered(q: torch.Tensor, k_new: torch.Tensor,
                             v_new: torch.Tensor, cache_k: torch.Tensor,
                             cache_v: torch.Tensor, layer: int,
                             valid_len: torch.Tensor, write_pos: int,
                             prompt_len: int, window: Optional[int] = None,
                             k_scale: Optional[torch.Tensor] = None,
                             v_scale: Optional[torch.Tensor] = None
                             ) -> torch.Tensor:
    """Single-token GQA attention against layer `layer` of a stacked cache.

    q: [B, H, hd]; k_new/v_new: [B, Hkv, hd], the current token (with an
    int8 cache, its dequantized row); cache_k/v: [L, B, M, Hkv * hd], bf16,
    or int8 with k_scale/v_scale [L, B, Hkv, M] fp32; valid_len: [B] int32;
    write_pos: the cache row the current token will occupy (only rows below
    it are read); prompt_len: the prompt bucket; window: sliding window on
    logical positions. Returns [B, H, hd] in q's dtype.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k_new, v_new, cache_k, cache_v,
                                      layer, valid_len, write_pos,
                                      prompt_len, window, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    dev = q.device
    B, H, hd = q.shape
    K = k_new.shape[1]
    L, _, M, _ = cache_k.shape
    if hd not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"decode_attention takes hd in "
                         f"{SUPPORTED_HEAD_DIMS}, got {hd}")
    if H % K or H // K not in SUPPORTED_GROUPS:
        raise ValueError(f"decode_attention takes {SUPPORTED_GROUPS} query "
                         f"heads a kv head, got H={H} Hkv={K}")
    if not (0 <= layer < L and 0 <= prompt_len <= write_pos <= M):
        raise ValueError(f"bad layer {layer} / prompt_len {prompt_len} / "
                         f"write_pos {write_pos} for L={L} M={M}")
    bf16 = torch.bfloat16
    _check("q", q, dev, bf16, (B, H, hd))
    _check("k_new", k_new, dev, bf16, (B, K, hd))
    _check("v_new", v_new, dev, bf16, (B, K, hd))
    quantized = k_scale is not None
    cache_dtype = torch.int8 if quantized else bf16
    _check("cache_k", cache_k, dev, cache_dtype, (L, B, M, K * hd))
    _check("cache_v", cache_v, dev, cache_dtype, (L, B, M, K * hd))
    if quantized:
        if v_scale is None:
            raise ValueError("an int8 cache needs k_scale and v_scale")
        _check("k_scale", k_scale, dev, torch.float32, (L, B, K, M))
        _check("v_scale", v_scale, dev, torch.float32, (L, B, K, M))
    _check("valid_len", valid_len, dev, torch.int32, (B,))
    # the grid and the scratch follow M; chunks past write_pos exit at once
    nsplit = -(-M // CHUNK)
    out = torch.empty((B, H, hd), dtype=bf16, device=dev)
    part_acc = torch.empty((B, K, nsplit, H // K, hd), dtype=torch.float32,
                           device=dev)
    part_ml = torch.empty((B, K, nsplit, H // K, 2), dtype=torch.float32,
                          device=dev)
    lib = _build.library()
    err = lib.vl2_decode_attention(
        q.data_ptr(), k_new.data_ptr(), v_new.data_ptr(), cache_k.data_ptr(),
        cache_v.data_ptr(), k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, valid_len.data_ptr(),
        out.data_ptr(), part_acc.data_ptr(), part_ml.data_ptr(), B, H, K, hd,
        M, layer, write_pos, prompt_len, -1 if window is None else window,
        nsplit, hd ** -0.5, torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "decode_attention")
    _build.count_launch(decode_attention_layered)
    return out


decode_attention_layered.launches = 0
