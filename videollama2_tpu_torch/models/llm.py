"""Causal decoder, bf16 dense path (port of videollama2_tpu/models/llm.py).

Mistral/Llama/Qwen2-style dense decoders with GQA, RoPE in the rotate-half
layout and RMSNorm. MoE, the int8 KV cache and the packed int8/int4 decode
raise NotImplementedError until their port.

Params (kernels [in, out], layers stacked on a leading L axis):
  embed.weight [V, D]   final_norm.scale [D]   lm_head.kernel [D, V]
  layers: attn_norm.scale/mlp_norm.scale [L, D]
          qkv.kernel [L, D, (H + 2 Hkv) hd] (+ .bias for Qwen2)
          o.kernel [L, H hd, D]; gate/up.kernel [L, D, F]; down.kernel [L, F, D]
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from videollama2_tpu.core.config import LLMConfig

from ..ops import attention as attn_ops
from ..ops.layers import (apply_rope, dense, layer_params, rms_norm,
                          rope_table)


@dataclass
class KVCache:
    """Preallocated KV cache, k/v: [L, B, M, Hkv * hd] (the JAX layout, with
    the kv-head and head-dim axes merged). Prefill and decode write rows in
    place."""
    k: torch.Tensor
    v: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[2]


def _check_supported(cfg: LLMConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError("MoE decoders are not ported yet")
    if cfg.tie_word_embeddings:
        raise NotImplementedError("tied embeddings are not ported yet")


def init_cache(cfg: LLMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_bits: int = 16,
               device=None) -> KVCache:
    if kv_bits != 16:
        raise NotImplementedError("the int8 KV cache is not ported yet")
    shape = (cfg.num_layers, batch, max_len,
             cfg.num_kv_heads * cfg.head_dim)
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def param_shapes(cfg: LLMConfig) -> dict:
    _check_supported(cfg)
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = {"kernel": (L, D, (H + 2 * K) * hd)}
    if cfg.qkv_bias:
        qkv["bias"] = (L, (H + 2 * K) * hd)
    return {
        "embed": {"weight": (cfg.vocab_size, D)},
        "layers": {
            "attn_norm": {"scale": (L, D)},
            "qkv": qkv,
            "o": {"kernel": (L, H * hd, D)},
            "mlp_norm": {"scale": (L, D)},
            "gate": {"kernel": (L, D, F_)},
            "up": {"kernel": (L, D, F_)},
            "down": {"kernel": (L, F_, D)},
        },
        "final_norm": {"scale": (D,)},
        "lm_head": {"kernel": (D, cfg.vocab_size)},
    }


def embed_tokens(params: dict, token_ids: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    w = params["embed"]["weight"]
    if dtype is not None:
        w = w.to(dtype)
    return F.embedding(token_ids, w)


def lm_logits(params: dict, cfg: LLMConfig,
              hidden: torch.Tensor) -> torch.Tensor:
    """Vocabulary logits in fp32 (products of the hidden dtype's values,
    fp32 accumulation and no rounding of the result, as in the JAX head)."""
    kernel = params["lm_head"]["kernel"]
    return torch.matmul(hidden.float(), kernel.to(hidden.dtype).float())


def _split_qkv(cfg: LLMConfig, qkv: torch.Tensor):
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + K) * hd].unflatten(-1, (K, hd))
    v = qkv[..., (H + K) * hd:].unflatten(-1, (K, hd))
    return q, k, v


def _ffn(x: torch.Tensor, lp: dict) -> torch.Tensor:
    return dense(F.silu(dense(x, lp["gate"])) * dense(x, lp["up"]),
                 lp["down"])


def forward(params: dict, cfg: LLMConfig, embeds: torch.Tensor,
            positions: torch.Tensor, valid_len: torch.Tensor,
            cache: Optional[KVCache] = None) -> torch.Tensor:
    """Full-sequence forward (prefill). embeds [B, S, D], positions [B, S],
    valid_len [B] int32. Writes each layer's k/v into cache rows [0, S) in
    place when a cache is given. Returns the final-normed hidden [B, S, D].
    """
    _check_supported(cfg)
    B, S, _ = embeds.shape
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _split_qkv(cfg, dense(h, lp["qkv"]))
        q, k = apply_rope(q, k, cos, sin)
        if cache is not None:
            # in-place write of this layer's prompt rows
            cache.k[i, :, :S] = k.reshape(B, S, -1)
            cache.v[i, :, :S] = v.reshape(B, S, -1)
        out = attn_ops.attend(q, k, v, valid_len=valid_len, causal=True,
                              window=cfg.sliding_window)
        x = x + dense(out.reshape(B, S, -1), lp["o"])
        h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _ffn(h, lp)
    return rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)


def prefill(params: dict, cfg: LLMConfig, embeds: torch.Tensor,
            positions: torch.Tensor, valid_len: torch.Tensor,
            cache: KVCache) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt, fill cache rows [0, S), return the hidden state of
    each sample's last VALID token ([B, D]) and the cache."""
    hidden = forward(params, cfg, embeds, positions, valid_len, cache)
    S = embeds.shape[1]
    idx = torch.clamp(valid_len.long() - 1, 0, S - 1)
    last = hidden[torch.arange(hidden.shape[0], device=hidden.device), idx]
    return last, cache


def decode_mask(cfg: LLMConfig, valid_len: torch.Tensor, prompt_len: int,
                step: int, max_len: int) -> torch.Tensor:
    """[B, 1, 1, M] keys a decode step attends: prompt rows below valid_len
    and the generated rows [prompt_len, prompt_len + step]."""
    ki = torch.arange(max_len, device=valid_len.device)[None, :]
    write_pos = prompt_len + step
    mask = (ki < valid_len[:, None]) | ((ki >= prompt_len) & (ki <= write_pos))
    if cfg.sliding_window is not None:
        positions = (valid_len + step)[:, None]
        logical_k = torch.where(ki < prompt_len, ki,
                                valid_len[:, None] + (ki - prompt_len))
        mask = mask & (positions - logical_k < cfg.sliding_window)
    return mask[:, None, None, :]


def decode_step(params: dict, cfg: LLMConfig, token_embeds: torch.Tensor,
                cache: KVCache, valid_len: torch.Tensor, prompt_len: int,
                step: int) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for the whole batch.

    Shared-row cache layout: every sample's generated token `step` lives at
    cache row prompt_len + step (prompt keys occupy [0, valid_len_b); rows
    [valid_len_b, prompt_len) stay masked padding), while its RoPE position
    is the logical valid_len + step.

    token_embeds: [B, 1, D]; valid_len: [B]; prompt_len: the prompt bucket;
    step: decode index. Returns (logits [B, V] fp32, cache written in place).
    """
    _check_supported(cfg)
    B = token_embeds.shape[0]
    M = cache.max_len
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = (valid_len + step)[:, None]
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    write_pos = prompt_len + step
    mask = decode_mask(cfg, valid_len, prompt_len, step, M)
    x = token_embeds
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _split_qkv(cfg, dense(h, lp["qkv"]))
        q, k = apply_rope(q, k, cos, sin)
        # in-place write of the new row, shared by every sample
        cache.k[i, :, write_pos] = k.reshape(B, K * hd).to(cache.k.dtype)
        cache.v[i, :, write_pos] = v.reshape(B, K * hd).to(cache.v.dtype)
        k_read = cache.k[i].view(B, M, K, hd).to(q.dtype)
        v_read = cache.v[i].view(B, M, K, hd).to(q.dtype)
        out = attn_ops.mha(q, k_read, v_read, mask=mask)
        x = x + dense(out.reshape(B, 1, H * hd), lp["o"])
        h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _ffn(h, lp)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return lm_logits(params, cfg, x[:, 0]), cache
