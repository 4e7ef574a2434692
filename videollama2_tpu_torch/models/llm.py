"""Causal decoder, dense path (port of videollama2_tpu/models/llm.py).

Mistral/Llama/Qwen2-style dense decoders with GQA, RoPE in the rotate-half
layout and RMSNorm; floating, int8-packed or folded-int4-packed weights; a
bf16 or int8 KV cache; prefill, one-token decode and the K-slot speculative
verify pass. MoE raises NotImplementedError until its port.

Params (kernels [in, out], layers stacked on a leading L axis):
  embed.weight [V, D]   final_norm.scale [D]
  lm_head.kernel [D, V] (absent with tied embeddings: the head is embed.T)
  layers: attn_norm.scale/mlp_norm.scale [L, D]
          qkv.kernel [L, D, (H + 2 Hkv) hd] (+ .bias for Qwen2)
          o.kernel [L, H hd, D]; gate/up.kernel [L, D, F]; down.kernel [L, F, D]
With int8 weights every `kernel` above (the head's included) is a
`kernel_q8` pack {q int8 [.., in, out], scale [.., 1, out]} (ops/quant);
with int4 weights the layers' kernels are `kernel_q4` packs {q4 int8
[.., in/2, out], scale [.., 1, out]} and the head stays a `kernel_q8` pack.
An int8 embedding is embed.weight_q8 {q int8 [V, D], scale [V, 1]}.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..core.config import LLMConfig
from ..ops import attention as attn_ops
from ..ops import decode_attention as dk_attn
from ..ops import decode_matmul as dk
from ..ops.layers import (apply_rope, dense, layer_params, rms_norm,
                          rope_table)
from ..ops.quant import PACKS, kernel_shapes


@dataclass
class KVCache:
    """Preallocated KV cache, k/v: [L, B, M, Hkv * hd] (the JAX layout, with
    the kv-head and head-dim axes merged). Prefill and decode write rows in
    place.

    int8 cache (init_cache(kv_bits=8)): k/v hold int8 rows and
    k_scale/v_scale the per-(row, kv-head) fp32 scales, stored transposed
    as [L, B, Hkv, M] like the JAX cache, so both compare one to one. Every
    writer quantizes with `_quantize_kv_rows`."""
    k: torch.Tensor
    v: torch.Tensor
    k_scale: Optional[torch.Tensor] = None
    v_scale: Optional[torch.Tensor] = None

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _check_supported(cfg: LLMConfig) -> None:
    if cfg.is_moe:
        raise NotImplementedError("MoE decoders are not ported yet")


def init_cache(cfg: LLMConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, kv_bits: int = 16,
               device=None) -> KVCache:
    shape = (cfg.num_layers, batch, max_len,
             cfg.num_kv_heads * cfg.head_dim)
    if kv_bits == 8:
        sshape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len)
        return KVCache(
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(shape, dtype=torch.int8, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device),
            torch.zeros(sshape, dtype=torch.float32, device=device))
    if kv_bits != 16:
        raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
    return KVCache(torch.zeros(shape, dtype=dtype, device=device),
                   torch.zeros(shape, dtype=dtype, device=device))


def _quantize_kv_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-(row, kv-head) int8 quantization of new cache rows,
    bit-identical to the JAX package's: x [..., hd] -> (int8 [..., hd],
    fp32 scale [...]). The only KV quantizer: prefill and decode write
    through it."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _store_kv(cache: KVCache, i: int, start, k: torch.Tensor,
              v: torch.Tensor) -> None:
    """Write layer i's rows [start, start + n) in place from k/v
    [B, n, Hkv, hd]; an int8 cache stores them through _quantize_kv_rows.
    start is an int shared by the batch or a [B] tensor of per-row
    offsets; with offsets, rows past the cache's end land on its last
    row."""
    B, n = k.shape[:2]
    if isinstance(start, torch.Tensor):
        b = torch.arange(B, device=k.device)[:, None]
        rows = torch.clamp(start[:, None] + torch.arange(n, device=k.device),
                           max=cache.max_len - 1)
    for dst, scales, x in ((cache.k, cache.k_scale, k),
                           (cache.v, cache.v_scale, v)):
        if cache.quantized:
            x, s = _quantize_kv_rows(x)            # [B,n,K,hd], [B,n,K]
            if isinstance(start, torch.Tensor):
                scales[i][b, :, rows] = s
            else:
                scales[i, :, :, start:start + n] = s.transpose(1, 2)
        x = x.reshape(B, n, -1).to(dst.dtype)
        if isinstance(start, torch.Tensor):
            dst[i][b, rows] = x
        else:
            dst[i, :, start:start + n] = x


def _read_kv(cache: KVCache, i: int, rows: slice, kv_heads: int, dtype):
    """Layer i's cache rows as k/v [B, n, Hkv, hd] in dtype, an int8 cache
    dequantized (JAX `_dequant_kv`)."""
    out = []
    for src, scales in ((cache.k, cache.k_scale), (cache.v, cache.v_scale)):
        x = src[i, :, rows]
        x = x.reshape(x.shape[0], x.shape[1], kv_heads, -1)
        if cache.quantized:
            x = x.float() * scales[i, :, :, rows].transpose(1, 2)[..., None]
        out.append(x.to(dtype))
    return out


def param_shapes(cfg: LLMConfig, bits: Optional[int] = None,
                 int8_embed: bool = False) -> dict:
    """Shapes of the decoder's params; with weight bits 8 or 4, the layout
    of ops/quant.quantize_llm_params(bits) with the (int8) head included;
    with int8_embed, its include_embed pack of the embedding."""
    _check_supported(cfg)
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    qkv = kernel_shapes((L, D, (H + 2 * K) * hd), bits)
    if cfg.qkv_bias:
        qkv["bias"] = (L, (H + 2 * K) * hd)
    V = cfg.vocab_size
    shapes = {
        "embed": ({"weight_q8": {"q": (V, D), "scale": (V, 1)}}
                  if int8_embed else {"weight": (V, D)}),
        "layers": {
            "attn_norm": {"scale": (L, D)},
            "qkv": qkv,
            "o": kernel_shapes((L, H * hd, D), bits),
            "mlp_norm": {"scale": (L, D)},
            "gate": kernel_shapes((L, D, F_), bits),
            "up": kernel_shapes((L, D, F_), bits),
            "down": kernel_shapes((L, F_, D), bits),
        },
        "final_norm": {"scale": (D,)},
    }
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = kernel_shapes((D, V), bits and 8)
    return shapes


def embed_tokens(params: dict, token_ids: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """Embedding rows of token_ids in dtype. An int8 table ("weight_q8",
    per-row scales) gathers only the looked-up int8 rows and their scales
    and multiplies them in fp32 before the cast (JAX `embed_tokens`; fp32
    when dtype is None)."""
    emb = params["embed"]
    if "weight_q8" in emb:
        pack = emb["weight_q8"]
        rows = F.embedding(token_ids, pack["q"]).float()
        out = rows * F.embedding(token_ids, pack["scale"]).float()
        return out.to(dtype if dtype is not None else torch.float32)
    w = emb["weight"]
    if dtype is not None:
        w = w.to(dtype)
    return F.embedding(token_ids, w)


def lm_logits(params: dict, cfg: LLMConfig, hidden: torch.Tensor,
              w8a8: bool = False) -> torch.Tensor:
    """Vocabulary logits in fp32. A floating head multiplies the hidden
    dtype's values with fp32 accumulation and no rounding of the result;
    an int8 head goes through dense (w8a8 selects its branch) and its
    output in the hidden dtype is widened, as in the JAX head. With tied
    embeddings the head is the embedding's transpose (an int8 embedding
    dequantized in fp32 first) on the floating branch."""
    if cfg.tie_word_embeddings:
        emb = params["embed"]
        if "weight_q8" in emb:
            pack = emb["weight_q8"]
            kernel = (pack["q"].float() * pack["scale"].float()).T
        else:
            kernel = emb["weight"].T
    else:
        head = params["lm_head"]
        if "kernel_q8" in head:
            return dense(hidden, head, w8a8).float()
        kernel = head["kernel"]
    return torch.matmul(hidden.float(), kernel.to(hidden.dtype).float())


def _split_qkv(cfg: LLMConfig, qkv: torch.Tensor):
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + K) * hd].unflatten(-1, (K, hd))
    v = qkv[..., (H + K) * hd:].unflatten(-1, (K, hd))
    return q, k, v


def _ffn(x: torch.Tensor, lp: dict, w8a8: bool) -> torch.Tensor:
    return dense(F.silu(dense(x, lp["gate"], w8a8)) * dense(x, lp["up"], w8a8),
                 lp["down"], w8a8)


def _layer(cfg: LLMConfig, x: torch.Tensor, lp: dict, cos: torch.Tensor,
           sin: torch.Tensor, valid_len: torch.Tensor,
           cache: Optional[KVCache], i: int, w8a8: bool) -> torch.Tensor:
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
    q, k, v = _split_qkv(cfg, dense(h, lp["qkv"], w8a8))
    q, k = apply_rope(q, k, cos, sin)
    if cache is not None:
        _store_kv(cache, i, 0, k, v)
    out = attn_ops.attend(q, k, v, valid_len=valid_len, causal=True,
                          window=cfg.sliding_window)
    x = x + dense(out.reshape(B, S, -1), lp["o"], w8a8)
    h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
    return x + _ffn(h, lp, w8a8)


def forward(params: dict, cfg: LLMConfig, embeds: torch.Tensor,
            positions: torch.Tensor, valid_len: torch.Tensor,
            cache: Optional[KVCache] = None,
            w8a8: bool = False, remat: bool = False) -> torch.Tensor:
    """Full-sequence forward (prefill and training). embeds [B, S, D],
    positions [B, S], valid_len [B] int32. Writes each layer's k/v into
    cache rows [0, S) in place when a cache is given (an int8 cache stores
    the rows quantized; attention itself uses the exact k/v). w8a8 selects
    the serving branch of int8 packs. remat (training, no cache) wraps each
    layer in torch.utils.checkpoint, as the JAX package wraps its layer
    body in jax.checkpoint: only each layer's input is kept, and the layer
    runs again in the backward. Returns the final-normed hidden [B, S, D].
    """
    _check_supported(cfg)
    if remat and cache is not None:
        raise ValueError("remat is for training: it takes no cache")
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        if remat:
            x = checkpoint(_layer, cfg, x, lp, cos, sin, valid_len, None, i,
                           w8a8, use_reentrant=False)
        else:
            x = _layer(cfg, x, lp, cos, sin, valid_len, cache, i, w8a8)
    return rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)


def prefill(params: dict, cfg: LLMConfig, embeds: torch.Tensor,
            positions: torch.Tensor, valid_len: torch.Tensor,
            cache: KVCache, w8a8: bool = False
            ) -> Tuple[torch.Tensor, KVCache]:
    """Run the prompt, fill cache rows [0, S), return the hidden state of
    each sample's last VALID token ([B, D]) and the cache."""
    hidden = forward(params, cfg, embeds, positions, valid_len, cache, w8a8)
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


_PACKED = ("qkv", "o", "gate", "up", "down")


def _packed_decode(layers: dict) -> Optional[int]:
    """The weight bits of the layered decode kernels: 8 when every
    projection is an int8 pack, 4 when every one is a folded int4 pack,
    without LoRA (the JAX package's routing); None otherwise."""
    for bits, (pack, _) in PACKS.items():
        if all(pack in layers[n] and "lora" not in layers[n]
               for n in _PACKED):
            return bits
    return None


def decode_step(params: dict, cfg: LLMConfig, token_embeds: torch.Tensor,
                cache: KVCache, valid_len: torch.Tensor, prompt_len: int,
                step: int, w8a8: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """One decode step for the whole batch.

    Shared-row cache layout: every sample's generated token `step` lives at
    cache row prompt_len + step (prompt keys occupy [0, valid_len_b); rows
    [valid_len_b, prompt_len) stay masked padding), while its RoPE position
    is the logical valid_len + step.

    token_embeds: [B, 1, D]; valid_len: [B]; prompt_len: the prompt bucket;
    step: decode index. Returns (logits [B, V] fp32, cache written in place).
    With int8 or int4 packs on every projection the step runs on the
    layered kernels (`_decode_step_q8`); otherwise on dense() and the plain
    masked attention over the whole cache (an int8 cache is dequantized for
    it).
    """
    _check_supported(cfg)
    bits = _packed_decode(params["layers"])
    if bits is not None:
        return _decode_step_q8(params, cfg, token_embeds, cache, valid_len,
                               prompt_len, step, w8a8, bits)
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
        q, k, v = _split_qkv(cfg, dense(h, lp["qkv"], w8a8))
        q, k = apply_rope(q, k, cos, sin)
        # the new row, shared by every sample, then the whole layer read
        # back (an int8 cache dequantized, the new row included)
        _store_kv(cache, i, write_pos, k, v)
        k_read, v_read = _read_kv(cache, i, slice(None), K, q.dtype)
        out = attn_ops.mha(q, k_read, v_read, mask=mask)
        x = x + dense(out.reshape(B, 1, H * hd), lp["o"], w8a8)
        h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _ffn(h, lp, w8a8)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return lm_logits(params, cfg, x[:, 0], w8a8), cache


def decode_verify(params: dict, cfg: LLMConfig, token_embeds: torch.Tensor,
                  cache: KVCache, valid_len: torch.Tensor, prompt_len: int,
                  step0, w8a8: bool = False) -> Tuple[torch.Tensor, KVCache]:
    """K-slot speculative verify pass (JAX `decode_verify`).

    Runs K candidate tokens (the last accepted token and K-1 drafts)
    through the decoder in one pass, so every weight is read once for K
    tokens. Slot i of row b lives at cache row prompt_len + step0[b] + i,
    takes the RoPE position valid_len[b] + step0[b] + i and attends the
    prompt rows [0, valid_len[b]) and the generated rows
    [prompt_len, prompt_len + step0[b] + i]: slot-causal over the block,
    so its logits are those of the sequential decode_steps over the same
    tokens. Rows written for slots rejected later are overwritten by the
    next pass before any mask reaches them.

    step0 is an int (or 0-d tensor) shared by the batch (B = 1 and
    sessions), whose block must fit the cache, or a [B] tensor of per-row
    frontiers (batched speculation). There a row that rides along without
    room for the block writes its slots past the cache's end into the last
    row, which it has not committed: JAX moves the whole block back over
    committed rows instead, which makes the row diverge from plain greedy
    once it resumes on 1-slot passes (ROADMAP §3).

    Attention is the plain `mha` over layer i of the cache read back whole
    (an int8 cache dequantized, each slot's own row included), as the JAX
    package's is plain XLA; no kernel takes K tokens a row. w8a8 selects
    the serving branch of int8 and int4 packs (the Engine passes it for
    B * K <= 64 rows, JAX's quant_inference limit). token_embeds:
    [B, K, D]. Returns (logits [B, K, V] fp32, the cache written in place).
    """
    _check_supported(cfg)
    B, K, _ = token_embeds.shape
    M = cache.max_len
    H, Kh, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dev = token_embeds.device
    per_row = isinstance(step0, torch.Tensor) and step0.dim() == 1
    if per_row:
        step = step0.to(device=dev, dtype=torch.long)
        start = prompt_len + step
    else:
        step = torch.full((B,), int(step0), dtype=torch.long, device=dev)
        start = prompt_len + int(step0)
        if start + K > M:
            raise ValueError(f"verify rows [{start}, {start + K}) run past "
                             f"the cache's {M}")
    offs = torch.arange(K, device=dev)
    valid = valid_len.to(dev).long()
    positions = (valid + step)[:, None] + offs                  # [B, K]
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    ki = torch.arange(M, device=dev)[None, None, :]             # [1, 1, M]
    frontier = (prompt_len + positions - valid[:, None])[..., None]
    mask = (ki < valid[:, None, None]) | ((ki >= prompt_len)
                                          & (ki <= frontier))
    if cfg.sliding_window is not None:
        logical_k = torch.where(ki < prompt_len, ki,
                                valid[:, None, None] + (ki - prompt_len))
        mask = mask & (positions[..., None] - logical_k
                       < cfg.sliding_window)
    mask = mask[:, None]                                        # [B,1,K,M]
    x = token_embeds
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _split_qkv(cfg, dense(h, lp["qkv"], w8a8))
        q, k = apply_rope(q, k, cos, sin)
        _store_kv(cache, i, start, k, v)
        k_read, v_read = _read_kv(cache, i, slice(None), Kh, q.dtype)
        out = attn_ops.mha(q, k_read, v_read, mask=mask)
        x = x + dense(out.reshape(B, K, H * hd), lp["o"], w8a8)
        h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _ffn(h, lp, w8a8)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return lm_logits(params, cfg, x, w8a8), cache


def _decode_step_q8(params: dict, cfg: LLMConfig, token_embeds: torch.Tensor,
                    cache: KVCache, valid_len: torch.Tensor, prompt_len: int,
                    step: int, w8a8: bool, bits: int = 8
                    ) -> Tuple[torch.Tensor, KVCache]:
    """Decode step over int8 (bits 8) or folded int4 (bits 4) packs (JAX
    `_decode_step_q8`): the fused qkv and the o projection go through
    `matmul_q8_layered` (K4) or `matmul_q4_layered` (K6), attention over
    layer i of the stacked cache through `decode_attention_layered` (K3),
    seeded with the new k/v, and the SwiGLU FFN through `ffn_q8_layered`
    (K5) or `ffn_q4_layered` (K7). Each kernel reads layer i of the stacked
    weights or cache in place; the head is an int8 pack either way.

    JAX writes every layer's new row with one update after its layer scan;
    here each layer writes its row at write_pos in place before its
    attention and seeds K3 with the row as stored (an int8 row
    dequantized, as JAX seeds it). The two are equivalent because K3 never
    reads row write_pos (the current token attends to itself through the
    seeded state), and a layer reads only its own slice of the cache.
    """
    B = token_embeds.shape[0]
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    layers = params["layers"]
    positions = (valid_len + step)[:, None]
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    write_pos = prompt_len + step
    qkv_b = layers["qkv"].get("bias")
    o_b = layers["o"].get("bias")
    pack, wk = PACKS[bits]
    mm, ffn = ((dk.matmul_q8_layered, dk.ffn_q8_layered) if bits == 8
               else (dk.matmul_q4_layered, dk.ffn_q4_layered))
    big = {n: layers[n][pack] for n in _PACKED}
    x = token_embeds[:, 0]                                  # [B, D]
    for i in range(cfg.num_layers):
        h = rms_norm(x, layers["attn_norm"]["scale"][i], cfg.rms_norm_eps)
        qkv = mm(h, big["qkv"][wk], big["qkv"]["scale"], i)
        if qkv_b is not None:
            qkv = qkv + qkv_b[i].to(qkv.dtype)
        q, k, v = _split_qkv(cfg, qkv[:, None])
        q, k = apply_rope(q, k, cos, sin)
        _store_kv(cache, i, write_pos, k, v)
        k_row, v_row = (t[:, 0].contiguous() for t in _read_kv(
            cache, i, slice(write_pos, write_pos + 1), K, q.dtype))
        out = dk_attn.decode_attention_layered(
            q[:, 0], k_row, v_row, cache.k, cache.v, i, valid_len, write_pos,
            prompt_len, window=cfg.sliding_window, k_scale=cache.k_scale,
            v_scale=cache.v_scale)
        out = mm(out.reshape(B, H * hd), big["o"][wk], big["o"]["scale"], i)
        if o_b is not None:
            out = out + o_b[i].to(out.dtype)
        x = x + out
        h = rms_norm(x, layers["mlp_norm"]["scale"][i], cfg.rms_norm_eps)
        x = x + ffn(h, big["gate"][wk], big["gate"]["scale"], big["up"][wk],
                    big["up"]["scale"], big["down"][wk], big["down"]["scale"],
                    i)
    x = rms_norm(x, params["final_norm"]["scale"], cfg.rms_norm_eps)
    return lm_logits(params, cfg, x, w8a8), cache
