"""Causal decoder (port of videollama2_tpu/models/llm.py).

Mistral/Llama/Qwen2-style dense decoders and the Mixtral sparse-MoE decoder,
with GQA, RoPE in the rotate-half layout and RMSNorm; floating, int8-packed
or folded-int4-packed weights (MoE: floating only, see `check_supported`);
a bf16 or int8 KV cache; prefill, one-token decode and the K-slot
speculative verify pass.

Params (kernels [in, out], layers stacked on a leading L axis):
  embed.weight [V, D]   final_norm.scale [D]
  lm_head.kernel [D, V] (absent with tied embeddings: the head is embed.T)
  layers: attn_norm.scale/mlp_norm.scale [L, D]
          qkv.kernel [L, D, (H + 2 Hkv) hd] (+ .bias for Qwen2)
          o.kernel [L, H hd, D]; gate/up.kernel [L, D, F];
          down.kernel [L, F, D]
          MoE: router.kernel [L, D, E]; gate/up.kernel [L, E, D, F];
               down.kernel [L, E, F, D]
With int8 weights every `kernel` above (the head's included) is a
`kernel_q8` pack {q int8 [.., in, out], scale [.., 1, out]} (ops/quant);
with int4 weights the layers' kernels are `kernel_q4` packs {q4 int8
[.., in/2, out], scale [.., 1, out]} and the head stays a `kernel_q8` pack.
An int8 embedding is embed.weight_q8 {q int8 [V, D], scale [V, 1]}.
Any projection entry may carry a LoRA adapter ("lora", train/lora.py),
which dense applies; decode then takes the generic path, since the
layered kernels read the base packs alone.

Under a mesh (parallel/sharding: the entry points read the current mesh
and pass its `Plan` down) the tree holds this rank's shards: each layer's
fsdp shards are gathered just before it runs (ZeRO-3), qkv and gate/up run
column-parallel on the rank's heads and columns, o and down row-parallel
followed by an all-reduce over `tensor`, the Mixtral FFN on the rank's
experts summed over `expert`, and under sequence parallelism each rank
runs its tokens, attention on all tokens and its heads (Ulysses). The
head is vocab-parallel: local logits all-gathered over `tensor`.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..core.config import LLMConfig
from ..ops import attention as attn_ops
from ..ops import decode_attention as dk_attn
from ..ops import decode_matmul as dk
from ..ops.layers import (apply_rope, dense, layer_params, rms_norm,
                          rope_table, unbind_layers)
from ..ops.quant import PACKS, kernel_shapes
from ..parallel import sharding as sh


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


def check_supported(cfg: LLMConfig, bits: Optional[int] = None,
                     layers: Optional[dict] = None) -> None:
    """MoE runs on floating expert kernels only: with weight bits 8 or 4,
    or int8 / int4 packs in `layers`, an MoE config raises. The JAX package
    packs the expert stacks (ops/quant.py:110-119) but its MoE FFN reads
    their floating `kernel` (models/llm.py:248-251), so it has no quantized
    MoE to match."""
    if not cfg.is_moe:
        return
    if bits is not None or (layers is not None and any(
            pack in layers.get(n, {}) for n in ("gate", "up", "down")
            for pack, _ in PACKS.values())):
        raise NotImplementedError(
            "MoE decoders run on floating expert kernels only: int8 and "
            "int4 packs of the Mixtral experts are not supported (the JAX "
            "package has no quantized MoE)")


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
    check_supported(cfg, bits)
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
        },
        "final_norm": {"scale": (D,)},
    }
    layers = shapes["layers"]
    if cfg.is_moe:
        E = cfg.num_experts
        layers.update(router={"kernel": (L, D, E)},
                      gate={"kernel": (L, E, D, F_)},
                      up={"kernel": (L, E, D, F_)},
                      down={"kernel": (L, E, F_, D)})
    else:
        layers.update(gate=kernel_shapes((L, D, F_), bits),
                      up=kernel_shapes((L, D, F_), bits),
                      down=kernel_shapes((L, F_, D), bits))
    if not cfg.tie_word_embeddings:
        shapes["lm_head"] = kernel_shapes((D, V), bits and 8)
    return shapes


def embed_tokens(params: dict, token_ids: torch.Tensor,
                 dtype=None) -> torch.Tensor:
    """Embedding rows of token_ids in dtype. An int8 table ("weight_q8",
    per-row scales) gathers only the looked-up int8 rows and their scales
    and multiplies them in fp32 before the cast (JAX `embed_tokens`; fp32
    when dtype is None)."""
    emb = sh.gather_tree(sh.current_mesh(), params["embed"], "llm/embed")
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
    dequantized in fp32 first) on the floating branch. Under a mesh a
    floating head is vocab-parallel: the rank's [D, V / tensor] columns
    (fsdp shards gathered) give its logits, all-gathered over `tensor`
    into the whole vocabulary on every rank (a tied head is the gathered
    embedding)."""
    mesh = sh.current_mesh()
    if cfg.tie_word_embeddings:
        emb = sh.gather_tree(mesh, params["embed"], "llm/embed")
        if "weight_q8" in emb:
            pack = emb["weight_q8"]
            kernel = (pack["q"].float() * pack["scale"].float()).T
        else:
            kernel = emb["weight"].T
    else:
        head = params["lm_head"]
        if "kernel_q8" in head:
            return dense(hidden, head, w8a8).float()
        head = sh.gather_tree(mesh, head, "llm/lm_head", keep=("tensor",))
        kernel = head["kernel"]
        if mesh is not None and mesh.shape["tensor"] > 1:
            x = sh.copy_to(hidden, mesh, ("tensor",))
            out = torch.matmul(x.float(), kernel.to(hidden.dtype).float())
            return sh.gather(out, out.dim() - 1, mesh, ("tensor",),
                             {"tensor": False})
    return torch.matmul(hidden.float(), kernel.to(hidden.dtype).float())


def _local_cfg(cfg: LLMConfig, plan: Optional[sh.Plan]) -> LLMConfig:
    """cfg with the head counts of one tensor rank (plan.tp > 1)."""
    if plan is None or plan.tp == 1:
        return cfg
    return dataclasses.replace(
        cfg, num_heads=cfg.num_heads // plan.tp,
        num_kv_heads=sh.local_kv_heads(cfg.num_heads, cfg.num_kv_heads,
                                       plan.tp))


def plan_and_config(params: dict, cfg: LLMConfig):
    """(Plan on the current mesh or None, cfg with the rank's heads)."""
    plan = sh.plan_for(params["layers"], cfg.num_heads, cfg.num_kv_heads,
                       cfg.is_moe)
    return plan, _local_cfg(cfg, plan)


def _split_qkv(cfg: LLMConfig, qkv: torch.Tensor):
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = qkv[..., :H * hd].unflatten(-1, (H, hd))
    k = qkv[..., H * hd:(H + K) * hd].unflatten(-1, (K, hd))
    v = qkv[..., (H + K) * hd:].unflatten(-1, (K, hd))
    return q, k, v


def _moe_router(x: torch.Tensor, lp: dict, cfg: LLMConfig):
    """Top-k routing (JAX `_moe_router`, HF MixtralSparseMoeBlock): fp32
    logits and softmax over all experts, the k largest kept and
    renormalized. Ties go to the lower expert index, as in jax.lax.top_k:
    a stable descending sort keeps equal weights in index order, which
    torch.topk does not promise."""
    probs = torch.softmax(torch.matmul(x.float(),
                                       lp["router"]["kernel"].float()), -1)
    topw, topi = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.num_experts_per_tok
    topw, topi = topw[..., :k], topi[..., :k]
    return topw / topw.sum(-1, keepdim=True), topi


def _ffn_moe(x: torch.Tensor, lp: dict, cfg: LLMConfig,
             plan: Optional[sh.Plan] = None) -> torch.Tensor:
    """Mixtral sparse-MoE FFN (JAX `_ffn_moe`). "dense": every expert
    computes every token and the unselected ones weigh 0 (HF's exact
    semantics); "gather": capacity dispatch (`_ffn_moe_gather`); "auto":
    gather from 64 tokens (B x S), dense below. The dense expert products
    run one expert at a time, each expert's output weighted and summed in
    fp32 and the sum rounded once to x's dtype, which bounds the
    transients to one expert's [B, S, F] (JAX's einsums hold all E).

    Under a plan a rank runs its E / expert experts (on its F / tensor
    columns) over every token: the router runs whole on each rank, x and
    the routing weights enter through Megatron's f and the fp32 partial sum
    is all-reduced over tensor and expert before the rounding."""
    mode = cfg.moe_dispatch
    if mode == "auto":
        mode = "gather" if x.shape[0] * x.shape[1] >= 64 else "dense"
    if mode == "gather":
        return _ffn_moe_gather(x, lp, cfg, plan)
    topw, topi = _moe_router(x, lp, cfg)
    weights = torch.zeros(x.shape[:-1] + (cfg.num_experts,),
                          dtype=topw.dtype, device=x.device)
    weights = weights.scatter_add(-1, topi, topw).to(x.dtype)  # [..., E]
    xe, weights = sh.enter(plan, x, True), sh.enter(plan, weights, True)
    e0 = 0 if plan is None else plan.first_expert(cfg.num_experts)
    out = None
    for j in range(lp["gate"]["kernel"].shape[0]):
        e = e0 + j
        g = torch.matmul(xe, lp["gate"]["kernel"][j].to(x.dtype))
        u = torch.matmul(xe, lp["up"]["kernel"][j].to(x.dtype))
        y = torch.matmul(F.silu(g) * u, lp["down"]["kernel"][j].to(x.dtype))
        y = y.float() * weights[..., e:e + 1].float()
        out = y if out is None else out + y
    if plan is not None and plan.parallel(True):
        out = plan.exit(out, True)
    return out.to(x.dtype)


def _capacity_slots(flat_e: torch.Tensor, N: int, cfg: LLMConfig):
    """(slot, keep, C) of the gather dispatch's pairs, flat_e [N * k]
    their experts in token-major order: C the capacity an expert (JAX's
    expression as it is, its float floor included), each pair's arrival
    rank within its expert clamped to C - 1 (its slot) and whether that
    rank is below C (kept)."""
    E = cfg.num_experts
    C = min(N, max(1, int(-(-N * cfg.num_experts_per_tok
                            * cfg.moe_capacity_factor // E))))
    oh = F.one_hot(flat_e, E)                              # [N * k, E]
    pos_in_e = (torch.cumsum(oh, 0) * oh).amax(1) - 1      # arrival rank
    return pos_in_e.clamp(0, C - 1), pos_in_e < C, C


def _ffn_moe_gather(x: torch.Tensor, lp: dict, cfg: LLMConfig,
                    plan: Optional[sh.Plan] = None) -> torch.Tensor:
    """Capacity-based top-k dispatch (JAX `_ffn_moe_gather`): the N x k
    (token, expert) pairs in token-major order take arrival ranks within
    their expert; those ranked C or later are dropped; the kept tokens are
    packed into [E, C, D], each expert's SwiGLU runs over its block (one
    batched product a weight), and the outputs are added back to their
    tokens weighted by the router. Under a plan with expert or tensor
    degrees above one a rank runs its experts' blocks, adds the pairs
    routed to them, and the sum is all-reduced as in `_ffn_moe`."""
    B, S, D = x.shape
    E, k = cfg.num_experts, cfg.num_experts_per_tok
    N = B * S
    xt = x.reshape(N, D)
    topw, topi = _moe_router(xt, lp, cfg)                  # [N, k]
    flat_e = topi.reshape(-1)                              # [N * k]
    flat_w = topw.reshape(-1)
    flat_t = torch.arange(N, device=x.device).repeat_interleave(k)
    slot, keep, C = _capacity_slots(flat_e, N, cfg)
    sharded = plan is not None and plan.parallel(True)
    if sharded:
        xt, flat_w = plan.enter(xt, True), plan.enter(flat_w, True)
    contrib = torch.where(keep[:, None], xt[flat_t],
                          torch.zeros((), dtype=x.dtype, device=x.device))
    buf = x.new_zeros((E, C, D)).index_put_((flat_e, slot), contrib,
                                            accumulate=True)
    if sharded:
        El = lp["gate"]["kernel"].shape[0]
        e0 = plan.first_expert(E)
        buf = buf[e0:e0 + El]
        keep = keep & (flat_e >= e0) & (flat_e < e0 + El)
        flat_e = (flat_e - e0).clamp(0, El - 1)
    g = torch.matmul(buf, lp["gate"]["kernel"].to(x.dtype))
    u = torch.matmul(buf, lp["up"]["kernel"].to(x.dtype))
    y = torch.matmul(F.silu(g) * u, lp["down"]["kernel"].to(x.dtype))
    pair_out = y[flat_e, slot] * (flat_w * keep).to(x.dtype)[:, None]
    out = x.new_zeros((N, D)).index_add_(0, flat_t, pair_out)
    if sharded:
        out = plan.exit(out, True)
    return out.reshape(B, S, D)


def _ffn(cfg: LLMConfig, x: torch.Tensor, lp: dict,
         w8a8: bool, plan: Optional[sh.Plan] = None) -> torch.Tensor:
    """The layer's FFN: the MoE FFN where cfg.is_moe, else the SwiGLU
    (column-parallel gate/up, row-parallel down under a plan)."""
    if cfg.is_moe:
        return _ffn_moe(x, lp, cfg, plan)
    x = sh.enter(plan, x)
    return sh.row_dense(F.silu(dense(x, lp["gate"], w8a8))
                        * dense(x, lp["up"], w8a8), lp["down"], w8a8, plan)


def _layer(cfg: LLMConfig, x: torch.Tensor, lp: dict, cos: torch.Tensor,
           sin: torch.Tensor, valid_len: torch.Tensor,
           cache: Optional[KVCache], i: int, w8a8: bool,
           plan: Optional[sh.Plan] = None) -> torch.Tensor:
    """One decoder layer; cfg carries the rank's head counts under a
    plan, whose fsdp gather runs here, so a checkpointed layer gathers
    again in the backward."""
    if plan is not None:
        lp = plan.gather_layer(lp, "llm/layers")
    B, S, _ = x.shape
    h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
    q, k, v = _split_qkv(cfg, dense(sh.enter(plan, h), lp["qkv"], w8a8))
    q, k = apply_rope(q, k, cos, sin)
    if cache is not None:
        _store_kv(cache, i, 0, k, v)
    if plan is not None and plan.sp > 1:
        q, k, v = (sh.sp_shard_heads(t, plan.mesh) for t in (q, k, v))
    out = attn_ops.attend(q, k, v, valid_len=valid_len, causal=True,
                          window=cfg.sliding_window)
    if plan is not None and plan.sp > 1:
        out = sh.sp_shard_tokens(out, plan.mesh)
    x = x + sh.row_dense(out.reshape(B, S, -1), lp["o"], w8a8, plan)
    h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
    return x + _ffn(cfg, h, lp, w8a8, plan)


# the products of activations by weights: a matmul of a [..., in] tensor by
# an [in, out] kernel reaches the dispatcher as one of these, after the
# reshape that folds its leading dims
DOT_OPS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def dots_saveable(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    """The selective-checkpoint policy of remat="dots" (JAX's
    dots_with_no_batch_dims_saveable): the outputs of the products without
    batch dims (the projections, the FFN and LoRA's products) are saved;
    everything else (norms, rope, SiLU, attention, products with batch
    dims) runs again in the backward."""
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat_kwargs(remat) -> dict:
    """torch.utils.checkpoint's arguments for a remat setting (True or
    "dots"); ValueError for any other string."""
    if remat == "dots":
        return {"context_fn": functools.partial(
            create_selective_checkpoint_contexts, dots_saveable)}
    if isinstance(remat, str):
        raise ValueError(f"unknown remat policy {remat!r}: False, True or "
                         f"'dots'")
    return {}


def forward(params: dict, cfg: LLMConfig, embeds: torch.Tensor,
            positions: torch.Tensor, valid_len: torch.Tensor,
            cache: Optional[KVCache] = None,
            w8a8: bool = False,
            remat: Union[bool, str] = False) -> torch.Tensor:
    """Full-sequence forward (prefill and training). embeds [B, S, D],
    positions [B, S], valid_len [B] int32. Writes each layer's k/v into
    cache rows [0, S) in place when a cache is given (an int8 cache stores
    the rows quantized; attention itself uses the exact k/v). w8a8 selects
    the serving branch of int8 packs. remat (training, no cache) wraps each
    layer in torch.utils.checkpoint, as the JAX package wraps its layer
    body in jax.checkpoint: with True only each layer's input is kept, and
    the layer runs again in the backward; with "dots" the layer's products
    with the weights are kept too (`dots_saveable`) and the rest runs
    again. Returns the final-normed hidden [B, S, D].
    Under sequence parallelism (parallel/sharding.sequence_parallel) each
    rank takes its S / seq tokens of embeds and positions and returns its
    tokens' hidden states [B, S / seq, D].
    """
    check_supported(cfg, layers=params["layers"])
    remat_kw = remat_kwargs(remat)
    if remat and cache is not None:
        raise ValueError("remat is for training: it takes no cache")
    plan, lcfg = plan_and_config(params, cfg)
    if plan is not None and plan.sp > 1:
        if cache is not None:
            raise ValueError("sequence parallelism is for training: it "
                             "takes no cache")
        embeds = sh.sp_shard_seq(embeds, plan.mesh)
        positions = sh.sp_shard_seq(positions, plan.mesh)
    cos, sin = rope_table(positions, cfg.head_dim, cfg.rope_theta)
    x = embeds
    layers = unbind_layers(params["layers"], cfg.num_layers)
    for i, lp in enumerate(layers):
        if remat:
            x = checkpoint(_layer, lcfg, x, lp, cos, sin, valid_len, None,
                           i, w8a8, plan, use_reentrant=False, **remat_kw)
        else:
            x = _layer(lcfg, x, lp, cos, sin, valid_len, cache, i, w8a8,
                       plan)
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


def _layer_i(params: dict, plan: Optional[sh.Plan], i: int) -> dict:
    """Layer i's params, its fsdp shards gathered under a plan."""
    lp = layer_params(params["layers"], i)
    return lp if plan is None else plan.gather_layer(lp, "llm/layers")


def _packed_decode(layers: dict) -> Optional[int]:
    """The weight bits of the layered decode kernels: 8 when every
    projection is an int8 pack, 4 when every one is a folded int4 pack,
    without LoRA (the JAX package's routing); None otherwise. MoE never
    takes them (decode_step; JAX models/llm.py:465)."""
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
    check_supported(cfg, layers=params["layers"])
    bits = None if cfg.is_moe else _packed_decode(params["layers"])
    if bits is not None:
        return _decode_step_q8(params, cfg, token_embeds, cache, valid_len,
                               prompt_len, step, w8a8, bits)
    plan, cfg = plan_and_config(params, cfg)
    B = token_embeds.shape[0]
    M = cache.max_len
    H, K, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    positions = (valid_len + step)[:, None]
    cos, sin = rope_table(positions, hd, cfg.rope_theta)
    write_pos = prompt_len + step
    mask = decode_mask(cfg, valid_len, prompt_len, step, M)
    x = token_embeds
    for i in range(cfg.num_layers):
        lp = _layer_i(params, plan, i)
        h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _split_qkv(cfg, dense(sh.enter(plan, h), lp["qkv"], w8a8))
        q, k = apply_rope(q, k, cos, sin)
        # the new row, shared by every sample, then the whole layer read
        # back (an int8 cache dequantized, the new row included)
        _store_kv(cache, i, write_pos, k, v)
        k_read, v_read = _read_kv(cache, i, slice(None), K, q.dtype)
        out = attn_ops.mha(q, k_read, v_read, mask=mask)
        x = x + sh.row_dense(out.reshape(B, 1, H * hd), lp["o"], w8a8, plan)
        h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _ffn(cfg, h, lp, w8a8, plan)
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
    check_supported(cfg, layers=params["layers"])
    plan, cfg = plan_and_config(params, cfg)
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
        lp = _layer_i(params, plan, i)
        h = rms_norm(x, lp["attn_norm"]["scale"], cfg.rms_norm_eps)
        q, k, v = _split_qkv(cfg, dense(sh.enter(plan, h), lp["qkv"], w8a8))
        q, k = apply_rope(q, k, cos, sin)
        _store_kv(cache, i, start, k, v)
        k_read, v_read = _read_kv(cache, i, slice(None), Kh, q.dtype)
        out = attn_ops.mha(q, k_read, v_read, mask=mask)
        x = x + sh.row_dense(out.reshape(B, K, H * hd), lp["o"], w8a8, plan)
        h = rms_norm(x, lp["mlp_norm"]["scale"], cfg.rms_norm_eps)
        x = x + _ffn(cfg, h, lp, w8a8, plan)
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
