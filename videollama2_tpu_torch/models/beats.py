"""BEATs audio encoder, VideoLLaMA2.1-AV's audio tower (port of
videollama2_tpu/models/beats.py).

  fbank [B, T, 128] -> 16x16 patch conv (no bias) -> LN -> 512->768 proj ->
  grouped conv positional embedding (kernel 128, 16 groups, GELU) -> LN ->
  12 post-LN layers with a gated relative position bias (WavLM: 320
  buckets, max distance 800; layer 0's bias table shared by every layer,
  gated per layer from the query) and deep-norm residual scaling
  alpha = (2 L) ** 0.25.

The tree keeps the JAX package's layouts, so checkpoint/from_jax copies it
leaf by leaf; the two convolutions permute their kernels where they run.
The attention is plain PyTorch (fp32 logits and softmax), as it is XLA in
the JAX package: its gated bias is not a form the encoder-attention kernel
takes.

Params (kernels [in, out], layers stacked on a leading L axis):
  patch_embed.kernel [16, 16, 1, E] (HWIO)   pre_ln {scale, bias} [E]
  post_extract_proj {kernel [E, D], bias}    enc_ln {scale, bias} [D]
  pos_conv {kernel [K, D/groups, D], bias [D]}   rel_embed [320, H]
  layers: q, v, o {kernel, bias}; k {kernel} (no bias);
          grep {kernel [L, D/H, 8], bias [L, 8]}; grep_a [L, H, 1, 1];
          ln1, ln2 {scale, bias}; fc1, fc2 {kernel, bias}
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..core.config import AudioConfig
from ..ops.conv import conv2d
from ..ops.layers import dense, gelu_exact, layer_norm, layer_params

NUM_BUCKETS = 320
MAX_DISTANCE = 800


def relative_position_bucket(relative_position: torch.Tensor,
                             num_buckets: int = NUM_BUCKETS,
                             max_distance: int = MAX_DISTANCE
                             ) -> torch.Tensor:
    """T5/WavLM bidirectional buckets of integer offsets (fp32 log, then
    truncation to int32, as in the JAX package)."""
    num_buckets //= 2
    ret = (relative_position > 0).to(torch.int32) * num_buckets
    n = torch.abs(relative_position).to(torch.int32)
    max_exact = num_buckets // 2
    is_small = n < max_exact
    val_if_large = max_exact + (
        torch.log(n.float() / max_exact + 1e-9)
        / math.log(max_distance / max_exact)
        * (num_buckets - max_exact)).to(torch.int32)
    val_if_large = torch.clamp(val_if_large, max=num_buckets - 1)
    return ret + torch.where(is_small, n, val_if_large)


def compute_position_bias(rel_embed: torch.Tensor, seq_len: int,
                          num_buckets: int = NUM_BUCKETS,
                          max_distance: int = MAX_DISTANCE) -> torch.Tensor:
    """rel_embed: [num_buckets, H] -> bias [H, S, S]."""
    pos = torch.arange(seq_len, dtype=torch.int32, device=rel_embed.device)
    buckets = relative_position_bucket(pos[None, :] - pos[:, None],
                                       num_buckets, max_distance)
    return rel_embed[buckets.long()].permute(2, 0, 1)  # [S, S, H] -> [H, S, S]


def param_shapes(cfg: AudioConfig) -> dict:
    L, D, F_ = cfg.num_layers, cfg.encoder_dim, cfg.intermediate_size
    H, E = cfg.num_heads, cfg.embed_dim

    def ln(lead=()):
        return {"scale": lead + (D,), "bias": lead + (D,)}

    def linear(d_in, d_out):
        return {"kernel": (L, d_in, d_out), "bias": (L, d_out)}

    return {
        "patch_embed": {"kernel": (16, 16, 1, E)},
        "pre_ln": {"scale": (E,), "bias": (E,)},
        "post_extract_proj": {"kernel": (E, D), "bias": (D,)},
        "pos_conv": {"kernel": (cfg.conv_pos, D // cfg.conv_pos_groups, D),
                     "bias": (D,)},
        "enc_ln": ln(),
        "rel_embed": (NUM_BUCKETS, H),
        "layers": {
            "q": linear(D, D),
            "k": {"kernel": (L, D, D)},        # BEATs k_proj: no bias
            "v": linear(D, D),
            "o": linear(D, D),
            # grep_linear is shared by the heads: Linear(head_dim, 8)
            "grep": {"kernel": (L, D // H, 8), "bias": (L, 8)},
            "grep_a": (L, H, 1, 1),
            "ln1": ln((L,)), "ln2": ln((L,)),
            "fc1": linear(D, F_),
            "fc2": linear(F_, D),
        },
    }


def _attention(cfg: AudioConfig, x: torch.Tensor, lp: dict,
               pos_bias: torch.Tensor) -> torch.Tensor:
    """Attention with the gated relative position bias. x: [B, S, D];
    pos_bias: [H, S, S] fp32."""
    B, S, D = x.shape
    H = cfg.num_heads
    hd = D // H
    q = dense(x, lp["q"]).reshape(B, S, H, hd)
    k = torch.matmul(x, lp["k"]["kernel"].to(x.dtype)).reshape(B, S, H, hd)
    v = dense(x, lp["v"]).reshape(B, S, H, hd)

    # the gate from the query: grep -> [.., 2, 4] summed -> sigmoid
    g = torch.matmul(q, lp["grep"]["kernel"].to(x.dtype))
    g = g + lp["grep"]["bias"].to(x.dtype)
    gates = torch.sigmoid(g.reshape(B, S, H, 2, 4).sum(-1))   # [B, S, H, 2]
    gate_a, gate_b = gates[..., 0], gates[..., 1]
    grep_a = lp["grep_a"].to(x.dtype)[:, 0, 0]                 # [H]
    gate_a_1 = gate_a * (gate_b * grep_a - 1.0) + 2.0          # [B, S, H]
    bias = gate_a_1.transpose(1, 2)[..., None] * pos_bias[None]

    # fp32 logits of the (bf16) q and k, as JAX's preferred_element_type
    qh = q.transpose(1, 2).float()
    kh = k.transpose(1, 2).float()
    logits = torch.matmul(qh, kh.transpose(-1, -2)) * hd ** -0.5
    probs = torch.softmax(logits + bias.float(), dim=-1)
    out = torch.matmul(probs.to(v.dtype), v.transpose(1, 2))  # [B, H, S, hd]
    return dense(out.transpose(1, 2).reshape(B, S, D), lp["o"])


def forward(params: dict, cfg: AudioConfig,
            fbank_feats: torch.Tensor) -> torch.Tensor:
    """fbank_feats: [B, T, 128] normalized features -> [B, tokens, D]."""
    B = fbank_feats.shape[0]
    x = conv2d(fbank_feats[..., None], params["patch_embed"]["kernel"],
               stride=16)                               # [B, T/16, 8, E]
    x = x.reshape(B, x.shape[1] * x.shape[2], x.shape[3])
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    x = dense(x, params["post_extract_proj"])

    # conv positional embedding: kernel [K, D/g, D] -> torch's [D, D/g, K];
    # with an even kernel the padded output has one step more, dropped
    pc = params["pos_conv"]
    S = x.shape[1]
    pos = F.conv1d(x.transpose(1, 2),
                   pc["kernel"].to(x.dtype).permute(2, 1, 0),
                   padding=cfg.conv_pos // 2, groups=cfg.conv_pos_groups)
    pos = pos.transpose(1, 2) + pc["bias"].to(x.dtype)
    x = x + gelu_exact(pos[:, :S])
    # post-norm backbone: the encoder's LN runs on the input of the stack
    x = layer_norm(x, params["enc_ln"]["scale"], params["enc_ln"]["bias"],
                   cfg.layer_norm_eps)

    pos_bias = compute_position_bias(params["rel_embed"].float(), S)
    alpha = (2 * cfg.num_layers) ** 0.25 if cfg.deep_norm else 1.0
    for i in range(cfg.num_layers):
        lp = layer_params(params["layers"], i)
        attn = _attention(cfg, x, lp, pos_bias)
        x = layer_norm(x * alpha + attn, lp["ln1"]["scale"],
                       lp["ln1"]["bias"], cfg.layer_norm_eps)
        h = dense(gelu_exact(dense(x, lp["fc1"])), lp["fc2"])
        x = layer_norm(x * alpha + h, lp["ln2"]["scale"], lp["ln2"]["bias"],
                       cfg.layer_norm_eps)
    return x
