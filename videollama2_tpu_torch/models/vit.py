"""Vision feature towers: CLIP ViT-L/14-336 and SigLIP-SO400M/14-384 (port
of videollama2_tpu/models/vit.py).

The tower is frozen: it runs only the first `select_layer % (L + 1)` encoder
layers (23 of CLIP-L's 24, 26 of SigLIP's 27 for the default -2) and drops
CLS for CLIP's 'patch' features. The two variants differ only at the
embedding: CLIP prepends a CLS token and applies a pre-LayerNorm, SigLIP
adds a bias to its patch projection and has neither. Attention goes through
`ops.attention.attend(causal=False)`, which sends CLIP's 577 tokens (head dim
64) and SigLIP's 729 (head dim 72) to the encoder-attention kernel without
padding them.

Params (kernels [in, out], layers stacked on a leading L axis):
  patch_embed.kernel [P, P, 3, D] (HWIO) (+ .bias [D], SigLIP)
  pos_embed.weight [S, D]   post_ln {scale, bias} [D]
  CLIP only: cls_token.weight [D]   pre_ln {scale, bias} [D]
  layers: ln1/ln2 {scale, bias} [L, D]; qkv {kernel [L, D, 3D], bias [L, 3D]}
          o, fc1, fc2 {kernel, bias}

Under a mesh (parallel/sharding) each layer's fsdp shards are gathered
before it runs, and floating qkv / fc1 run column-parallel on the rank's
H / tensor heads and columns, o / fc2 row-parallel with an all-reduce over
`tensor`; the qkv bias (replicated, as JAX's rules leave it) is sliced to
the rank's heads.
"""

from __future__ import annotations

import torch

from ..core.config import VisionConfig

from ..ops import attention as attn_ops
from ..ops.conv import conv2d
from ..ops.layers import ACT2FN, dense, layer_norm, layer_params
from ..ops.quant import kernel_shapes
from ..parallel import sharding as sh


def param_shapes(cfg: VisionConfig, int8: bool = False) -> dict:
    """Shapes of the tower's params; with int8, the stacked linears are
    int8 packs (ops/quant.quantize_vision_params)."""
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    P = cfg.patch_size

    def ln(lead=(L,)):
        return {"scale": lead + (D,), "bias": lead + (D,)}

    def linear(d_in, d_out):
        return dict(kernel_shapes((L, d_in, d_out), 8 if int8 else None),
                    bias=(L, d_out))

    shapes = {
        "patch_embed": {"kernel": (P, P, 3, D)},
        "pos_embed": {"weight": (cfg.seq_len, D)},
        "post_ln": ln(()),
        "layers": {
            "ln1": ln(), "ln2": ln(),
            "qkv": linear(D, 3 * D),
            "o": linear(D, D),
            "fc1": linear(D, F_),
            "fc2": linear(F_, D),
        },
    }
    if cfg.variant == "clip":
        shapes["cls_token"] = {"weight": (D,)}
        shapes["pre_ln"] = ln(())
    else:
        shapes["patch_embed"]["bias"] = (D,)
    return shapes


def embeddings(params: dict, cfg: VisionConfig,
               pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, H, W, 3] -> [N, tokens, D]: the patch projection (plus
    its bias, SigLIP), CLS prepended (CLIP), position embeddings added."""
    P = cfg.patch_size
    x = conv2d(pixels, params["patch_embed"]["kernel"], stride=P)
    if "bias" in params["patch_embed"]:
        x = x + params["patch_embed"]["bias"].to(x.dtype)
    n, h, w, d = x.shape
    x = x.reshape(n, h * w, d)
    if cfg.use_cls_token:
        cls = params["cls_token"]["weight"].to(x.dtype).expand(n, 1, d)
        x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"]["weight"].to(x.dtype)[None]


def _encoder_layer(cfg: VisionConfig, x: torch.Tensor, lp: dict,
                   w8a8: bool, plan=None) -> torch.Tensor:
    N, S, _ = x.shape
    tp = 1 if plan is None else plan.tp
    H, hd = cfg.num_heads // tp, cfg.head_dim
    D = H * hd                                   # the rank's q/k/v width
    act = ACT2FN[cfg.hidden_act]
    if plan is not None:
        lp = plan.gather_layer(lp, "vision/layers")
        if tp > 1 and lp["qkv"].get("bias") is not None:
            cols = sh.qkv_columns(cfg.num_heads, cfg.num_heads, hd, tp,
                                  plan.mesh.index("tensor"))
            lp = dict(lp, qkv=dict(lp["qkv"], bias=lp["qkv"]["bias"][
                ..., cols.to(x.device)]))
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                   cfg.layer_norm_eps)
    qkv = dense(sh.enter(plan, h), lp["qkv"], w8a8)
    # column slices of the fused projection: strided views, which the
    # kernel reads in place
    q = qkv[..., :D].unflatten(-1, (H, hd))
    k = qkv[..., D:2 * D].unflatten(-1, (H, hd))
    v = qkv[..., 2 * D:].unflatten(-1, (H, hd))
    attn = attn_ops.attend(q, k, v, causal=False)
    x = x + sh.row_dense(attn.reshape(N, S, D), lp["o"], w8a8, plan)
    h = sh.enter(plan, layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                                  cfg.layer_norm_eps))
    return x + sh.row_dense(act(dense(h, lp["fc1"], w8a8)), lp["fc2"], w8a8,
                            plan)


def features(params: dict, cfg: VisionConfig, pixels: torch.Tensor,
             w8a8: bool = False) -> torch.Tensor:
    """hidden_states[select_layer] (CLS dropped for CLIP's 'patch'):
    [N, H, W, 3] -> [N, tokens, D]. w8a8 selects the serving branch of int8
    packs (ops/layers.dense)."""
    if cfg.select_feature not in ("patch", "cls_patch"):
        raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
    x = embeddings(params, cfg, pixels)
    if cfg.variant == "clip":
        x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                       cfg.layer_norm_eps)
    n_layers = cfg.select_layer % (cfg.num_layers + 1)
    plan = sh.plan_for(params["layers"], cfg.num_heads, cfg.num_heads,
                       seq=False)
    for i in range(n_layers):
        x = _encoder_layer(cfg, x, layer_params(params["layers"], i),
                           w8a8, plan)
    if cfg.select_feature == "patch" and cfg.use_cls_token:
        return x[:, 1:]
    return x
