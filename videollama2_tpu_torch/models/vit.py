"""CLIP ViT-L/14-336 feature tower (port of the CLIP path of
videollama2_tpu/models/vit.py).

The tower is frozen: it runs only the first `select_layer % (L + 1)` encoder
layers (23 of CLIP-L's 24 for the default -2) and drops CLS for 'patch'
features. Attention goes through `ops.attention.attend(causal=False)`, which
sends CLIP's 577 tokens to the encoder-attention kernel without padding them.

Params (kernels [in, out], layers stacked on a leading L axis):
  patch_embed.kernel [P, P, 3, D] (HWIO)   pos_embed.weight [S, D]
  cls_token.weight [D]   pre_ln/post_ln {scale, bias} [D]
  layers: ln1/ln2 {scale, bias} [L, D]; qkv {kernel [L, D, 3D], bias [L, 3D]}
          o, fc1, fc2 {kernel, bias}
"""

from __future__ import annotations

import torch

from ..core.config import VisionConfig

from ..ops import attention as attn_ops
from ..ops.conv import conv2d
from ..ops.layers import ACT2FN, dense, layer_norm, layer_params
from ..ops.quant import kernel_shapes


def param_shapes(cfg: VisionConfig, int8: bool = False) -> dict:
    """Shapes of the tower's params; with int8, the stacked linears are
    int8 packs (ops/quant.quantize_vision_params)."""
    L, D, F_ = cfg.num_layers, cfg.hidden_size, cfg.intermediate_size
    P = cfg.patch_size
    if cfg.variant != "clip":
        raise NotImplementedError("only the CLIP tower is ported")

    def ln(lead=(L,)):
        return {"scale": lead + (D,), "bias": lead + (D,)}

    def linear(d_in, d_out):
        return dict(kernel_shapes((L, d_in, d_out), 8 if int8 else None),
                    bias=(L, d_out))

    return {
        "patch_embed": {"kernel": (P, P, 3, D)},
        "pos_embed": {"weight": (cfg.seq_len, D)},
        "cls_token": {"weight": (D,)},
        "pre_ln": ln(()),
        "post_ln": ln(()),
        "layers": {
            "ln1": ln(), "ln2": ln(),
            "qkv": linear(D, 3 * D),
            "o": linear(D, D),
            "fc1": linear(D, F_),
            "fc2": linear(F_, D),
        },
    }


def embeddings(params: dict, cfg: VisionConfig,
               pixels: torch.Tensor) -> torch.Tensor:
    """pixels [N, H, W, 3] -> [N, 1 + patches, D] (CLS + patches + pos)."""
    P = cfg.patch_size
    x = conv2d(pixels, params["patch_embed"]["kernel"], stride=P)
    n, h, w, d = x.shape
    x = x.reshape(n, h * w, d)
    cls = params["cls_token"]["weight"].to(x.dtype).expand(n, 1, d)
    x = torch.cat([cls, x], dim=1)
    return x + params["pos_embed"]["weight"].to(x.dtype)[None]


def _encoder_layer(cfg: VisionConfig, x: torch.Tensor, lp: dict,
                   w8a8: bool) -> torch.Tensor:
    N, S, D = x.shape
    H, hd = cfg.num_heads, cfg.head_dim
    act = ACT2FN[cfg.hidden_act]
    h = layer_norm(x, lp["ln1"]["scale"], lp["ln1"]["bias"],
                   cfg.layer_norm_eps)
    qkv = dense(h, lp["qkv"], w8a8)
    # column slices of the fused projection: strided views, which the
    # kernel reads in place
    q = qkv[..., :D].unflatten(-1, (H, hd))
    k = qkv[..., D:2 * D].unflatten(-1, (H, hd))
    v = qkv[..., 2 * D:].unflatten(-1, (H, hd))
    attn = attn_ops.attend(q, k, v, causal=False)
    x = x + dense(attn.reshape(N, S, D), lp["o"], w8a8)
    h = layer_norm(x, lp["ln2"]["scale"], lp["ln2"]["bias"],
                   cfg.layer_norm_eps)
    return x + dense(act(dense(h, lp["fc1"], w8a8)), lp["fc2"], w8a8)


def features(params: dict, cfg: VisionConfig, pixels: torch.Tensor,
             w8a8: bool = False) -> torch.Tensor:
    """hidden_states[select_layer] without CLS: [N, H, W, 3] -> [N, P, D].
    w8a8 selects the serving branch of int8 packs (ops/layers.dense)."""
    x = embeddings(params, cfg, pixels)
    x = layer_norm(x, params["pre_ln"]["scale"], params["pre_ln"]["bias"],
                   cfg.layer_norm_eps)
    n_layers = cfg.select_layer % (cfg.num_layers + 1)
    for i in range(n_layers):
        x = _encoder_layer(cfg, x, layer_params(params["layers"], i),
                           w8a8)
    if cfg.select_feature == "patch":
        return x[:, 1:]
    if cfg.select_feature == "cls_patch":
        return x
    raise ValueError(f"Unexpected select feature: {cfg.select_feature}")
