"""The connectors (projectors) of videollama2_tpu/models/connector.py,
all eight types of the reference's projector.py:

  linear, mlp{N}x_gelu  fc1 .. fcN at the top level, exact GELU between
                        them, on features the caller mean-pooled over time
                        ([B, N, D_vision] -> [B, N, hidden])
  identity              no params: [B, T, N, D_vision] -> [B, T*N, D_vision]
  stc_connector, stc_connector_v35, spatial_conv
                        RegStage of SE-bottlenecks (LayerNorm2d eps 1e-6,
                        SiLU) -> Conv3d downsampler (kernel = stride =
                        downsample; padding 0 for v35, else 1) + SiLU ->
                        RegStage -> readout MLP with exact GELU
  stp_connector, spatial_pool
                        the same with AvgPool3d(downsample) in place of the
                        Conv3d, and no sampler params

cfg.depth == 0 drops both RegStages. Channels-last throughout, as in the
JAX package. Under a mesh the connector's shards (1x1 convs, sampler,
readout: parallel/sharding's rules; the top-level fc* have none and stay
replicated) are all gathered before it runs, and it runs whole on each
rank.
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F

from ..core.config import ConnectorConfig

from ..ops.conv import avg_pool3d, conv2d, conv3d
from ..ops.layers import gelu_exact, layer_norm
from ..parallel import sharding as sh

LN2D_EPS = 1e-6  # timm LayerNorm2d default
MLP_RE = re.compile(r"^mlp(\d+)x_gelu$")
# the RegStage types by downsampler: a Conv3d sampler or an AvgPool3d
CONV_TYPES = ("stc_connector", "stc_connector_v35", "spatial_conv")
POOL_TYPES = ("stp_connector", "spatial_pool")


def kind(projector_type: str) -> str:
    """"linear", "mlp", "identity", "conv" or "pool": the family of one of
    the eight types; ValueError for any other name."""
    if projector_type in ("linear", "identity"):
        return projector_type
    if MLP_RE.match(projector_type):
        return "mlp"
    if projector_type in CONV_TYPES:
        return "conv"
    if projector_type in POOL_TYPES:
        return "pool"
    raise ValueError(f"Unknown projector type: {projector_type}")


def _cna_shapes(cin, cout, k, depthwise=False):
    return {"conv": {"kernel": (k, k, 1 if depthwise else cin, cout)},
            "norm": {"scale": (cout,), "bias": (cout,)}}


def _block_shapes(cin, cout):
    rd = int(round(cin * 0.25))
    block = {
        "conv1": _cna_shapes(cin, cout, 1),
        "conv2": _cna_shapes(cout, cout, 3, depthwise=True),
        "se": {"fc1": {"kernel": (1, 1, cout, rd), "bias": (rd,)},
               "fc2": {"kernel": (1, 1, rd, cout), "bias": (cout,)}},
        "conv3": _cna_shapes(cout, cout, 1),
    }
    if cin != cout:
        block["downsample"] = _cna_shapes(cin, cout, 1)
    return block


def _mlp_shapes(depth: int, d_in: int, d_out: int) -> dict:
    return {f"fc{d + 1}": {"kernel": (d_in if d == 0 else d_out, d_out),
                           "bias": (d_out,)} for d in range(depth)}


def param_shapes(cfg: ConnectorConfig) -> dict:
    k = kind(cfg.projector_type)
    C = cfg.hidden_size
    if k == "identity":
        return {}
    if k in ("linear", "mlp"):
        depth = 1 if k == "linear" else int(
            MLP_RE.match(cfg.projector_type).group(1))
        return _mlp_shapes(depth, cfg.mm_hidden_size, C)
    out = {}
    if cfg.depth != 0:
        out["s1"] = {f"b{i + 1}": _block_shapes(
            cfg.mm_hidden_size if i == 0 else C, C) for i in range(cfg.depth)}
        out["s2"] = {f"b{i + 1}": _block_shapes(C, C)
                     for i in range(cfg.depth)}
    if k == "conv":
        out["sampler"] = {"kernel": tuple(cfg.downsample) + (C, C),
                          "bias": (C,)}
    out["readout"] = _mlp_shapes(cfg.mlp_depth, C, C)
    return out


def _ln2d(x, p):
    return layer_norm(x, p["scale"], p["bias"], LN2D_EPS)


def _cna(x, p, padding=0, groups=1, act=True):
    x = conv2d(x, p["conv"]["kernel"], p["conv"].get("bias"),
               padding=padding, groups=groups)
    x = _ln2d(x, p["norm"])
    return F.silu(x) if act else x


def _bottleneck(x: torch.Tensor, bp: dict) -> torch.Tensor:
    """x: [N, H, W, C_in] -> [N, H, W, C_out]."""
    shortcut = x
    h = _cna(x, bp["conv1"])
    h = _cna(h, bp["conv2"], padding=1, groups=h.shape[-1])
    se = torch.mean(h, dim=(1, 2), keepdim=True)
    se = conv2d(se, bp["se"]["fc1"]["kernel"], bp["se"]["fc1"]["bias"])
    se = F.silu(se)
    se = conv2d(se, bp["se"]["fc2"]["kernel"], bp["se"]["fc2"]["bias"])
    h = h * torch.sigmoid(se)
    h = _cna(h, bp["conv3"], act=False)
    if "downsample" in bp:
        shortcut = _cna(shortcut, bp["downsample"], act=False)
    return F.silu(h + shortcut)


def _regstage(x: torch.Tensor, sp: dict) -> torch.Tensor:
    for i in range(1, len(sp) + 1):
        x = _bottleneck(x, sp[f"b{i}"])
    return x


def _mlp(x: torch.Tensor, mp: dict) -> torch.Tensor:
    n = len(mp)
    for d in range(1, n + 1):
        p = mp[f"fc{d}"]
        x = torch.matmul(x, p["kernel"].to(x.dtype)) + p["bias"].to(x.dtype)
        if d < n:
            x = gelu_exact(x)
    return x


class _Gathered(dict):
    """A connector tree gathered already (aggregate_each gathers once for
    its calls)."""


def gather(params: dict) -> dict:
    """The connector's params whole on every rank of the current mesh (the
    identity without one, or on a tree gathered already)."""
    if isinstance(params, _Gathered):
        return params
    return _Gathered(sh.gather_tree(sh.current_mesh(), params, "connector"))


def apply(params: dict, cfg: ConnectorConfig, x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, N, D] per-frame features -> [B, tokens, hidden]; for
    linear and mlp{N}x_gelu, x is [B, N, D], mean-pooled over time by the
    caller (models/videollama2.temporal_aggregator)."""
    k = kind(cfg.projector_type)
    if k == "identity":
        b, t, n, d = x.shape
        return x.reshape(b, t * n, d)
    params = gather(params)
    if k in ("linear", "mlp"):
        return _mlp(x, params)
    b, t, n, d = x.shape
    hw = int(round(n ** 0.5))
    x = x.reshape(b * t, hw, hw, d)
    if cfg.depth != 0:
        x = _regstage(x, params["s1"])
    c = x.shape[-1]
    x = x.reshape(b, t, hw, hw, c)
    if k == "conv":
        x = conv3d(x, params["sampler"]["kernel"], params["sampler"]["bias"],
                   stride=cfg.downsample, padding=cfg.conv_padding)
    else:
        x = avg_pool3d(x, cfg.downsample)
    x = F.silu(x)
    _, nt, nh, nw, c = x.shape
    x = x.reshape(b * nt, nh, nw, c)
    if cfg.depth != 0:
        x = _regstage(x, params["s2"])
    x = x.reshape(b, nt * nh * nw, c)
    return _mlp(x, params["readout"])
