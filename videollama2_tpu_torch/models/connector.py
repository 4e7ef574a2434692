"""STC connectors (port of the `stc_connector` / `stc_connector_v35` path of
videollama2_tpu/models/connector.py).

RegStage of SE-bottlenecks (LayerNorm2d eps 1e-6, SiLU) -> Conv3d
downsampler (kernel = stride = downsample; padding 1 for stc_connector, 0
for v35) + SiLU -> RegStage -> readout MLP with exact GELU. Channels-last
throughout, as in the JAX package. The other projector types are not ported
yet. Under a mesh the connector's shards (1x1 convs, sampler, readout:
parallel/sharding's rules) are all gathered before it runs, and it runs
whole on each rank.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..core.config import ConnectorConfig

from ..ops.conv import conv2d, conv3d
from ..ops.layers import gelu_exact, layer_norm
from ..parallel import sharding as sh

LN2D_EPS = 1e-6  # timm LayerNorm2d default
STC_TYPES = ("stc_connector", "stc_connector_v35")


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


def param_shapes(cfg: ConnectorConfig) -> dict:
    if cfg.projector_type not in STC_TYPES:
        raise NotImplementedError(
            f"projector {cfg.projector_type!r} is not ported yet")
    C = cfg.hidden_size
    out = {}
    if cfg.depth != 0:
        out["s1"] = {f"b{i + 1}": _block_shapes(
            cfg.mm_hidden_size if i == 0 else C, C) for i in range(cfg.depth)}
        out["s2"] = {f"b{i + 1}": _block_shapes(C, C)
                     for i in range(cfg.depth)}
    out["sampler"] = {"kernel": tuple(cfg.downsample) + (C, C), "bias": (C,)}
    out["readout"] = {f"fc{d + 1}": {"kernel": (C, C), "bias": (C,)}
                      for d in range(cfg.mlp_depth)}
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
    """x: [B, T, N, D] per-frame features -> [B, tokens, hidden]."""
    if cfg.projector_type not in STC_TYPES:
        raise NotImplementedError(
            f"projector {cfg.projector_type!r} is not ported yet")
    params = gather(params)
    b, t, n, d = x.shape
    hw = int(round(n ** 0.5))
    x = x.reshape(b * t, hw, hw, d)
    if cfg.depth != 0:
        x = _regstage(x, params["s1"])
    c = x.shape[-1]
    x = x.reshape(b, t, hw, hw, c)
    x = conv3d(x, params["sampler"]["kernel"], params["sampler"]["bias"],
               stride=cfg.downsample, padding=cfg.conv_padding)
    x = F.silu(x)
    _, nt, nh, nw, c = x.shape
    x = x.reshape(b * nt, nh, nw, c)
    if cfg.depth != 0:
        x = _regstage(x, params["s2"])
    x = x.reshape(b, nt * nh * nw, c)
    return _mlp(x, params["readout"])
