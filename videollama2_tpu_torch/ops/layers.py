"""Core neural-net primitives (port of videollama2_tpu/ops/layers.py).

bf16/fp32 dense paths only; the int8/int4 weight packs and LoRA adapters
raise NotImplementedError until their port. Normalization statistics run in
fp32 whatever the compute dtype, and the cast points match the JAX package,
because bf16 parity depends on them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------
# Activations
# ---------------------------------------------------------------------------

def quick_gelu(x):
    """CLIP's QuickGELU: x * sigmoid(1.702 * x)."""
    return x * torch.sigmoid(1.702 * x)


def gelu_tanh(x):
    """SigLIP's gelu_pytorch_tanh."""
    return F.gelu(x, approximate="tanh")


def gelu_exact(x):
    """erf-based GELU (the STC readout MLP)."""
    return F.gelu(x)


ACT2FN = {
    "quick_gelu": quick_gelu,
    "gelu_pytorch_tanh": gelu_tanh,
    "gelu": gelu_exact,
    "gelu_new": gelu_tanh,
    "silu": F.silu,
    "relu": F.relu,
}


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm: fp32 statistics, cast back to x's dtype, THEN scale."""
    dtype = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return xf.to(dtype) * scale.to(dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    """LayerNorm over the last axis with fp32 statistics and affine."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(), bias.float(),
                       eps)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Rotary position embeddings (HF rotate-half layout)
# ---------------------------------------------------------------------------

def rope_table(positions: torch.Tensor, head_dim: int, theta: float,
               dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """cos/sin of shape [..., head_dim] for integer positions [...]."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32,
                            device=positions.device) / head_dim
    inv_freq = 1.0 / (theta ** exponent)
    freqs = positions.float()[..., None] * inv_freq
    emb = torch.cat([freqs, freqs], dim=-1)
    return torch.cos(emb).to(dtype), torch.sin(emb).to(dtype)


def _rotate_half(x):
    half = x.shape[-1] // 2
    return torch.cat([-x[..., half:], x[..., :half]], dim=-1)


def apply_rope(q: torch.Tensor, k: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """q/k: [B, S, H, hd]; cos/sin: [B, S, hd] (broadcast over heads).
    Computed in cos's (fp32) precision, cast back to q/k's dtype."""
    cos = cos[..., None, :]
    sin = sin[..., None, :]
    q2 = q * cos + _rotate_half(q) * sin
    k2 = k * cos + _rotate_half(k) * sin
    return q2.to(q.dtype), k2.to(k.dtype)


def layer_params(layers: dict, i: int) -> dict:
    """Layer i of a layer tree stacked on a leading L axis (views)."""
    return {n: ({k: a[i] for k, a in e.items()} if isinstance(e, dict)
                else e[i]) for n, e in layers.items()}


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, p: dict) -> torch.Tensor:
    """y = x @ kernel (+ bias); kernel is [in, out] as in the JAX tree."""
    if "kernel" not in p:
        raise NotImplementedError(
            f"quantized dense packs ({sorted(p)}) are not ported yet")
    if "lora" in p:
        raise NotImplementedError("LoRA adapters are not ported yet")
    y = torch.matmul(x, p["kernel"].to(x.dtype))
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y
