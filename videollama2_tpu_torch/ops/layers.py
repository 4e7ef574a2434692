"""Core neural-net primitives (port of videollama2_tpu/ops/layers.py).

Dense takes floating kernels, int8 weight packs (dequantize or W8A8) and
folded int4 packs (dequantize or W4A8), each with or without a LoRA
adapter (train/lora.py).
Normalization statistics run in fp32 whatever the compute dtype, and the
cast points match the JAX package, because bf16 parity depends on them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .quant import dequantize_int4_in, unpack_int4


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
    return {n: layer_params(e, i) if isinstance(e, dict) else e[i]
            for n, e in layers.items()}


def unbind_layers(layers: dict, n: int) -> list:
    """Every layer of a stacked layer tree at once (views, torch.unbind):
    the gradient of a trained stacked leaf is stacked once in the
    backward, where indexing layer by layer adds a full-size gradient of
    the leaf for each layer."""
    out = [{} for _ in range(n)]
    for name, e in layers.items():
        parts = unbind_layers(e, n) if isinstance(e, dict) else e.unbind(0)
        for i in range(n):
            out[i][name] = parts[i]
    return out


# ---------------------------------------------------------------------------
# Dense
# ---------------------------------------------------------------------------

def dense(x: torch.Tensor, p: dict, w8a8: bool = False) -> torch.Tensor:
    """y = x @ kernel (+ LoRA delta) (+ bias); kernel is [in, out] as in
    the JAX tree.

    A weight pack ("kernel_q8": {"q" [in, out], "scale" [1, out]}, or the
    folded int4 "kernel_q4": {"q4" [in/2, out], "scale" [1, out]}) takes
    one of the JAX package's two branches, chosen by the caller: with w8a8
    the serving branch (`dense_w8a8` / `dense_w4a8`: activations quantized
    per row, an int8 x int8 -> int32 product), which the Engine selects for
    every packed dense it reaches, as the JAX Engine does under its
    quant_inference and w8a8_prefill contexts; without it the dequantize
    branch (JAX's, which is exact under gradients), which training takes.

    A "lora" entry ({"a" [in, r], "b" [r, out], "s" [1, 1]}, or the fused
    qkv entry's form with one b block a projection, train/lora.py) adds
    (x @ a) @ b * s, with a, b and s cast to x's dtype, after the base
    product and before the bias, whatever the base and branch: under
    w8a8 only the base is quantized, as in the JAX package.
    """
    if "kernel" in p:
        y = torch.matmul(x, p["kernel"].to(x.dtype))
    elif "kernel_q8" in p:
        pack = p["kernel_q8"]
        if w8a8:
            y = dense_w8a8(x, pack)
        else:
            y = torch.matmul(x, pack["q"].to(x.dtype))
            y = y * pack["scale"][..., 0, :].to(x.dtype)
    elif "kernel_q4" in p:
        pack = p["kernel_q4"]
        if w8a8:
            y = dense_w4a8(x, pack)
        else:
            y = torch.matmul(x, dequantize_int4_in(pack["q4"], pack["scale"],
                                                   x.dtype))
    else:
        raise NotImplementedError(
            f"dense packs {sorted(p)} are not ported yet")
    if "lora" in p:
        y = y + _lora_delta(x, p["lora"])
    if p.get("bias") is not None:
        y = y + p["bias"].to(x.dtype)
    return y


def lora_b_product(xa: torch.Tensor, b) -> torch.Tensor:
    """xa @ b in xa's dtype, b an adapter's [r, out] (or stacked) tensor,
    or the fused qkv form's {"q", "k", "v"} blocks: each block takes its
    own r-slice of xa, and the blocks' outputs are concatenated along the
    output axis (train/lora.py)."""
    if not isinstance(b, dict):
        return torch.matmul(xa, b.to(xa.dtype))
    parts, off = [], 0
    for bj in b.values():
        r = bj.shape[-2]
        parts.append(torch.matmul(xa[..., off:off + r], bj.to(xa.dtype)))
        off += r
    return torch.cat(parts, dim=-1)


def _lora_delta(x: torch.Tensor, lora: dict) -> torch.Tensor:
    """(x @ a) @ b * s in x's dtype (JAX `dense`'s LoRA branch), with s
    applied to the rank-r x @ a rather than to the full output."""
    s = lora["s"].to(x.dtype)[..., 0, :]
    xa = torch.matmul(x, lora["a"].to(x.dtype)) * s
    return lora_b_product(xa, lora["b"])


# torch._int_mm on CUDA takes only more than 16 rows (it raises "self.size(0)
# needs to be greater than 16" on the H100, a rule its meta function does not
# state); decode-time calls (the lm_head at B = 16) are padded up to this.
INT_MM_MIN_ROWS = 17
# From this many rows on, the weight goes to torch._int_mm column-major.
INT_MM_TRANSPOSE_ROWS = 512


def _int8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact int8 [M, K] x int8 [K, N] -> int32 [M, N].

    On CUDA, with the pack's row-major [in, out] layout torch._int_mm takes
    a CUTLASS fallback whose time grows with M about 7x faster than that of
    the kernel it takes for a column-major weight (on an H100: 23.6 against
    3.3 ms at [26624, 4096] x [4096, 14336]), while the column-major copy
    costs a fixed time per weight, ~0.8 ms for the 131 MB head (1.04
    against 0.23 ms at [16, 4096] x [4096, 32000]). So large-M calls
    (prefill, the tower) take the weight column-major (copied here unless
    it comes so, as `dense_w4a8` unpacks it) and decode-sized calls do not
    (by those two measurements the costs cross near 500 rows at these
    widths)."""
    if a.device.type != "cuda":
        return torch.matmul(a.to(torch.int32), b.to(torch.int32))
    rows = a.shape[0]
    if rows < INT_MM_MIN_ROWS:
        a = torch.cat([a, a.new_zeros(INT_MM_MIN_ROWS - rows, a.shape[1])])
    if rows >= INT_MM_TRANSPOSE_ROWS and b.stride(0) != 1:
        b = b.t().contiguous().t()
    return torch._int_mm(a, b)[:rows]


def _column_major(x: torch.Tensor) -> bool:
    """Whether _int8_matmul wants x's weight column-major."""
    return x.device.type == "cuda" and \
        x.numel() // x.shape[-1] >= INT_MM_TRANSPOSE_ROWS


def _quantize_rows(x: torch.Tensor):
    """Per-row symmetric int8 activations of W8A8/W4A8: (xq [rows, in]
    int8, xs [..., 1] fp32)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf), dim=-1, keepdim=True)
    xs = torch.clamp(amax, min=1e-8) / 127.0
    xq = torch.clamp(torch.round(xf / xs), -127, 127).to(torch.int8)
    return xq.reshape(-1, x.shape[-1]), xs


def _w8a8(x: torch.Tensor, wq: torch.Tensor, scale: torch.Tensor):
    xq, xs = _quantize_rows(x)
    acc = _int8_matmul(xq, wq)
    acc = acc.reshape(x.shape[:-1] + (acc.shape[-1],))
    return (acc.float() * xs * scale[..., 0, :]).to(x.dtype)


def dense_w8a8(x: torch.Tensor, pack: dict) -> torch.Tensor:
    """W8A8 (JAX `dense_w8a8`): per-row symmetric int8 activations, an
    exact int32 product with the int8 weights, then `* xs * scale` in fp32
    and a cast to x's dtype."""
    return _w8a8(x, pack["q"], pack["scale"])


def dense_w4a8(x: torch.Tensor, pack: dict) -> torch.Tensor:
    """W4A8 (JAX `dense_w4a8`): the folded nibbles unpack losslessly to an
    int8 [in, out] plane (values in [-8, 7], the per-output-channel scale
    unchanged), then the W8A8 product. A large-row call unpacks straight
    into the column-major layout, so the weight is copied once."""
    return _w8a8(x, unpack_int4(pack["q4"], column_major=_column_major(x)),
                 pack["scale"])
