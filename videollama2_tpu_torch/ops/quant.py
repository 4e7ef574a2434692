"""int8 weight-only packs with per-output-channel scales (port of the int8
half of videollama2_tpu/ops/quant.py).

A pack is {"q": int8 [..., in, out], "scale": fp32 [..., 1, out]}. The
packs are bit-identical to the JAX package's: the amax and the scale are
computed in the input's dtype (a bf16 weight gets a bf16 scale, cast to
fp32 only at the end), the weight is divided by the scale (a true
division, not a multiply by the reciprocal) and rounded half to even, as
`jnp.round` does. The int4 pack comes with `load_4bit` in a later port.
"""

from __future__ import annotations

from typing import Dict

import torch

LLM_PROJECTIONS = ("q", "k", "v", "qkv", "o", "gate", "up", "down")
VISION_PROJECTIONS = ("q", "k", "v", "qkv", "o", "fc1", "fc2")


def quantize_int8(w: torch.Tensor, axis: int = -1) -> Dict[str, torch.Tensor]:
    """Symmetric per-channel int8: the amax is taken over `axis` (axis=-2 on
    an [..., in, out] kernel gives one scale per output channel)."""
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 127.0
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return {"q": q, "scale": scale.to(torch.float32)}


def dequantize_int8(pack: Dict[str, torch.Tensor],
                    dtype=torch.bfloat16) -> torch.Tensor:
    return (pack["q"].to(torch.float32) * pack["scale"]).to(dtype)


def kernel_shapes(shape: tuple, int8: bool) -> dict:
    """The dense entry of an [..., in, out] kernel in a param-shape tree:
    {"kernel": shape}, or its int8 pack's shapes."""
    if not int8:
        return {"kernel": shape}
    return {"kernel_q8": {"q": shape, "scale": shape[:-2] + (1, shape[-1])}}


def _quantize_entries(layers: dict, names) -> dict:
    out = dict(layers)
    for name in names:
        if name not in layers or "kernel" not in layers[name]:
            continue
        entry = dict(layers[name])
        entry["kernel_q8"] = quantize_int8(entry.pop("kernel"), axis=-2)
        out[name] = entry
    return out


def quantize_llm_params(llm_params: dict, bits: int = 8,
                        include_head: bool = True) -> dict:
    """int8 packs for the LLM's stacked projections (q/k/v or the fused
    qkv, o, gate, up, down) and, with include_head, the lm_head; norms and
    the embedding stay floating point."""
    if bits != 8:
        raise NotImplementedError("only int8 packs are ported (int4 comes "
                                  "with load_4bit)")
    out = dict(llm_params)
    out["layers"] = _quantize_entries(llm_params["layers"], LLM_PROJECTIONS)
    if include_head and "kernel" in out.get("lm_head", {}):
        head = dict(out["lm_head"])
        head["kernel_q8"] = quantize_int8(head.pop("kernel"), axis=-2)
        out["lm_head"] = head
    return out


def quantize_vision_params(vit_params: dict) -> dict:
    """int8 packs for the frozen tower's stacked linears (q/k/v or the fused
    qkv, o, fc1, fc2); the patch conv, norms and embeddings stay floating
    point."""
    out = dict(vit_params)
    out["layers"] = _quantize_entries(vit_params["layers"],
                                      VISION_PROJECTIONS)
    return out


def fuse_qkv(llm_params: dict) -> dict:
    """Fuse separate q/k/v int8 packs into one `qkv` entry, concatenated on
    the output axis (scales and biases alongside). Returns the input
    unchanged when q/k/v are not all int8 packs or carry LoRA adapters."""
    layers = llm_params.get("layers", {})
    names = ("q", "k", "v")
    if not all("kernel_q8" in layers.get(n, {}) for n in names) or any(
            "lora" in layers[n] for n in names):
        return llm_params
    packs = [layers[n]["kernel_q8"] for n in names]
    fused = {"kernel_q8": {
        k: torch.cat([p[k] for p in packs], dim=-1) for k in ("q", "scale")}}
    if all(layers[n].get("bias") is not None for n in names):
        fused["bias"] = torch.cat([layers[n]["bias"] for n in names], dim=-1)
    new_layers = {n: e for n, e in layers.items() if n not in names}
    new_layers["qkv"] = fused
    return dict(llm_params, layers=new_layers)
