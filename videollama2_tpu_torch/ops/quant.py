"""Weight-only packs with per-output-channel scales (port of
videollama2_tpu/ops/quant.py): int8, and int4 in the folded-nibble layout.

An int8 pack is {"q": int8 [..., in, out], "scale": fp32 [..., 1, out]};
an int4 pack in a model tree is {"q4": int8 [..., in/2, out], "scale": fp32
[..., 1, out]}, byte row i holding weight row i in its low nibble (stored
offset-binary, lo + 8) and row i + in/2 in its high nibble (two's
complement, shifted left 4). The packs are bit-identical to the JAX
package's: the amax and the scale are computed in the input's dtype (a
bf16 weight gets a bf16 scale, cast to fp32 only at the end), the weight is
divided by the scale (a true division, not a multiply by the reciprocal)
and rounded half to even, as `jnp.round` does.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

LLM_PROJECTIONS = ("q", "k", "v", "qkv", "o", "gate", "up", "down")
VISION_PROJECTIONS = ("q", "k", "v", "qkv", "o", "fc1", "fc2")
# weight bits -> (the pack's name in a model tree, the key of its weight bytes)
PACKS = {8: ("kernel_q8", "q"), 4: ("kernel_q4", "q4")}


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


def quantize_int4(w: torch.Tensor, axis: int = -1) -> Dict[str, torch.Tensor]:
    """Symmetric per-channel int4, folded two to a byte along `axis`: byte
    i holds element i (low nibble, offset-binary) and element i + n/2 (high
    nibble). Returns {"q4", "scale", "axis"} (JAX's pack without its unused
    orig_dim); model trees keep only q4 and scale (the packed axis there is
    always -2)."""
    amax = torch.amax(torch.abs(w), dim=axis, keepdim=True)
    scale = torch.clamp(amax, min=1e-8) / 7.0
    q = torch.clamp(torch.round(w / scale), -7, 7).to(torch.int8)
    q = torch.movedim(q, axis, -1)
    n = q.shape[-1]
    if n % 2:
        raise ValueError(f"an int4 pack needs an even dimension, got {n}")
    lo = (q[..., :n // 2] + 8) & 0x0F
    hi = (q[..., n // 2:] & 0x0F) << 4          # wraps in int8, as in JAX
    packed = torch.movedim(lo | hi, -1, axis)
    return {"q4": packed, "scale": scale.to(torch.float32),
            "axis": torch.tensor(axis % w.dim(), dtype=torch.int32)}


def unpack_int4(q4: torch.Tensor, dim: int = -2,
                column_major: bool = False) -> torch.Tensor:
    """Folded int4 bytes -> the int8 weights (exact), `dim` doubled: the
    low nibbles ((b & 0xF) - 8) then the high nibbles (b >> 4, an
    arithmetic shift). With column_major (dim -2 of a 2-D pack only), the
    result is written straight into a column-major [in, out] tensor, the
    layout torch._int_mm takes fastest at large M."""
    q = torch.movedim(q4, dim, -2)
    n, out_dim = q.shape[-2], q.shape[-1]
    shape = q.shape[:-2] + (2 * n, out_dim)
    if column_major:
        if q.dim() != 2 or dim not in (-2, 0):
            raise ValueError("column_major unpacks one [in/2, out] pack")
        full = torch.empty((out_dim, 2 * n), dtype=torch.int8,
                           device=q.device).t()
    else:
        full = torch.empty(shape, dtype=torch.int8, device=q.device)
    torch.bitwise_and(q, 0x0F, out=full[..., :n, :])
    full[..., :n, :].sub_(8)
    torch.bitwise_right_shift(q, 4, out=full[..., n:, :])
    return torch.movedim(full, -2, dim)


def dequantize_int4(pack: Dict[str, torch.Tensor],
                    dtype=torch.bfloat16) -> torch.Tensor:
    """A quantize_int4 pack back to `dtype`, along its recorded axis."""
    full = unpack_int4(pack["q4"], int(pack["axis"]))
    return (full.to(torch.float32) * pack["scale"]).to(dtype)


def dequantize_int4_in(q4: torch.Tensor, scale: torch.Tensor,
                       dtype=torch.bfloat16) -> torch.Tensor:
    """A model tree's int4 pack (packed over the input axis -2 of an
    [..., in/2, out] kernel) back to an [..., in, out] kernel in dtype."""
    return (unpack_int4(q4).to(torch.float32) * scale).to(dtype)


def kernel_shapes(shape: tuple, bits: Optional[int]) -> dict:
    """The dense entry of an [..., in, out] kernel in a param-shape tree:
    {"kernel": shape} (bits None), or its int8 (8) or folded int4 (4)
    pack's shapes."""
    scale = shape[:-2] + (1, shape[-1])
    if bits is None:
        return {"kernel": shape}
    if bits == 8:
        return {"kernel_q8": {"q": shape, "scale": scale}}
    if bits == 4:
        return {"kernel_q4": {"q4": shape[:-2] + (shape[-2] // 2, shape[-1]),
                              "scale": scale}}
    raise ValueError(f"weight bits must be None, 8 or 4, got {bits}")


def quantize_kernel(w: torch.Tensor, bits: int) -> dict:
    """An [..., in, out] kernel -> its model-tree entry {"kernel_q8": ...}
    or {"kernel_q4": {"q4", "scale"}}, one scale per output channel."""
    if bits == 8:
        return {"kernel_q8": quantize_int8(w, axis=-2)}
    if bits == 4:
        pack = quantize_int4(w, axis=-2)
        return {"kernel_q4": {"q4": pack["q4"], "scale": pack["scale"]}}
    raise ValueError(f"weight bits must be 8 or 4, got {bits}")


def quantize_in_place(entries: dict, names, bits: int,
                      prepare=None) -> None:
    """Replace entries[name]["kernel"] by its int8 or folded int4 pack
    (quantize_kernel's), a kernel stacked on a leading layer axis layer by
    layer (bit-identical to quantizing the whole stack: the amax runs over
    each layer's input axis), dropping each floating kernel once it is
    packed, so only one layer's temporaries are alive at a time. Each
    kernel, or layer of one, goes through `prepare` first (a move to the
    device, a cast), and its pack is made where that puts it."""
    prepare = prepare or (lambda t: t)
    for name in names:
        if "kernel" not in entries.get(name, {}):
            continue
        w = entries[name].pop("kernel")
        if w.dim() == 2:
            entries[name].update(quantize_kernel(prepare(w), bits))
            continue
        pack_name, pack = None, {}
        for i in range(w.shape[0]):
            (pack_name, layer), = quantize_kernel(prepare(w[i]),
                                                  bits).items()
            for k, t in layer.items():
                if i == 0:
                    pack[k] = t.new_empty((w.shape[0],) + tuple(t.shape))
                pack[k][i] = t
        del w
        entries[name][pack_name] = pack


def _quantize_entries(layers: dict, names, bits: int) -> dict:
    out = dict(layers)
    for name in names:
        if name not in layers or "kernel" not in layers[name]:
            continue
        entry = dict(layers[name])
        entry.update(quantize_kernel(entry.pop("kernel"), bits))
        out[name] = entry
    return out


def quantize_embed(embed: dict) -> dict:
    """The embedding {"weight" [V, D]} -> {"weight_q8": int8 pack with one
    scale a row ([V, 1])}: embed_tokens gathers int8 rows and their scales
    (JAX's include_embed)."""
    return {"weight_q8": quantize_int8(embed["weight"], axis=-1)}


def quantize_llm_params(llm_params: dict, bits: int = 8,
                        include_head: bool = True,
                        include_embed: bool = False) -> dict:
    """int8 (bits 8) or folded int4 (bits 4) packs for the LLM's stacked
    projections (q/k/v or the fused qkv, o, gate, up, down) and, with
    include_head, an int8 lm_head whatever `bits` (as in JAX: the head is a
    single-matmul consumer, not a folded-nibble kernel); with
    include_embed, an int8 embedding with per-row scales (the 152k-vocab
    families' option). Norms stay floating point."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = dict(llm_params)
    out["layers"] = _quantize_entries(llm_params["layers"], LLM_PROJECTIONS,
                                      bits)
    if include_head and "kernel" in out.get("lm_head", {}):
        head = dict(out["lm_head"])
        head.update(quantize_kernel(head.pop("kernel"), 8))
        out["lm_head"] = head
    if include_embed:
        out["embed"] = quantize_embed(out["embed"])
    return out


def quantize_vision_params(vit_params: dict) -> dict:
    """int8 packs for the frozen tower's stacked linears (q/k/v or the fused
    qkv, o, fc1, fc2); the patch conv, norms and embeddings stay floating
    point."""
    out = dict(vit_params)
    out["layers"] = _quantize_entries(vit_params["layers"],
                                      VISION_PROJECTIONS, 8)
    return out


def fuse_qkv(llm_params: dict) -> dict:
    """Fuse separate q/k/v packs (all int8 or all int4) into one `qkv`
    entry, concatenated on the output axis, which the int4 fold does not
    touch (scales and biases alongside). LoRA adapters on any of the three
    are fused too, into the qkv entry's adapter form (train/lora.py), which
    the JAX package's fuse_qkv leaves unfused: the port's layer tree has
    one layout. Returns the input unchanged when q/k/v are not all packs of
    one kind."""
    # imported here: train.lora imports ops.layers, which imports this module
    from ..train.lora import fuse_qkv_adapters
    layers = llm_params.get("layers", {})
    names = ("q", "k", "v")
    kind = next((pk for pk in PACKS.values()
                 if all(pk[0] in layers.get(n, {}) for n in names)), None)
    if kind is None:
        return llm_params
    name, wk = kind
    packs = [layers[n][name] for n in names]
    fused = {name: {k: torch.cat([p[k] for p in packs], dim=-1)
                    for k in (wk, "scale")}}
    if all(layers[n].get("bias") is not None for n in names):
        fused["bias"] = torch.cat([layers[n]["bias"] for n in names], dim=-1)
    lora = fuse_qkv_adapters(
        {n: layers[n]["lora"] for n in names if "lora" in layers[n]},
        {n: layers[n][name]["scale"].shape[-1] for n in names})
    if lora is not None:
        fused["lora"] = lora
    new_layers = {n: e for n, e in layers.items() if n not in names}
    new_layers["qkv"] = fused
    return dict(llm_params, layers=new_layers)
