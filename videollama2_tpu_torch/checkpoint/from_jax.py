"""Turn a JAX-layout param tree into the port's params.

The JAX tree is a plain dict with layers stacked on a leading L axis and
kernels stored [in, out]; the port keeps that layout, so the bridge only
fuses the separate q/k/v projections of the tower and of the LLM into the
`qkv` entry the port's modules read (concatenated along the output axis,
biases alongside). Weight packs, int8 ("kernel_q8": {"q", "scale"}) and
folded int4 ("kernel_q4": {"q4", "scale"}), come across the same way,
split (ops/quant.quantize_llm_params, quantize_vision_params) or already
fused (ops/quant.fuse_qkv); the int4 fold is over the input axis, so the
output-axis concatenation fuses them unchanged; an int8 embedding
("weight_q8", quantize_llm_params(include_embed=True)) is taken as it is.
The tower is CLIP's or SigLIP's, as `cfg.vision` says; the audio-visual
model's "audio" branch (BEATs and its projector) keeps the JAX layouts and
is copied leaf by leaf. It raises if a JAX
leaf is left unused or a port parameter is left unfilled, so both packages
compute the same function. Leaves may be numpy arrays (a JAX tree) or torch
tensors in any dtype (checkpoint/convert_hf's tree of a released bf16
checkpoint), which are taken as they are, without a numpy round trip.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import videollama2 as vl2
from ..ops.quant import PACKS


def _flatten(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, path + (k,))
    else:
        yield path, tree


def _set(tree: dict, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _pack_bits(tree: dict, part: str):
    """The weight bits of the packs in the layers of the JAX tree's `part`:
    8 (int8), 4 (folded int4) or None (floating kernels)."""
    paths = [path for path, _ in
             _flatten(tree.get(part, {}).get("layers", {}))]
    for bits, (pack, _) in PACKS.items():
        if any(pack in path for path in paths):
            return bits
    return None


def _tensor(leaf) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf
    return torch.from_numpy(np.array(leaf))  # a writable copy


def params_from_jax(jax_params: dict, cfg) -> dict:
    """jax_params: {"llm", "vision", "connector"[, "audio"]} tree (the
    audio branch when cfg.audio is set) of torch tensors or numpy (or
    array-like) leaves. Returns the port's tree as contiguous
    tensors on the leaves' device, in their dtype (the Engine moves and
    casts them)."""
    src = {p: _tensor(a) for p, a in _flatten(jax_params)}
    consumed = set()

    def take(path):
        if path not in src:
            raise KeyError(f"JAX tree has no leaf {'.'.join(path)}")
        consumed.add(path)
        return src[path]

    out: dict = {}
    shapes = vl2.param_shapes(
        cfg, llm_bits=_pack_bits(jax_params, "llm"),
        int8_vision=_pack_bits(jax_params, "vision") == 8,
        int8_embed="weight_q8" in jax_params.get("llm", {}).get("embed", {}))
    for path, shape in _flatten(shapes):
        if "qkv" in path and path not in src:
            i = path.index("qkv")
            arr = torch.cat(
                [take(path[:i] + (n,) + path[i + 1:])
                 for n in ("q", "k", "v")],
                dim=-1)
        else:
            arr = take(path)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{'.'.join(path)}: JAX shape {arr.shape}, "
                             f"port expects {shape}")
        _set(out, path, arr.contiguous())
    unused = sorted(".".join(p) for p in set(src) - consumed)
    if unused:
        raise ValueError(f"JAX leaves not consumed by the port: {unused}")
    return out
