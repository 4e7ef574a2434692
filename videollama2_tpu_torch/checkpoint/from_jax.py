"""Turn a JAX package param tree (as numpy arrays) into the port's params.

The JAX tree is a plain dict with layers stacked on a leading L axis and
kernels stored [in, out]; the port keeps that layout, so the bridge only
fuses the separate q/k/v projections of the tower and of the LLM into the
`qkv` entry the port's modules read (concatenated along the output axis,
biases alongside). It raises if a JAX leaf is left unused or a port
parameter is left unfilled, so both packages compute the same function.
"""

from __future__ import annotations

import numpy as np
import torch

from ..models import videollama2 as vl2


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


def params_from_jax(jax_params: dict, cfg) -> dict:
    """jax_params: {"llm", "vision", "connector"} tree of numpy (or
    array-like) leaves. Returns the port's tree as CPU tensors (the Engine
    moves and casts them)."""
    src = {p: np.asarray(a) for p, a in _flatten(jax_params)}
    consumed = set()

    def take(path):
        if path not in src:
            raise KeyError(f"JAX tree has no leaf {'.'.join(path)}")
        consumed.add(path)
        return src[path]

    out: dict = {}
    for path, shape in _flatten(vl2.param_shapes(cfg)):
        if len(path) >= 2 and path[-2] == "qkv":
            arr = np.concatenate([take(path[:-2] + (n, path[-1]))
                                  for n in ("q", "k", "v")], axis=-1)
        else:
            arr = take(path)
        if tuple(arr.shape) != tuple(shape):
            raise ValueError(f"{'.'.join(path)}: JAX shape {arr.shape}, "
                             f"port expects {shape}")
        _set(out, path, torch.from_numpy(np.array(arr)))  # writable copy
    unused = sorted(".".join(p) for p in set(src) - consumed)
    if unused:
        raise ValueError(f"JAX leaves not consumed by the port: {unused}")
    return out
