"""Seeded random weights at full width, made directly on the device.

Released checkpoints are not needed to run or time the model: this builds
every parameter of `models/videollama2.param_shapes(cfg)` from one seeded
torch.Generator, with the JAX package's init scales (normal(0, 0.02)
kernels and embeddings, ones for norm scales, zeros for biases, He-normal
connector convs, 1/sqrt(fan_in) readout). Random values, unlike constant
fills, give every attention row a different softmax, so a kernel bug shows
up in the output.
"""

from __future__ import annotations

import math

import torch

from ..models import videollama2 as vl2


def _init(path, shape, dtype, device, generator) -> torch.Tensor:
    name = path[-1]
    if name == "scale":
        return torch.ones(shape, dtype=dtype, device=device)
    if name == "bias":
        return torch.zeros(shape, dtype=dtype, device=device)
    std = 0.02
    if path[0] == "connector":
        fan_in = math.prod(shape[:-1])
        std = math.sqrt((1.0 if path[1] == "readout" else 2.0) / fan_in)
    w = torch.randn(shape, generator=generator, dtype=dtype, device=device)
    return w.mul_(std)


def _build(spec: dict, path, dtype, device, generator) -> dict:
    out = {}
    for k, v in spec.items():
        if isinstance(v, dict):
            out[k] = _build(v, path + (k,), dtype, device, generator)
        else:
            out[k] = _init(path + (k,), v, dtype, device, generator)
    return out


def synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                     seed: int = 0) -> dict:
    """Full parameter tree for `cfg` on `device` in `dtype`."""
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    return _build(vl2.param_shapes(cfg), (), dtype, torch.device(device),
                  generator)
