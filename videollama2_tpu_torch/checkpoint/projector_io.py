"""The pretrain stage's projector-only save (port of save_projector_only
and load_projector_only of videollama2_tpu/checkpoint/orbax_io.py): the
connector's leaves in `mm_projector.npz`, keyed by their "/"-joined paths,
beside `mm_projector.json`, the sorted key list. Both packages read each
other's files. bf16 leaves are written as fp32 (numpy has no bf16; the
widening is exact) and cast back to the dtype of `like` on load.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from ..train.optimizer import flatten


def save_projector_only(directory: str, connector_params: dict) -> None:
    os.makedirs(directory, exist_ok=True)
    flat = {}
    for path, t in flatten(connector_params).items():
        t = t.detach().cpu()
        flat["/".join(path)] = (t.float() if t.dtype == torch.bfloat16
                                else t).numpy()
    np.savez(os.path.join(directory, "mm_projector.npz"), **flat)
    with open(os.path.join(directory, "mm_projector.json"), "w") as f:
        json.dump(sorted(flat), f)


def load_projector_only(directory: str, like: dict) -> dict:
    """A tree shaped like `like` (a connector tree of tensors) with the
    saved values, in each leaf's dtype and on its device."""
    data = np.load(os.path.join(directory, "mm_projector.npz"))

    def build(tree, prefix):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = build(v, prefix + (k,))
            else:
                arr = data["/".join(prefix + (k,))]
                if tuple(arr.shape) != tuple(v.shape):
                    raise ValueError(f"{'/'.join(prefix + (k,))}: saved "
                                     f"{arr.shape}, expected {tuple(v.shape)}")
                out[k] = torch.from_numpy(np.array(arr)).to(
                    device=v.device, dtype=v.dtype)
        return out
    return build(like, ())
