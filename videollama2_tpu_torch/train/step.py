"""The training step on one device (port of videollama2_tpu/train/step.py
without the mesh).

`make_train_step` returns step(state, batch) -> (state, metrics). The batch
holds grad_accum microbatches along its first axis; each microbatch runs
forward_train and its backward, and, as in the JAX step's scan, the
gradients are summed in fp32 over the microbatches and divided by
grad_accum (with grad_accum 1 they stay in the param dtype, as JAX's do).
Metrics are averaged over the microbatches and num_tokens is summed. Only
the params flagged by the trainable mask require gradients, so autograd
never builds the frozen ones' (the tower runs under no_grad besides). The
optimizer then updates the params in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..core.config import ModelConfig
from ..models import videollama2 as vl2
from .data import Batch
from .optimizer import GroupedAdamW, Path, flatten


@dataclass
class TrainState:
    params: dict
    opt_state: dict
    step: int = 0


def init_state(params: dict, tx: GroupedAdamW,
               masters: Optional[Dict[Path, torch.Tensor]] = None
               ) -> TrainState:
    """A fresh state; `masters` ({path: fp32 tensor}) are the fp32
    masters of trained params held narrower (optimizer.py)."""
    return TrainState(params=params, opt_state=tx.init(params, masters),
                      step=0)


def _to_device(a, device, dtype=None) -> torch.Tensor:
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    return t.to(device=device, dtype=dtype, non_blocking=True)


def microbatches(batch: Batch, grad_accum: int):
    """The grad_accum microbatches of a batch, rows [i * mb, (i + 1) * mb)
    each (JAX's reshape to [grad_accum, mb, ...])."""
    n = len(batch.valid_len)
    if n % grad_accum:
        raise ValueError(f"batch of {n} rows does not split into "
                         f"{grad_accum} microbatches")
    mb = n // grad_accum
    for i in range(grad_accum):
        yield Batch(*(a[i * mb:(i + 1) * mb] for a in batch))


def loss_fn(params: dict, cfg: ModelConfig, batch: Batch):
    """forward_train on one microbatch, moved to the params' device;
    floating frames are cast to the params' dtype (JAX's compute dtype),
    uint8 frames are normalized on the device (JAX `_loss_fn`)."""
    ref = params["vision"]["patch_embed"]["kernel"]
    device = ref.device
    frames = _to_device(batch.frames, device)
    if frames.is_floating_point():
        frames = frames.to(ref.dtype)
    return vl2.forward_train(
        params, cfg, frames, _to_device(batch.text_ids, device, torch.long),
        _to_device(batch.is_visual, device),
        _to_device(batch.vis_index, device),
        _to_device(batch.positions, device),
        _to_device(batch.valid_len, device, torch.int32),
        _to_device(batch.labels, device))


def make_train_step(cfg: ModelConfig, tx: GroupedAdamW,
                    trainable: Dict[Path, bool], grad_accum: int = 1):
    """Build step(state, batch) -> (state, metrics). `trainable` ({path:
    bool}, optimizer.trainable_mask) sets requires_grad on the params."""

    def step_fn(state: TrainState, batch: Batch):
        flat = flatten(state.params)
        for p, t in flat.items():
            t.requires_grad_(bool(trainable[p]))
        trained = [p for p in flat if trainable[p]]
        acc: Dict[Path, torch.Tensor] = {}
        msum: Dict[str, Any] = {}
        for mb in microbatches(batch, grad_accum):
            loss, metrics = loss_fn(state.params, cfg, mb)
            loss.backward()
            for p in trained:
                g = flat[p].grad
                flat[p].grad = None
                if g is None:           # not reached by this loss
                    g = torch.zeros_like(flat[p])
                if grad_accum == 1:
                    acc[p] = g
                elif p in acc:
                    acc[p] += g
                else:
                    acc[p] = g.float()
            for k, v in metrics.items():
                msum[k] = msum[k] + v.detach() if k in msum else v.detach()
        if grad_accum == 1:
            grads, metrics = acc, msum
        else:
            grads = {p: g / grad_accum for p, g in acc.items()}
            metrics = {k: v / grad_accum for k, v in msum.items()}
            metrics["num_tokens"] = msum["num_tokens"]
        state.opt_state = tx.step(state.params, grads, state.opt_state)
        state.step += 1
        return state, metrics

    return step_fn
