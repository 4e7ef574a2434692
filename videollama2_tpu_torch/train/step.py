"""The training step (port of videollama2_tpu/train/step.py), on one
device or on a mesh.

`make_train_step` returns step(state, batch) -> (state, metrics). The batch
holds grad_accum microbatches along its first axis; each microbatch runs
forward_train and its backward, and, as in the JAX step's scan, the
gradients are summed in fp32 over the microbatches and divided by
grad_accum (with grad_accum 1 they stay in the param dtype, as JAX's do).
Metrics are averaged over the microbatches and num_tokens is summed. Only
the params flagged by the trainable mask require gradients, so autograd
never builds the frozen ones' (the tower runs under no_grad besides). The
optimizer then updates the params in place.

With a mesh (parallel/mesh.py) the state holds this rank's shards
(`init_sharded_state`) and the step takes this rank's data x fsdp rows of
each microbatch (parallel/sharding.shard_batch of the global batch, which
JAX's jitted step takes whole). The loss of a microbatch is the mean over
the global microbatch's supervised tokens: each rank divides its sum by
the all-reduced count, so the ranks' gradients add up to the global
mean's. The fsdp shards' gradients come reduce-scattered from the layers'
gathers; every trained leaf's gradient is then summed over data and seq
(and fsdp, where the leaf is not fsdp-sharded), so Adam moments and fp32
masters exist only for the rank's shards (ZeRO), and the clip takes the
global norm over every rank (parallel/sharding.Layout).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..constants import IGNORE_INDEX
from ..core.config import ModelConfig
from ..models import llm as llm_lib
from ..models import videollama2 as vl2
from ..parallel import sharding as sh
from .data import Batch
from .optimizer import GroupedAdamW, Path, entry_of, flatten


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


def init_sharded_state(mesh, params: dict, tx: GroupedAdamW,
                       cfg: ModelConfig) -> TrainState:
    """A fresh state of this rank's shards of `params` (JAX
    `init_sharded_state`): the shards go to the mesh's device, and the
    optimizer state mirrors them (ZeRO). Pass a host tree, so no rank holds
    the whole tree on its card."""
    local = sh.shard_params(mesh, params, cfg)
    if mesh.device is not None:
        local = _tree_to(local, mesh.device)
    return init_state(local, tx)


def _tree_to(tree: dict, device) -> dict:
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def loss_fn(params: dict, cfg: ModelConfig, batch: Batch,
            num_tokens: Optional[torch.Tensor] = None, remat=True):
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
        _to_device(batch.labels, device), num_tokens=num_tokens,
        remat=remat)


def _global_tokens(mb: Batch, mesh, device) -> torch.Tensor:
    """The supervised tokens of the global microbatch: this rank's rows'
    count summed over data x fsdp (seq ranks hold the same rows)."""
    n = torch.tensor(int((np.asarray(mb.labels)[:, 1:] != IGNORE_INDEX)
                         .sum()), dtype=torch.int64, device=device)
    return sh.all_reduce_(n, mesh, ("data", "fsdp"))


def make_train_step(cfg: ModelConfig, tx: GroupedAdamW,
                    trainable: Dict[Path, bool], grad_accum: int = 1,
                    mesh=None, sequence_parallel: bool = False,
                    remat=True):
    """Build step(state, batch) -> (state, metrics). `trainable` ({path:
    bool}, optimizer.trainable_mask) sets requires_grad on the params.
    With a mesh the state holds shards (init_sharded_state) and `batch` is
    this rank's rows of the global batch (shard_batch(batch, mesh,
    grad_accum)); sequence_parallel turns on Ulysses sequence parallelism
    over the mesh's seq axis. remat is the LLM's (models/llm.forward:
    True, "dots" or False), as JAX's make_train_step takes it."""
    llm_lib.remat_kwargs(remat)  # an unknown policy raises here
    layout = None if mesh is None else sh.Layout(mesh, cfg)
    sp_on = sequence_parallel and mesh is not None

    def step_fn(state: TrainState, batch: Batch):
        with sh.use_mesh(mesh), sh.sequence_parallel(sp_on):
            return _step(state, batch)

    def _step(state: TrainState, batch: Batch):
        flat = flatten(state.params)
        for p, t in flat.items():
            t.requires_grad_(bool(trainable[p]))
        trained = [p for p in flat if trainable[p]]
        acc: Dict[Path, torch.Tensor] = {}
        msum: Dict[str, Any] = {}
        device = next(iter(flat.values())).device
        for mb in microbatches(batch, grad_accum):
            n = None if mesh is None else _global_tokens(mb, mesh, device)
            loss, metrics = loss_fn(state.params, cfg, mb, n, remat)
            if loss.requires_grad:  # nothing trains (stage 1, identity)
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
        if layout is not None:
            for p in trained:
                layout.sync_grad("/".join(p), acc[p],
                                 entry_of(state.params, p))
            for k in ("loss", "accuracy"):
                msum[k] = sh.all_reduce_(msum[k].float(), mesh,
                                         sh.DATA_AXES)
        if grad_accum == 1:
            grads, metrics = acc, msum
        else:
            grads = {p: g / grad_accum for p, g in acc.items()}
            metrics = {k: v / grad_accum for k, v in msum.items()}
            metrics["num_tokens"] = msum["num_tokens"]
        state.opt_state = tx.step(state.params, grads, state.opt_state,
                                  layout)
        state.step += 1
        return state, metrics

    return step_fn
