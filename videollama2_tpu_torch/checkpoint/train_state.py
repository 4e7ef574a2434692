"""The train state on disk, with auto-resume (port of save_train_state,
latest_step and restore_train_state of
videollama2_tpu/checkpoint/orbax_io.py, without orbax).

`save_train_state` writes the whole TrainState (train/step.py: the params,
the GroupedAdamW state and the step) as one `state.pt` with torch.save,
into `<directory>/<step>/`: it writes a temporary directory beside it and
renames it into place, so a process killed during a save leaves the newest
complete step readable. It keeps the newest `max_to_keep` steps (orbax's
CheckpointManager default of the JAX package, 3). `restore_train_state`
reads a step with torch.load(weights_only=True): the params and the fp32
masters of the params trained in a narrower dtype are copied into the
template's tensors (their device and dtype); the Adam moments go
to the template's device and keep their saved dtype, which the optimizer's
dtype promotion may have widened past the fresh state's (optimizer.py), so
a resumed run continues bit for bit.

Under a mesh (a parallel/sharding.Layout) the state holds shards: a save
gathers one leaf at a time to the mesh's first rank, which writes the same
file an unsharded run writes (no rank holds more than one whole leaf on
its card), and a restore takes each rank's shard of every saved leaf. So a
state saved on one mesh resumes on any other, or on none, as JAX's orbax
restore re-pins to any mesh.
"""

from __future__ import annotations

import os
import shutil
import tempfile
from typing import Optional

import torch

from ..parallel.sharding import walk

STATE_FILE = "state.pt"


def _steps(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d) for d in os.listdir(directory)
                  if d.isdigit()
                  and os.path.exists(os.path.join(directory, d, STATE_FILE)))


def _flat(tree: dict, prefix=()) -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out["/".join(prefix + (k,))] = v
    return out


def _entries(tree: dict) -> dict:
    """{"a/b/leaf": the dict holding the leaf}."""
    return {path: entry for path, entry, _, _ in walk(tree)}


def save_train_state(directory: str, state, max_to_keep: int = 3,
                     layout=None) -> Optional[str]:
    """Write `state` (a train/step.TrainState) as step state.step; returns
    the step's directory. With a layout every rank of the mesh calls it
    and the first writes (the others return None)."""
    step = int(state.step)
    entries = _entries(state.params)

    def whole(tensors: dict) -> dict:
        if layout is None:
            return tensors
        out = {}
        for k, t in tensors.items():
            full = layout.unshard(k, t, entries[k])
            if layout.mesh.is_main:
                out[k] = full.cpu()
        return out

    payload = {
        "step": step,
        "params": whole({k: t.detach()
                         for k, t in _flat(state.params).items()}),
        "count": dict(state.opt_state["count"]),
        "mu": whole({"/".join(p): t
                     for p, t in state.opt_state["mu"].items()}),
        "nu": whole({"/".join(p): t
                     for p, t in state.opt_state["nu"].items()}),
        "master": whole({"/".join(p): t for p, t in
                         state.opt_state.get("master", {}).items()}),
    }
    if layout is not None and not layout.mesh.is_main:
        layout.barrier()
        return None
    os.makedirs(directory, exist_ok=True)
    final = os.path.join(directory, str(step))
    tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=directory)
    try:
        torch.save(payload, os.path.join(tmp, STATE_FILE))
        if os.path.exists(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
    finally:
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
    for old in _steps(directory)[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, str(old)))
    if layout is not None:
        layout.barrier()
    return final


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


@torch.no_grad()
def restore_train_state(directory: str, template, step: Optional[int] = None,
                        layout=None):
    """Restore step `step` (the latest when None) into `template` (a
    TrainState of the same params and optimizer groups; with a layout, of
    this rank's shards) and return it."""
    if step is None:
        step = latest_step(directory)
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {directory}")
    saved = torch.load(os.path.join(directory, str(step), STATE_FILE),
                       map_location="cpu", weights_only=True, mmap=True)
    params = _flat(template.params)
    entries = _entries(template.params)

    def mine(k: str, t: torch.Tensor) -> torch.Tensor:
        return t if layout is None else layout.shard(k, t, entries[k])
    if set(saved["params"]) != set(params):
        raise ValueError(f"step {step} in {directory} holds other params "
                         "than the run's: "
                         f"{sorted(set(saved['params']) ^ set(params))[:5]}")
    for k, t in params.items():
        src = mine(k, saved["params"][k])
        if tuple(src.shape) != tuple(t.shape):
            raise ValueError(f"{k}: saved {tuple(src.shape)}, the run's "
                             f"{tuple(t.shape)}")
        t.copy_(src)
    opt = template.opt_state
    if set(saved["count"]) != set(opt["count"]):
        raise ValueError(f"step {step} was saved with optimizer groups "
                         f"{sorted(saved['count'])}, the run has "
                         f"{sorted(opt['count'])}")
    opt["count"] = {g: int(c) for g, c in saved["count"].items()}
    for moment in ("mu", "nu"):
        for p, t in opt[moment].items():
            k = "/".join(p)
            opt[moment][p] = mine(k, saved[moment][k]).to(t.device,
                                                          copy=True)
    masters = opt.get("master", {})
    saved_masters = saved.get("master", {})
    if set(saved_masters) != {"/".join(p) for p in masters}:
        raise ValueError(f"step {step} was saved with fp32 masters of "
                         f"{sorted(saved_masters)[:5]}, the run keeps them "
                         f"of {sorted('/'.join(p) for p in masters)[:5]}")
    for p, t in masters.items():
        k = "/".join(p)
        t.copy_(mine(k, saved_masters[k]))
    template.step = int(saved["step"])
    return template
