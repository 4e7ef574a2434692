"""Training loop (port of videollama2_tpu/train/trainer.py without orbax),
on one device or on a mesh.

A Trainer steps either over a dataset (`dataset=`, a train/data
SupervisedDataset: `train()` builds each global batch of
per_device_batch_size x gradient_accumulation_steps samples on the host,
from a seeded permutation an epoch or the length-grouped sampler, and
collates it) or over an iterable of Batches its caller built
(`train(batches)`, the synthetic-batch benchmarks), up to total_steps:
max_steps, else the dataset's batches times num_epochs. It writes a
train_log.jsonl line every log_steps steps (loss, accuracy, num_tokens,
sec_per_step and data_s, the host seconds a step spent building its
batch: decode, resize, tokenize, collate; there is no prefetch, as in
JAX). Every save_steps steps and at the end it saves the pretrain stage's
projector (adapter-{step}/, under tune_mm_mlp_adapter), the LoRA split
(lora-{step}/, under lora_enable; checkpoint/projector_io) and the whole
train state (checkpoints/<step>/, checkpoint/train_state.py; the newest 3
are kept). A new Trainer over the same output_dir resumes from the newest
step. SIGTERM during a step makes the run save at that step and return.

One difference from JAX: a resumed run skips the batches the saved steps
consumed, in the same seeded order, so it trains on the batches an
uninterrupted run would; JAX restarts the epoch at its first batch.

The params must all lie on `device` ("cuda" by default): the Trainer
never moves them and never falls back to the CPU on its own.
compute_dtype, when set, is the dtype the model computes in: the floating
leaves (not those of int8 or int4 packs, nor LoRA adapters, which stay
fp32) are cast to it on their device. Under a compute_dtype narrower than
fp32 each trained leaf keeps an fp32 master in the optimizer state, made
from the leaf as it was given (an fp32 load is not rounded, a bf16
checkpoint's values are widened), with fp32 Adam moments;
each step updates the master and sets the leaf to it rounded
(optimizer.py), and the saves (adapter-{step}/, lora-{step}/) write the
masters. JAX's Trainer keeps the params in the dtype they were loaded in
(fp32) and casts only the frames; here the model runs in bf16 on the
card, as the reference's --bf16 runs under DeepSpeed, whose optimizer
also keeps fp32 masters.

The mesh (mesh_data / mesh_fsdp / mesh_tensor / mesh_seq, JAX's fields)
needs a process group
(parallel/mesh.init_distributed, one rank a card under torchrun); without
one the degrees must be 1 and the Trainer runs on one device as above.
Under a process group the Trainer shards `params` in place (each leaf of
the caller's dict becomes this rank's shard, on the rank's card, so the
whole tree is not kept there), the global batch is
per_device_batch_size x gradient_accumulation_steps x data x fsdp
samples of which each rank builds only its own rows, the step runs sharded
(train/step.py), and only the mesh's first rank logs and writes; the saves
gather one leaf at a time to it (checkpoint/train_state.py), in the format
an unsharded run writes, so a run resumes on any mesh.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal
import threading
import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import projector_io, train_state
from ..core.config import ModelConfig
from ..inference.engine import check_device
from ..ops.quant import PACKS
from ..parallel import mesh as mesh_lib
from ..parallel import sharding as sh
from . import data as data_lib
from . import optimizer as opt_lib
from .optimizer import Path
from . import step as step_lib


@dataclass
class TrainerConfig:
    output_dir: str = "./output"
    per_device_batch_size: int = 4
    gradient_accumulation_steps: int = 1
    num_epochs: int = 1
    max_steps: Optional[int] = None
    seq_len: int = 2048
    save_steps: int = 500
    log_steps: int = 10
    seed: int = 42
    group_by_modality_length: bool = False
    compute_dtype: Optional[str] = None
    # mesh
    mesh_data: int = 1
    mesh_fsdp: int = -1
    mesh_tensor: int = 1
    mesh_seq: int = 1


def trainer_mesh(cfg: TrainerConfig) -> Optional[mesh_lib.Mesh]:
    """The Trainer's mesh: None without a process group, where every
    degree must be 1 (fsdp -1, "the rest of the devices", is one)."""
    degrees = dict(data=cfg.mesh_data, fsdp=cfg.mesh_fsdp,
                   tensor=cfg.mesh_tensor, seq=cfg.mesh_seq)
    if dist.is_initialized():
        return mesh_lib.make_mesh(**degrees)
    over = [f"{k} {v}" for k, v in degrees.items()
            if v > 1 or (k == "fsdp" and v not in (1, -1))]
    if over:
        raise ValueError(f"mesh degrees {', '.join(over)} need a process "
                         "group: launch under torchrun (parallel/mesh."
                         "init_distributed)")
    return None


def _shard_in_place(tree: dict, layout: sh.Layout, device,
                    prefix: str = "") -> None:
    """Replace each leaf of `tree` by this rank's shard on `device`."""
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _shard_in_place(v, layout, device, path)
        else:
            tree[k] = layout.shard(path, v.detach(), tree).to(device)


def _cast(tree: dict, dtype: torch.dtype, trained: Dict[Path, bool],
          prefix: Path = ()) -> Dict[Path, torch.Tensor]:
    """Cast the floating leaves of `tree` to dtype in place (the dict
    entries are replaced), leaving int8 / int4 packs and LoRA adapters as
    they are; when dtype is narrower than fp32, returns the fp32 masters of
    the trained leaves, {path: the leaf as given, widened to fp32}."""
    keep = {pack for pack, _ in PACKS.values()} | {"lora"}
    masters = {}
    for k, v in tree.items():
        path = prefix + (k,)
        if isinstance(v, dict):
            if k not in keep:
                masters.update(_cast(v, dtype, trained, path))
        elif v.is_floating_point():
            if trained[path] and dtype.itemsize < 4:
                # fp32 as given: the loaded fp32 tensor itself, or a bf16
                # checkpoint's values widened (exactly)
                masters[path] = v.detach().float()
            if v.dtype != dtype:
                tree[k] = v.detach().to(dtype)
    return masters


def _with_masters(tree: dict, masters: Dict[Path, torch.Tensor],
                  prefix: Path = ()) -> dict:
    """`tree` with each leaf that has an fp32 master replaced by it."""
    return {k: _with_masters(v, masters, prefix + (k,))
            if isinstance(v, dict) else masters.get(prefix + (k,), v)
            for k, v in tree.items()}


class Trainer:
    def __init__(self, model_cfg: ModelConfig, params: dict,
                 opt_cfg: opt_lib.OptimizerConfig,
                 trainer_cfg: TrainerConfig, device="cuda",
                 dataset: Optional[data_lib.SupervisedDataset] = None):
        self.mesh = trainer_mesh(trainer_cfg)
        self.layout = None
        self.device = check_device(device if self.mesh is None
                                   else self.mesh.device or device)
        if self.mesh is not None:
            self.layout = sh.Layout(self.mesh, model_cfg)
            _shard_in_place(params, self.layout, self.device)
        want = self.device
        elsewhere = sorted({str(t.device) for t in
                            opt_lib.flatten(params).values()
                            if t.device.type != want.type
                            or want.index not in (None, t.device.index)})
        if elsewhere:
            raise ValueError(f"Trainer on {self.device}: params on "
                             f"{elsewhere}; move them there first (pass "
                             f"device='cpu' to train on the CPU)")
        masters = {}
        if trainer_cfg.compute_dtype:
            masters = _cast(params, getattr(torch, trainer_cfg.compute_dtype),
                            opt_lib.trainable_mask(params, opt_cfg))
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.dataset = dataset
        self.collator = data_lib.Collator(model_cfg, trainer_cfg.seq_len)
        if trainer_cfg.max_steps:
            self.total_steps = trainer_cfg.max_steps
        elif dataset is not None:
            self.total_steps = max(len(dataset) // self._global_batch()
                                   * trainer_cfg.num_epochs, 1)
        else:
            self.total_steps = 1
        self.opt_cfg = dataclasses.replace(opt_cfg,
                                           total_steps=self.total_steps)
        self.tx = opt_lib.build_optimizer(params, self.opt_cfg)
        self.state = step_lib.init_state(params, self.tx, masters)
        del masters
        self.step_fn = step_lib.make_train_step(
            model_cfg, self.tx, opt_lib.trainable_mask(params, self.opt_cfg),
            grad_accum=trainer_cfg.gradient_accumulation_steps,
            mesh=self.mesh, sequence_parallel=trainer_cfg.mesh_seq > 1)
        self._last_saved = -1
        self._preempted = False

        # auto-resume (train.py:554-557)
        ckpt_dir = os.path.join(trainer_cfg.output_dir, "checkpoints")
        step = train_state.latest_step(ckpt_dir)
        self.start_step = 0
        if step is not None:
            self._say(f"Resuming from checkpoint step {step}")
            train_state.restore_train_state(ckpt_dir, self.state, step,
                                            self.layout)
            self.start_step = self._last_saved = step

    @property
    def is_main(self) -> bool:
        """Whether this rank logs and writes (the mesh's first rank)."""
        return self.mesh is None or self.mesh.is_main

    def _say(self, msg: str) -> None:
        if self.is_main:
            print(msg, flush=True)

    def _global_batch(self) -> int:
        n = 1 if self.mesh is None else (self.mesh.shape["data"]
                                         * self.mesh.shape["fsdp"])
        return (self.cfg.per_device_batch_size
                * self.cfg.gradient_accumulation_steps * n)

    def _index_batches(self, epoch: int):
        """The dataset's global batches of an epoch, as index lists."""
        gb = self._global_batch()
        if self.cfg.group_by_modality_length:
            yield from data_lib.LengthGroupedBatchSampler(
                gb, self.dataset.modality_lengths, seed=self.cfg.seed + epoch)
        else:
            rng = np.random.default_rng(self.cfg.seed + epoch)
            order = rng.permutation(len(self.dataset))
            for i in range(0, len(order) - gb + 1, gb):
                yield list(order[i:i + gb])

    def _batches(self, batches: Optional[Iterable[data_lib.Batch]]):
        """(batch, host seconds to build it) for the steps after
        start_step: the first start_step batches are skipped unbuilt. Under
        a mesh each batch holds this rank's rows only: a given global batch
        is sliced (shard_batch), a dataset batch built from those rows."""
        skip = self.start_step
        accum = self.cfg.gradient_accumulation_steps
        if batches is not None:
            for batch in batches:
                if skip:
                    skip -= 1
                    continue
                if self.mesh is not None:
                    batch = sh.shard_batch(batch, self.mesh, accum)
                yield batch, 0.0
            return
        if self.dataset is None:
            raise ValueError("Trainer.train() needs a dataset (dataset=) or "
                             "an iterable of Batches")
        for epoch in range(self.cfg.num_epochs):
            for idxs in self._index_batches(epoch):
                if skip:
                    skip -= 1
                    continue
                t0 = time.perf_counter()
                if self.mesh is not None:
                    idxs = [idxs[r] for r in sh.batch_rows(
                        self.mesh, len(idxs), accum)]
                batch = self.collator([self.dataset[int(i)] for i in idxs])
                yield batch, time.perf_counter() - t0

    def train(self, batches: Optional[Iterable[data_lib.Batch]] = None
              ) -> step_lib.TrainState:
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        log_path = os.path.join(self.cfg.output_dir, "train_log.jsonl")
        previous = self._install_preemption_handler()
        t0, data_s = time.time(), 0.0
        try:
            with open(log_path if self.is_main else os.devnull, "a") as logf:
                todo = self._batches(batches)
                while self.state.step < self.total_steps:
                    got = next(todo, None)
                    if got is None:
                        break
                    batch, built_s = got
                    data_s += built_s
                    self.state, metrics = self.step_fn(self.state, batch)
                    step = self.state.step
                    if self._stop_now():
                        # preemption-safe shutdown (JAX's): save at this
                        # step and return; a new Trainer resumes from it
                        self._say(f"preemption signal received: saving at "
                                  f"step {step} and exiting")
                        self.save(step)
                        return self.state
                    if step % self.cfg.log_steps == 0:
                        m = {k: float(v) for k, v in metrics.items()}
                        m.update(step=step,
                                 sec_per_step=(time.time() - t0)
                                 / self.cfg.log_steps,
                                 data_s=data_s / self.cfg.log_steps)
                        t0, data_s = time.time(), 0.0
                        self._say(f"step {step}: loss={m['loss']:.4f} "
                                  f"acc={m['accuracy']:.3f} "
                                  f"({m['sec_per_step']:.2f}s/step, batch "
                                  f"built in {m['data_s']:.2f}s)")
                        logf.write(json.dumps(m) + "\n")
                        logf.flush()
                    if step % self.cfg.save_steps == 0:
                        self.save(step)
            self.save(self.state.step)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)
        return self.state

    def _stop_now(self) -> bool:
        """Whether a SIGTERM reached this rank (under a mesh: any rank, so
        that every rank saves at the same step)."""
        if self.layout is None:
            return self._preempted
        flag = torch.tensor(float(self._preempted), device=self.device)
        return bool(self.layout.all_reduce_sum(flag) > 0)

    def _install_preemption_handler(self):
        """SIGTERM sets a flag the loop reads after each step; returns the
        handler it replaced (None off the main thread, where no handler
        can be installed and training runs without the preemption save)."""
        self._preempted = False
        if threading.current_thread() is not threading.main_thread():
            return None

        def _on_term(signum, frame):
            self._preempted = True
        return signal.signal(signal.SIGTERM, _on_term)

    def save(self, step: int) -> None:
        """adapter-{step}/ (tune_mm_mlp_adapter), lora-{step}/
        (lora_enable) and the train state in checkpoints/<step>/."""
        if step == self._last_saved:
            return
        self._last_saved = step
        params = _with_masters(self.state.params,
                               self.state.opt_state["master"])
        saves = self.opt_cfg.tune_mm_mlp_adapter or self.opt_cfg.lora_enable
        if saves and self.layout is not None:
            # the connector whole (one leaf at a time) on the first rank;
            # LoRA adapters are replicated
            full = {path: self.layout.unshard(path, t, entry)
                    for path, entry, _, t in sh.walk(
                        params["connector"], "connector")}
            connector = {}
            for path, t in full.items():
                opt_lib.set_path(connector, tuple(path.split("/")[1:]),
                                 t.cpu())
            params = dict(params, connector=connector)
        if saves and self.is_main:
            if self.opt_cfg.tune_mm_mlp_adapter:
                # pretrain stage: projector-only save
                # (videollama2_trainer.py:320-341)
                projector_io.save_projector_only(
                    os.path.join(self.cfg.output_dir, f"adapter-{step}"),
                    params["connector"])
            if self.opt_cfg.lora_enable:
                projector_io.export_lora_split(
                    os.path.join(self.cfg.output_dir, f"lora-{step}"),
                    params["llm"], params["connector"], self.model_cfg)
        train_state.save_train_state(
            os.path.join(self.cfg.output_dir, "checkpoints"), self.state,
            layout=self.layout)
        self._say(f"saved checkpoint at step {step}")
