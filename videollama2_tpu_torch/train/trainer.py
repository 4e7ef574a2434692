"""Training loop on one device (port of videollama2_tpu/train/trainer.py
without the mesh and without orbax).

`Trainer.train` steps over an iterable of Batches (each holding
gradient_accumulation_steps microbatches) up to max_steps, writes a
train_log.jsonl line every log_steps steps and, every save_steps steps and
at the end, saves for the pretrain stage (tune_mm_mlp_adapter) the
projector alone (adapter-{step}/) and under lora_enable the LoRA split
(lora-{step}/: the peft adapters, the projector and config.json,
checkpoint/projector_io.export_lora_split, which the loader's path (a)
reads back). Saving and resuming the full train state is not ported yet.
The params must all lie on `device` ("cuda" by default): the Trainer
never moves them and never falls back to the CPU on its own.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from dataclasses import dataclass
from typing import Iterable

from ..checkpoint import projector_io
from ..core.config import ModelConfig
from ..inference.engine import check_device
from . import optimizer as opt_lib
from . import step as step_lib
from .data import Batch


@dataclass
class TrainerConfig:
    output_dir: str = "./output"
    gradient_accumulation_steps: int = 1
    max_steps: int = 1
    save_steps: int = 500
    log_steps: int = 10


class Trainer:
    def __init__(self, model_cfg: ModelConfig, params: dict,
                 opt_cfg: opt_lib.OptimizerConfig,
                 trainer_cfg: TrainerConfig, device="cuda"):
        self.device = check_device(device)
        want = self.device
        elsewhere = sorted({str(t.device) for t in
                            opt_lib.flatten(params).values()
                            if t.device.type != want.type
                            or want.index not in (None, t.device.index)})
        if elsewhere:
            raise ValueError(f"Trainer on {self.device}: params on "
                             f"{elsewhere}; move them there first (pass "
                             f"device='cpu' to train on the CPU)")
        self.model_cfg = model_cfg
        self.cfg = trainer_cfg
        self.opt_cfg = dataclasses.replace(opt_cfg,
                                           total_steps=trainer_cfg.max_steps)
        self.tx = opt_lib.build_optimizer(params, self.opt_cfg)
        self.state = step_lib.init_state(params, self.tx)
        self.step_fn = step_lib.make_train_step(
            model_cfg, self.tx, opt_lib.trainable_mask(params, self.opt_cfg),
            grad_accum=trainer_cfg.gradient_accumulation_steps)
        self._last_saved = -1

    def train(self, batches: Iterable[Batch]) -> step_lib.TrainState:
        os.makedirs(self.cfg.output_dir, exist_ok=True)
        log_path = os.path.join(self.cfg.output_dir, "train_log.jsonl")
        t0 = time.time()
        with open(log_path, "a") as logf:
            for batch in batches:
                if self.state.step >= self.cfg.max_steps:
                    break
                self.state, metrics = self.step_fn(self.state, batch)
                step = self.state.step
                if step % self.cfg.log_steps == 0:
                    m = {k: float(v) for k, v in metrics.items()}
                    m.update(step=step, sec_per_step=(time.time() - t0)
                             / self.cfg.log_steps)
                    t0 = time.time()
                    print(f"step {step}: loss={m['loss']:.4f} "
                          f"acc={m['accuracy']:.3f} "
                          f"({m['sec_per_step']:.2f}s/step)")
                    logf.write(json.dumps(m) + "\n")
                    logf.flush()
                if step % self.cfg.save_steps == 0:
                    self.save(step)
        self.save(self.state.step)
        return self.state

    def save(self, step: int) -> None:
        """The pretrain stage's projector-only save, adapter-{step}/, and
        the LoRA split save, lora-{step}/."""
        if step == self._last_saved:
            return
        self._last_saved = step
        if self.opt_cfg.tune_mm_mlp_adapter:
            projector_io.save_projector_only(
                os.path.join(self.cfg.output_dir, f"adapter-{step}"),
                self.state.params["connector"])
        if self.opt_cfg.lora_enable:
            projector_io.export_lora_split(
                os.path.join(self.cfg.output_dir, f"lora-{step}"),
                self.state.params["llm"], self.state.params["connector"],
                self.model_cfg)
