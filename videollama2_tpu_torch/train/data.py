"""Training batches (port of the Batch and Collator of
videollama2_tpu/train/data.py).

A Batch is the static-shape training batch: frames and the splice plan of
multimodal/splice.plan_batch with its IGNORE_INDEX-masked labels, as numpy
arrays (step.py moves them to the device). The dataset side of the JAX
module (SupervisedDataset, the preprocess functions and the length-grouped
sampler) needs a tokenizer and media decoding and is not ported yet.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence

import numpy as np

from ..core.config import ModelConfig
from ..multimodal.splice import plan_batch


class Batch(NamedTuple):
    frames: np.ndarray          # [B, T, H, W, 3] (float, or uint8 RGB)
    text_ids: np.ndarray        # [B, S]
    is_visual: np.ndarray
    vis_index: np.ndarray
    positions: np.ndarray
    valid_len: np.ndarray
    labels: np.ndarray


class Collator:
    """Instances {"input_ids", "labels", "frames"} -> a Batch padded to
    seq_len, frames stacked as float32 (JAX `Collator`)."""

    def __init__(self, model_cfg: ModelConfig, seq_len: int):
        self.model_cfg = model_cfg
        self.seq_len = seq_len

    def __call__(self, instances: Sequence[Dict]) -> Batch:
        ids = [list(inst["input_ids"]) for inst in instances]
        labels = [list(inst["labels"]) for inst in instances]
        plan = plan_batch(ids, self.model_cfg.tokens_per_video, self.seq_len,
                          batch_labels=labels)
        frames = np.stack([inst["frames"] for inst in instances], axis=0)
        return Batch(frames=frames.astype(np.float32),
                     text_ids=plan.text_ids, is_visual=plan.is_visual,
                     vis_index=plan.vis_index, positions=plan.positions,
                     valid_len=plan.valid_len, labels=plan.labels)
