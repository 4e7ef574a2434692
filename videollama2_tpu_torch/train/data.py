"""Supervised data pipeline (port of videollama2_tpu/train/data.py):
target masking, the lazy dataset, collation and the length-grouped batch
sampler.

Parity: reference videollama2/train.py:138-390, as the JAX package has it:
  * `preprocess_plain` (pretrain): only the answer is supervised; the modal
    token's position gets IGNORE_INDEX (train.py:138-164);
  * `preprocess` (SFT): per-round instruction masking via incremental
    chat-template length diffs (train.py:167-210); the tokenizer is the
    caller's object (it needs `__call__` and `apply_chat_template`);
  * `preprocess_multimodal`: move the modal tag to the question head
    (train.py:213-234);
  * `SupervisedDataset`: a lazy JSON list in the reference's annotation
    format, media decoded by the port's media layer (PNG, JPEG, PPM, BMP,
    GIF, frame directories and, where libavcodec builds, containers);
  * `Collator`: right-pad, truncate to the sequence length, the static
    splice plan of multimodal/splice.plan_batch, frames stacked as float32;
  * `LengthGroupedBatchSampler`: the modality-grouped, length-bucketed
    batches of the reference's LengthGroupedSampler
    (videollama2_trainer.py:150-220), drawn from np.random.default_rng as
    in JAX, so a seed gives the JAX package's index batches.

One difference from JAX: its dataset replaces a sample whose media fails
to decode by one drawn from the unseeded global `random`, whatever the
error. Here the stand-in comes from a `random.Random(seed)` of the
dataset's own, the failing file is named in a warning, and
NotImplementedError (a format or variant the port does not decode)
propagates: an unreadable format fails the run instead of being skipped.
"""

from __future__ import annotations

import copy
import json
import os
import random
import warnings
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Sequence

import numpy as np

from ..constants import IGNORE_INDEX, MODAL_INDEX_MAP
from ..core.config import ModelConfig
from ..media.preprocess import process_image, process_video
from ..multimodal.splice import plan_batch
from ..multimodal.tokenizer import tokenizer_multimodal_token


def preprocess_plain(sources: Sequence, tokenizer,
                     modal_token: Optional[str] = None) -> Dict:
    """Pretrain-stage masking (train.py:138-164)."""
    input_ids, targets = [], []
    for source in sources:
        assert len(source) == 2
        assert modal_token in source[0]["value"]
        conversation = " ".join([s["value"] for s in source])
        ids = tokenizer_multimodal_token(conversation, tokenizer, modal_token)
        ids = np.asarray(ids, dtype=np.int64)
        target = ids.copy()
        target[ids == MODAL_INDEX_MAP[modal_token]] = IGNORE_INDEX
        input_ids.append(ids)
        targets.append(target)
    return dict(input_ids=input_ids, labels=targets)


def preprocess(sources: Sequence, tokenizer,
               modal_token: Optional[str] = None) -> Dict:
    """SFT per-round masking (train.py:167-210)."""
    roles = {"human": "user", "gpt": "assistant"}
    input_ids, targets = [], []
    for source in sources:
        if roles[source[0]["from"]] != "user":
            source = source[1:]
        message = [{"role": roles[s["from"]], "content": s["value"]}
                   for s in source]
        conversation = tokenizer.apply_chat_template(
            message, tokenize=False, add_generation_prompt=False)
        ids = np.asarray(tokenizer_multimodal_token(conversation, tokenizer,
                                                    modal_token),
                         dtype=np.int64)
        target = ids.copy()

        assert len(source) % 2 == 0, \
            f"Invalid conversation length {len(source)}."
        cur = 0
        message = []
        for idx, sentence in enumerate(source):
            if idx % 2 == 1:
                tmp = [{"role": roles[source[idx - 1]["from"]],
                        "content": source[idx - 1]["value"]},
                       {"role": roles[sentence["from"]],
                        "content": sentence["value"]}]
                instruction = tokenizer.apply_chat_template(
                    message + tmp[:1], tokenize=False,
                    add_generation_prompt=True)
                convo = tokenizer.apply_chat_template(
                    message + tmp, tokenize=False,
                    add_generation_prompt=False)
                instruction_len = len(tokenizer_multimodal_token(
                    instruction, tokenizer, modal_token))
                conversation_len = len(tokenizer_multimodal_token(
                    convo, tokenizer, modal_token))
                target[cur:instruction_len] = IGNORE_INDEX
                cur = conversation_len
                message += tmp
        input_ids.append(ids)
        targets.append(target)
    return dict(input_ids=input_ids, labels=targets)


def preprocess_multimodal(sources: Sequence, modal_token: str) -> Sequence:
    """Move the modal tag to the question head (train.py:213-234)."""
    assert modal_token in MODAL_INDEX_MAP, \
        f"Unsupported modal token {modal_token}."
    for source in sources:
        for sentence in source:
            if modal_token in sentence["value"]:
                sentence["value"] = sentence["value"].replace(
                    modal_token, "").strip()
                sentence["value"] = modal_token + "\n" + sentence["value"]
                sentence["value"] = sentence["value"].strip()
    return sources


@dataclass
class DataArguments:
    """Parity: train.py:87-99."""
    data_path: List[str] = field(default_factory=list)
    data_folder: Optional[str] = None
    is_multimodal: bool = True
    is_pretraining: bool = False
    num_frames: Optional[int] = None
    image_aspect_ratio: str = "pad"
    model_max_length: int = 2048


class SupervisedDataset:
    """Lazy JSON dataset (train.py:237-337). A sample whose media fails to
    decode is replaced by one drawn from random.Random(seed), with a
    warning naming the file; NotImplementedError propagates."""

    def __init__(self, data_path: List[str], tokenizer,
                 data_args: DataArguments, model_cfg: ModelConfig,
                 seed: int = 0):
        self.list_data_dict: List[dict] = []
        for dp in data_path:
            with open(dp) as f:
                self.list_data_dict.extend(json.load(f))
        self.tokenizer = tokenizer
        self.data_args = data_args
        self.model_cfg = model_cfg
        self.rng = random.Random(seed)

    def __len__(self):
        return len(self.list_data_dict)

    @property
    def modality_lengths(self) -> List[int]:
        """Signed word-count lengths: positive = multimodal, negative = text
        (videollama2_trainer parity via train.py:264-271)."""
        out = []
        for sample in self.list_data_dict:
            n = sum(len(conv["value"].split())
                    for conv in sample["conversations"])
            out.append(n if ("image" in sample or "video" in sample) else -n)
        return out

    def __getitem__(self, i: int) -> Dict:
        sample = self.list_data_dict[i]
        da = self.data_args
        # data-args override wins; else the model config's num_frames (the
        # reference stamps data num_frames into the model config,
        # train.py:508-532, so the two always agree)
        num_frames = (self.model_cfg.num_frames if da.num_frames is None
                      else da.num_frames)
        vis_cfg = self.model_cfg.vision
        sources = [copy.deepcopy(sample["conversations"])]

        frames = None
        modal_token = None
        path = None
        try:
            if "image" in sample:
                path = os.path.join(da.data_folder or "", sample["image"])
                img = process_image(path, vis_cfg,
                                    aspect_ratio=da.image_aspect_ratio)
                # expand to num_frames (videollama2_arch.py:119-120)
                frames = np.broadcast_to(
                    img[:1], (num_frames,) + img.shape[1:]).copy()
                modal_token = "<image>"
                sources = preprocess_multimodal(sources, modal_token)
            elif "video" in sample:
                path = os.path.join(da.data_folder or "", sample["video"])
                frames = process_video(path, vis_cfg,
                                       aspect_ratio=da.image_aspect_ratio,
                                       num_frames=num_frames)
                modal_token = "<video>"
                sources = preprocess_multimodal(sources, modal_token)
        except NotImplementedError:
            raise
        except Exception as e:  # noqa: BLE001 (the reference's retry)
            backup_idx = self.rng.randint(0, len(self) - 1)
            warnings.warn(f"sample {i}: cannot decode {path} ({e!r}); "
                          f"sample {backup_idx} stands in for it")
            return self[backup_idx]

        if da.is_pretraining:
            data = preprocess_plain(sources, self.tokenizer, modal_token)
        else:
            data = preprocess(sources, self.tokenizer, modal_token)

        out = dict(input_ids=data["input_ids"][0], labels=data["labels"][0])
        if frames is None and da.is_multimodal:
            # text-only sample in a multimodal corpus: zero frames slot
            # (train.py:334-336 zeros-image equivalent)
            s = vis_cfg.image_size
            frames = np.zeros((num_frames, s, s, 3), dtype=np.float32)
        out["frames"] = frames
        return out


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


class LengthGroupedBatchSampler:
    """Modality-grouped, length-bucketed batch sampler.

    Parity: videollama2_trainer.py:128-220 — split multimodal vs text samples,
    sort each megabatch by length, interleave, shuffle megabatches.
    """

    def __init__(self, batch_size: int, lengths: List[int], seed: int = 0,
                 world_size: int = 1):
        self.batch_size = batch_size
        self.lengths = lengths
        self.seed = seed
        self.world_size = world_size

    def __iter__(self):
        rng = np.random.default_rng(self.seed)
        lengths = self.lengths
        mm = [i for i, l in enumerate(lengths) if l > 0]
        lang = [i for i, l in enumerate(lengths) if l <= 0]
        mega = self.batch_size * self.world_size

        def megabatches(indices):
            indices = list(rng.permutation(indices))
            out = []
            for i in range(0, len(indices), mega):
                chunk = indices[i:i + mega]
                chunk.sort(key=lambda j: abs(lengths[j]), reverse=True)
                out.append(chunk)
            return out

        batches = megabatches(mm) + megabatches(lang)
        order = rng.permutation(len(batches))
        for bi in order:
            chunk = batches[bi]
            for i in range(0, len(chunk), self.batch_size):
                sub = chunk[i:i + self.batch_size]
                if len(sub) == self.batch_size:
                    yield sub

    def __len__(self):
        return len(self.lengths) // self.batch_size
