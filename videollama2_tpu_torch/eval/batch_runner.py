"""Cross-video batched eval runner.

Combines the engine's grouped-media batching (G videos encoded once each,
B >= G prompts decoded together) with threaded media prefetch — the batched
Video-MME serving shape of BASELINE.json config 5. One call drives:

  decode next videos on host threads -> device batch of prompts across
  videos -> greedy decode -> per-item records.
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Tuple

import numpy as np

from ..inference.api import MISTRAL_SYSTEM
from ..inference.engine import GenerationConfig
from ..media.prefetch import prefetch_map
from ..multimodal.tokenizer import tokenizer_multimodal_token
from ..constants import DEFAULT_VIDEO_TOKEN


def run_batched(model, tokenizer, items: Sequence[dict],
                load_media: Callable[[dict], np.ndarray],
                prompts_of: Callable[[dict], List[Tuple[dict, str]]],
                on_result: Callable[[dict, dict, str], None],
                batch_prompts: int = 8, prefetch: int = 4,
                max_new_tokens: int = 128) -> None:
    """items: video-level records. load_media(item) -> [T, H, W, 3].
    prompts_of(item) -> [(meta, prompt_text)]. on_result(item, meta, text).
    """
    cfg = model.config
    eos = tokenizer.eos_token_id
    gen = GenerationConfig(max_new_tokens=max_new_tokens)

    def make_ids(prompt: str) -> list:
        message = [{"role": "user",
                    "content": DEFAULT_VIDEO_TOKEN + "\n" + prompt}]
        if cfg.model_type in ("videollama2", "videollama2_mistral",
                              "videollama2_mixtral"):
            message = [{"role": "system",
                        "content": MISTRAL_SYSTEM}] + message
        text = tokenizer.apply_chat_template(message, tokenize=False,
                                             add_generation_prompt=True)
        return tokenizer_multimodal_token(text, tokenizer,
                                          DEFAULT_VIDEO_TOKEN)

    pending: List[Tuple[dict, dict, list]] = []  # (item, meta, ids)
    tensors: List[np.ndarray] = []
    owners: List[int] = []  # media_group index per pending prompt

    def run(batch):
        b_pending, dev_frames, b_owners = batch
        outs = model.engine.generate(
            [ids for _, _, ids in b_pending], frames=dev_frames, gen=gen,
            eos_token_id=eos, media_group=b_owners)
        for (item, meta, _), out in zip(b_pending, outs):
            text = tokenizer.decode(out, skip_special_tokens=True).strip()
            on_result(item, meta, text)

    # one-deep device pipeline: batch n+1's frames stream host->device
    # (Engine.upload_frames is an async dispatch) while batch n computes,
    # hiding the transfer behind encode+prefill+decode
    in_flight = None

    def flush():
        nonlocal pending, tensors, owners, in_flight
        if not pending:
            return
        dev = model.engine.upload_frames(np.stack(tensors, axis=0))
        batch = (pending, dev, owners)
        pending, tensors, owners = [], [], []
        if in_flight is not None:
            run(in_flight)
        in_flight = batch

    # batches flush only at video boundaries so a video's prompts never
    # split across media groups (batches may exceed batch_prompts by one
    # video's question count)
    for item, tensor in zip(items, prefetch_map(items, load_media,
                                                buffer_size=prefetch,
                                                num_workers=2)):
        gi = len(tensors)
        tensors.append(tensor)
        for meta, prompt in prompts_of(item):
            pending.append((item, meta, make_ids(prompt)))
            owners.append(gi)
        if len(pending) >= batch_prompts:
            flush()
    flush()
    if in_flight is not None:
        run(in_flight)
