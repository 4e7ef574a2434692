"""Dynamic request batching for the model worker (port of
videollama2_tpu/serve/batching.py).

The reference worker runs one HF `generate` per HTTP request (reference
serve/model_worker.py:271-300). Decode is weight-bandwidth-bound, so a
batch of 8 costs little more a step than a batch of 1; batching concurrent
requests multiplies a worker's throughput. Requests queue up, a collector
groups compatible ones (same kind, image or vision, and sampling
parameters) inside a small window, pads the batch to a size tier and
streams each row's tokens back to its own request:

  * batch tiers {1, 2, 4, 8}: pad rows are short text-only prompts; in
    grouped vision they point at media group 0 and have no visual slot,
    so padding adds no encode work.
  * grouped media: the distinct media of a group (equal bytes and shape)
    are encoded once each and feed every prompt about them through the
    Engine's `media_group`, so concurrent questions about one video share
    its tower pass.
  * per-request streaming: the engine's stream_cb fans out to
    per-request queues, each capped at its own max_new_tokens.
  * two collector threads, so one group's host preparation (prompt ids,
    the media dedupe, stacking the frames) overlaps the other's generate;
    the Engine runs one generate at a time, so prefill and decode of two
    groups never overlap.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..inference.api import SessionStore, build_prompt_ids
from ..inference.engine import GenerationConfig

BATCH_TIERS = (1, 2, 4, 8)


@dataclass
class _Request:
    instruct: object                  # str | message list
    modal: str                        # 'video' | 'image' | 'text'
    tensor: Optional[np.ndarray]      # [T, H, W, 3] / [T, H*3/2, W] or None
    do_sample: bool
    temperature: float
    top_p: float
    max_new_tokens: int
    out: "queue.Queue" = field(default_factory=queue.Queue)

    @property
    def group_key(self):
        # text rides with video batches (pad-like rows without media);
        # images need image_mode so they batch on their own
        kind = "image" if self.modal == "image" else "vision"
        return (kind, self.do_sample, round(self.temperature, 3),
                round(self.top_p, 3))


class DynamicBatcher:
    """Collects concurrent generate requests into batched engine calls."""

    def __init__(self, model, tokenizer, max_batch: int = 8,
                 window_ms: float = 30.0, inflight: int = 2):
        self.model = model
        self.tokenizer = tokenizer
        self.max_batch = max_batch
        self.window_s = window_ms / 1e3
        self._pending: list[_Request] = []
        self._cv = threading.Condition()
        self._stats = {"batches": 0, "requests": 0, "max_group": 0}
        self._closed = False
        self._threads = [threading.Thread(target=self._loop, daemon=True)
                         for _ in range(max(1, inflight))]
        for t in self._threads:
            t.start()

    # -- client side -------------------------------------------------------

    def submit(self, instruct, modal: str, tensor, *, do_sample=False,
               temperature=0.2, top_p=0.9, max_new_tokens=256,
               **_unsupported) -> "queue.Queue":
        """Enqueue a request; returns a queue of ("chunk"|"done"|"error",
        text) events. Other generation keywords (speculative_k, which only
        applies to batch-1 greedy decoding) are accepted and ignored: the
        worker forwards one kwargs dict to either path."""
        req = _Request(instruct=instruct, modal=modal, tensor=tensor,
                       do_sample=bool(do_sample),
                       temperature=float(temperature), top_p=float(top_p),
                       max_new_tokens=int(max_new_tokens))
        with self._cv:
            if self._closed:
                req.out.put(("error", "the batcher is closed"))
                return req.out
            self._pending.append(req)
            self._stats["requests"] += 1
            self._cv.notify()
        return req.out

    def close(self) -> None:
        """Stop the collector threads after their current groups (the
        Engine they hold is released with them); queued requests get an
        error."""
        with self._cv:
            self._closed = True
            pending, self._pending = self._pending, []
            self._cv.notify_all()
        for r in pending:
            r.out.put(("error", "the batcher is closed"))
        for t in self._threads:
            t.join()

    @property
    def stats(self):
        with self._cv:
            return dict(self._stats)

    # -- collector ---------------------------------------------------------

    def _take_group(self) -> Optional[list]:
        """Wait for work, then gather same-key requests within the window;
        None once the batcher is closed."""
        with self._cv:
            while not self._pending and not self._closed:
                self._cv.wait()
            if self._closed:
                return None
            deadline = time.monotonic() + self.window_s
            key = self._pending[0].group_key
            while True:
                n = sum(1 for r in self._pending if r.group_key == key)
                if n >= self.max_batch:
                    break
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                self._cv.wait(timeout=remaining)
            group, rest = [], []
            for r in self._pending:
                if r.group_key == key and len(group) < self.max_batch:
                    group.append(r)
                else:
                    rest.append(r)
            self._pending = rest
            return group

    def _loop(self):
        while True:
            group = self._take_group()
            if group is None:
                return
            try:
                self._run_group(group)
            except Exception as e:  # noqa: BLE001 - fail the whole group
                for r in group:
                    r.out.put(("error", f"{type(e).__name__}: {e}"))

    # -- batched generation ------------------------------------------------

    def _run_group(self, group: list):
        cfg = self.model.config
        engine = self.model.engine
        kind = group[0].group_key[0]
        with self._cv:  # the collector threads share the counters
            self._stats["batches"] += 1
            self._stats["max_group"] = max(self._stats["max_group"],
                                           len(group))

        # pad up to the next tier with text-only rows (no media, no encode)
        B = next((t for t in BATCH_TIERS if t >= len(group)),
                 self.max_batch)
        n_real = len(group)
        n_pad = B - n_real

        batch_ids = [build_prompt_ids(r.instruct, cfg, self.tokenizer,
                                      r.modal) for r in group]
        if n_pad:
            pad_ids = build_prompt_ids("ok", cfg, self.tokenizer, "text")
            batch_ids += [pad_ids] * n_pad

        frames = None
        media_group = None
        image_mode = False
        if kind == "image":
            # the engine's image mode reads frames[:, :1], one frame a row
            image_mode = True
            rows = []
            for r in group:
                arr = np.asarray(r.tensor)
                if arr.shape[-1] != 3:
                    # planar I420 wire (media/wire.py): [T, H*3/2, W]
                    rows.append(arr[:1])
                else:
                    rows.append(arr[:1] if arr.ndim == 4 else arr[None])
            rows += [np.zeros_like(rows[0])] * n_pad
            frames = np.stack(rows)           # [B, 1, H, W, 3] | [B, 1, R, W]
        else:
            # grouped vision: each distinct media once; every row points at
            # its media (text rows at 0: their plan has no visual slot)
            media, idx, seen = [], [], {}
            for r in group:
                if r.tensor is None:
                    idx.append(0)
                    continue
                digest = SessionStore.media_digest(r.tensor)
                if digest not in seen:
                    seen[digest] = len(media)
                    media.append(np.asarray(r.tensor))
                idx.append(seen[digest])
            idx += [0] * n_pad
            if media:
                frames = np.stack(media)
                media_group = idx

        gen = GenerationConfig(
            do_sample=group[0].do_sample, temperature=group[0].temperature,
            top_p=group[0].top_p,
            max_new_tokens=max(r.max_new_tokens for r in group))

        emitted_len = [0] * n_real

        def stream_cb(b, ids):
            if b >= n_real:
                return
            r = group[b]
            ids = ids[:r.max_new_tokens]
            if len(ids) > emitted_len[b]:
                emitted_len[b] = len(ids)
                text = self.tokenizer.decode(ids, skip_special_tokens=True)
                r.out.put(("chunk", text))

        outs = engine.generate(batch_ids, frames=frames, gen=gen,
                               eos_token_id=self.tokenizer.eos_token_id,
                               media_group=media_group,
                               image_mode=image_mode, stream_cb=stream_cb)
        for b, r in enumerate(group):
            ids = outs[b][:r.max_new_tokens]
            text = self.tokenizer.decode(ids, skip_special_tokens=True)
            r.out.put(("done", text.strip()))
