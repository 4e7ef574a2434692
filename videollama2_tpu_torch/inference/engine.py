"""Generation engine: multimodal prefill + chunked decode (port of
videollama2_tpu/inference/engine.py: floating, int8-packed or
folded-int4-packed weights, a bf16 or int8 KV cache, on one device).

Prompts are padded to static buckets, the KV cache is preallocated at
`max_len` and written in place, and decoding runs in chunks of
`decode_chunk` steps whose EOS bookkeeping stays on the device: the host
reads the emitted tokens once per chunk, then applies EOS/`stop_fn` and
streams. Every packed dense the engine reaches runs W8A8 or W4A8
(ops/layers.dense), as the JAX Engine's programs do under its
quant_inference and w8a8_prefill contexts; with int8 (or int4) packs on
every LLM projection, decode runs on the layered int8 (or int4) kernels
(models/llm._decode_step_q8). Greedy requests with speculative_k >= 2
decode by prompt-lookup speculation (inference/speculative.py: K-slot
verify passes, models/llm.decode_verify), token-identical to plain greedy;
`generate(..., return_session=True)` and `generate_continue` keep a batch-1
chat's cache for its next turn. On the audio-visual model, `audio` (BEATs
fbank features) gives the "audio" and "av" prefills; the decode tail,
sessions and speculation after them are shared. `media_group` encodes G
distinct media once each for B >= G prompts (the dynamic batcher's grouped
vision). Every mode runs the connector one media at a time
(models/videollama2.aggregate_each), so a media's tokens do not depend on
what it is batched with. The entry points run one call at a time (`_one_at_a_time`).
Sharding raises NotImplementedError until its port.
"""

from __future__ import annotations

import functools
import threading
from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..constants import (AUDIO_TOKEN_INDEX, IMAGE_TOKEN_INDEX,
                         VIDEO_TOKEN_INDEX)
from ..core.config import ModelConfig

from ..models import llm as llm_lib
from ..models import videollama2 as vl2
from ..multimodal import splice as splice_lib
from ..ops import quant as quant_lib
from . import sampling
from . import speculative as spec

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
DECODE_CHUNK = 32
# the rows up to which a verify pass takes the W8A8/W4A8 branch of packed
# weights: the JAX Engine verifies under quant_inference, whose dense takes
# the serving branch for at most 64 rows and dequantizes above
VERIFY_W8A8_ROWS = 64


@dataclass
class GenerationConfig:
    """Generation defaults of the reference: greedy unless do_sample,
    temperature 0.2, top_p 0.9."""
    do_sample: bool = False
    temperature: float = 0.2
    top_p: float = 0.9
    max_new_tokens: int = 2048
    seed: int = 0
    speculative_k: int = 0


@dataclass
class Session:
    """A batch-1 chat's state after a turn (JAX `Session`): the live KV
    cache, so that the next turn feeds only its new tokens through verify
    passes (Engine.generate_continue) instead of encoding the media and
    prefilling the whole history again. RoPE positions go on across turns
    (valid_len + steps_done), so a continued turn gives the tokens of a
    fresh generate over the whole history. The cache is written in place:
    a session that generate_continue took is used up (its cache is None)."""
    cache: Optional[llm_lib.KVCache]
    bucket: int
    steps_done: int          # tokens embedded at cache rows [bucket, ...)
    valid_len: np.ndarray    # [1] spliced prompt length of turn 1
    last_token: int          # newest emitted token (its k/v not written)
    token_history: list      # prompt ids (modal tags included) and after


def check_device(device) -> torch.device:
    """torch.device(device); raises when it is a CUDA device and none is
    available (the port never falls back to the CPU on its own)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Engine: no CUDA device is available; pass "
                           "device='cpu' to run the plain versions on "
                           "the CPU")
    return device


def _one_at_a_time(method):
    """Run an Engine entry point under the Engine's lock. A generate is
    hundreds of PyTorch calls from Python a decode step, each releasing and
    retaking the interpreter lock, so calls from several host threads (the
    model worker's request threads, the batcher's collectors) interleave at
    ~5x the cost of running them in turn; in turn they run at full speed
    and callers queue on the lock."""
    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with self._lock:
            return method(self, *args, **kwargs)
    return run


def _prepare(tree, dtype, device):
    """Move every leaf to `device`, casting floating leaves to `dtype`
    (pack scales included, as the JAX Engine does; int8 and int4 weight
    bytes stay int8; no copy for leaves already there in that dtype)."""
    if isinstance(tree, dict):
        return {k: _prepare(v, dtype, device) for k, v in tree.items()}
    t = torch.as_tensor(tree)
    return t.to(device=device,
                dtype=dtype if t.is_floating_point() else t.dtype)


class Engine:
    """Generation over a fixed ModelConfig + params on one device."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 dtype=torch.bfloat16, max_len: int = 4096,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 decode_chunk: int = DECODE_CHUNK, kv_bits: int = 16,
                 device="cuda", shard_fn: Optional[Callable] = None):
        if kv_bits not in (8, 16):
            raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
        if shard_fn is not None:
            raise NotImplementedError("sharded engines are not ported yet")
        if cfg.llm.is_moe:
            raise NotImplementedError("MoE decoders are not ported yet")
        self.cfg = cfg
        self.dtype = dtype
        self.kv_bits = kv_bits
        if kv_bits == 8:
            # the JAX Engine rounds up to a multiple of 256 under kv8 (a
            # rule of its Pallas kernel's blocks); rounding alike keeps the
            # two packages' caches the same shape
            max_len = -(-max_len // 256) * 256
        self.max_len = max_len
        self.buckets = tuple(b for b in buckets if b <= max_len)
        self.decode_chunk = decode_chunk
        self.device = check_device(device)
        params = _prepare(params, dtype, self.device)
        if "llm" in params:
            params = dict(params, llm=quant_lib.fuse_qkv(params["llm"]))
        self.params = params
        self._lock = threading.Lock()

    # -- frames --------------------------------------------------------------

    def upload_frames(self, frames: np.ndarray) -> torch.Tensor:
        """Start a host->device copy of a frame batch (pinned, non-blocking
        on CUDA) and return the device tensor; issue it for the next batch
        while the current one computes to hide the transfer."""
        t = torch.from_numpy(np.ascontiguousarray(frames))
        if self.device.type == "cuda":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _frames_to_device(self, frames) -> torch.Tensor:
        """uint8 stays uint8 (normalized on device); floats take the engine
        dtype; tensors already on the device pass through."""
        if not isinstance(frames, torch.Tensor):
            frames = self.upload_frames(frames)
        frames = frames.to(self.device)
        if frames.dtype != torch.uint8:
            frames = frames.to(self.dtype)
        return frames

    # -- public API ----------------------------------------------------------

    def pick_bucket(self, length: int) -> int:
        for b in self.buckets:
            if length <= b:
                return b
        if length <= self.max_len:
            return self.max_len
        raise ValueError(f"prompt length {length} > max_len {self.max_len}")

    @_one_at_a_time
    @torch.inference_mode()
    def generate(self, batch_input_ids: List[Sequence[int]],
                 frames=None, audio=None,
                 gen: GenerationConfig = GenerationConfig(),
                 eos_token_id: Optional[int] = None,
                 stop_fn: Optional[Callable[[List[int]], bool]] = None,
                 stream_cb: Optional[Callable[[int, List[int]], None]] = None,
                 image_mode: bool = False, share_media: bool = False,
                 media_group: Optional[Sequence[int]] = None,
                 return_session: bool = False):
        """Generate continuations for a batch of tokenized prompts.

        batch_input_ids may hold negative modal tags. frames: one slot per
        sample, [B, T, H, W, 3] (uint8 or float) or uint8 I420
        [B, T, H*3/2, W], as numpy or a device tensor (see upload_frames);
        with share_media, [1, ...] shared by every prompt; with image_mode,
        the first frame of each slot is encoded once and broadcast. audio
        (the audio-visual model): normalized fbank features [B,
        audio.max_frames, 128] (numpy or a tensor), cast to the engine dtype
        before BEATs; with frames too the prompt is audio-visual, its
        <video> tag before <audio>, and image_mode and share_media do not
        apply. media_group (B ints in [0, G)): frames hold G distinct media
        [G, T, ...], each encoded once, and prompt b takes the tokens of
        media media_group[b] (a text-only prompt has no visual slot, so
        its index is inert). Returns the new token ids per sample, EOS
        included; with return_session (batch 1 only), (ids, Session) for
        the next turn's generate_continue.
        """
        cfg = self.cfg
        if audio is not None and cfg.audio is None:
            raise ValueError("audio given to a model without an audio "
                             "branch (cfg.audio is None)")
        if return_session and len(batch_input_ids) != 1:
            raise ValueError("sessions are batch-1 (multi-turn chat)")
        eos = eos_token_id if eos_token_id is not None else cfg.llm.eos_token_id
        B = len(batch_input_ids)
        if audio is not None:
            mode = "audio" if frames is None else "av"
        else:
            mode = ("text" if frames is None else "image" if image_mode
                    else "vision_shared" if share_media
                    else "vision_grouped" if media_group is not None
                    else "vision")
        if mode == "vision_grouped":
            group = np.asarray(media_group, dtype=np.int64)
            if group.shape != (B,) or group.min() < 0 \
                    or group.max() >= frames.shape[0]:
                raise ValueError(f"media_group must hold {B} indices into "
                                 f"the {frames.shape[0]} media, got "
                                 f"{list(media_group)}")
        if mode == "vision_shared":
            frames = frames[:1]
        if mode == "image":
            frames = frames[:, :1]

        tpm = cfg.tokens_per_video
        if audio is not None:
            # an audio-only prompt holds no visual tag's tokens
            tpv = tpm if mode == "av" else 0
            tpm = {IMAGE_TOKEN_INDEX: tpv, VIDEO_TOKEN_INDEX: tpv,
                   AUDIO_TOKEN_INDEX: cfg.tokens_per_audio}
        lengths = [splice_lib.spliced_length(ids, tpm)
                   for ids in batch_input_ids]
        bucket = self.pick_bucket(max(lengths))
        plan = splice_lib.plan_batch(batch_input_ids, tpm, bucket)

        def dev(a, dtype):
            return torch.from_numpy(a).to(self.device, dtype)

        text_ids = dev(plan.text_ids, torch.long)
        is_visual = dev(plan.is_visual, torch.bool)
        vis_index = dev(plan.vis_index, torch.int32)
        valid_len = dev(plan.valid_len, torch.int32)
        positions = dev(plan.positions, torch.int32)
        cache = llm_lib.init_cache(cfg.llm, B, self.max_len, self.dtype,
                                   kv_bits=self.kv_bits, device=self.device)
        params = self.params
        if mode == "text":
            embeds = llm_lib.embed_tokens(params["llm"], text_ids, self.dtype)
            last, cache = llm_lib.prefill(params["llm"], cfg.llm, embeds,
                                          positions, valid_len, cache,
                                          w8a8=True)
        elif mode in ("vision_shared", "vision_grouped"):
            # one encode a distinct media, its tokens given to each prompt
            feats = vl2.frame_features(params, cfg,
                                       self._frames_to_device(frames),
                                       w8a8=True)
            vis = vl2.aggregate_each(params, cfg, feats)
            if mode == "vision_shared":
                vis = vis.expand((B,) + tuple(vis.shape[1:]))
            else:
                vis = vis.index_select(0, dev(group, torch.long))
            text_emb = llm_lib.embed_tokens(params["llm"], text_ids,
                                            self.dtype)
            embeds = splice_lib.compose_embeds(text_emb, vis, is_visual,
                                               vis_index)
            last, cache = llm_lib.prefill(params["llm"], cfg.llm, embeds,
                                          positions, valid_len, cache,
                                          w8a8=True)
        elif mode in ("audio", "av"):
            fbank = torch.as_tensor(audio).to(self.device, self.dtype)
            last, cache = vl2.prefill_audio_visual(
                params, cfg,
                self._frames_to_device(frames) if mode == "av" else None,
                fbank, text_ids, is_visual, vis_index, positions, valid_len,
                cache, w8a8=True)
        else:
            last, cache = vl2.prefill_multimodal(
                params, cfg, self._frames_to_device(frames), text_ids,
                is_visual, vis_index, positions, valid_len, cache,
                broadcast_image=(mode == "image"), w8a8=True)
        logits = llm_lib.lm_logits(params["llm"], cfg.llm, last, w8a8=True)

        generator = None
        if gen.do_sample:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(gen.seed)
        first = sampling.select_token(generator, logits, gen.do_sample,
                                      gen.temperature, gen.top_p)
        outs: List[List[int]] = [[int(t)] for t in first.tolist()]
        done_np = np.array([o[-1] == eos for o in outs])
        if stream_cb is not None:
            for b in range(B):
                stream_cb(b, outs[b])
        contexts = [[t for t in ids if t >= 0] for ids in batch_input_ids]
        outs, cache = self._decode_tail(
            outs, done_np, cache, valid_len, bucket, 0, first, generator,
            eos, gen, stop_fn, stream_cb, contexts)
        if return_session:
            # token i of outs sits at row bucket + i and outs[-1] is not
            # written yet, so exactly len(outs) - 1 rows belong to the
            # sequence (a chunk or verify round that ends on EOS writes rows
            # beyond, which are overwritten before any mask reaches them)
            session = Session(
                cache=cache, bucket=bucket, steps_done=len(outs[0]) - 1,
                valid_len=plan.valid_len.copy(), last_token=outs[0][-1],
                token_history=list(batch_input_ids[0]) + list(outs[0]))
            return outs, session
        return outs

    def _verify(self, tokens, cache, valid_len, bucket, step0):
        """One verify pass over tokens [B, K] (JAX `_get_verify`) at
        frontier step0 (an int, or a [B] tensor of per-row frontiers).
        Returns each slot's greedy id [B, K], the last slot's logits
        [B, V] (a continuation's first token) and the cache."""
        ids = torch.as_tensor(np.asarray(tokens, dtype=np.int64),
                              device=self.device)
        B, K = ids.shape
        te = llm_lib.embed_tokens(self.params["llm"], ids, self.dtype)
        logits, cache = llm_lib.decode_verify(
            self.params["llm"], self.cfg.llm, te, cache, valid_len, bucket,
            step0, w8a8=B * K <= VERIFY_W8A8_ROWS)
        return torch.argmax(logits, dim=-1), logits[:, -1], cache

    @staticmethod
    def _emit(outs, done_np, b, tokens, eos, stop_fn) -> None:
        """Append row b's tokens up to EOS or stop_fn."""
        for t in tokens:
            outs[b].append(t)
            if t == eos or (stop_fn is not None and stop_fn(outs[b])):
                done_np[b] = True
                break

    def _decode_speculative(self, outs, done_np, cache, valid_len, bucket,
                            eos, gen, stop_fn, stream_cb, context, step0=0):
        """Greedy batch-1 speculative decode (JAX `_decode_speculative`):
        k-slot verify rounds while k rows of cache remain. Returns (outs,
        cache, steps_done, done_np); the caller's plain loop finishes any
        tail of the cache budget."""
        k = gen.speculative_k
        budget = self.max_len - bucket
        while (not done_np[0] and len(outs[0]) < gen.max_new_tokens
               and step0 + k <= budget):
            last = outs[0][-1]
            drafts = spec.ngram_propose(context + outs[0], k - 1)
            drafts += [last] * (k - 1 - len(drafts))  # padding: rejected
            greedy, _, cache = self._verify([[last] + drafts], cache,
                                            valid_len, bucket, step0)
            emitted, accepted = spec.accept_drafts(drafts,
                                                   greedy[0].tolist())
            # never emit past max_new_tokens
            emitted = emitted[:gen.max_new_tokens - len(outs[0])]
            self._emit(outs, done_np, 0, emitted, eos, stop_fn)
            if stream_cb is not None:
                stream_cb(0, outs[0])
            step0 += accepted + 1
        return outs, cache, step0, done_np

    def _decode_speculative_batched(self, outs, done_np, cache, valid_len,
                                    bucket, eos, gen, stop_fn, stream_cb,
                                    contexts, step0=0):
        """Per-row speculative decode for B > 1 (JAX
        `_decode_speculative_batched`). Each row drafts from its own
        context and advances by its own acceptance count, so rows write
        and attend at their own cache frontiers. Rows that are done or out
        of room ride along re-verifying their last token with their
        frontier frozen; what they write lies past their committed rows
        and is never read. Runs to completion: k-slot rounds while some
        live row has k rows of room, then 1-slot rounds for the budget
        tail. Returns (outs, cache)."""
        B = len(outs)
        budget = self.max_len - bucket
        steps = np.full(B, step0, np.int64)

        def live(b, room_rows):
            return (not done_np[b] and len(outs[b]) < gen.max_new_tokens
                    and steps[b] + room_rows <= budget)

        for k_round in (gen.speculative_k, 1):
            while any(live(b, k_round) for b in range(B)):
                tokens, drafts_by_row = [], []
                for b in range(B):
                    last = outs[b][-1]
                    drafts = []
                    if live(b, k_round):
                        drafts = spec.ngram_propose(contexts[b] + outs[b],
                                                    k_round - 1)
                    drafts += [last] * (k_round - 1 - len(drafts))
                    drafts_by_row.append(drafts)
                    tokens.append([last] + drafts)
                greedy, _, cache = self._verify(
                    tokens, cache, valid_len, bucket,
                    torch.from_numpy(steps).to(self.device))
                greedy = greedy.tolist()
                for b in range(B):
                    if not live(b, k_round):
                        continue
                    emitted, accepted = spec.accept_drafts(drafts_by_row[b],
                                                           greedy[b])
                    emitted = emitted[:gen.max_new_tokens - len(outs[b])]
                    self._emit(outs, done_np, b, emitted, eos, stop_fn)
                    if stream_cb is not None:
                        stream_cb(b, outs[b])
                    steps[b] += accepted + 1
        return outs, cache

    def _decode_tail(self, outs, done_np, cache, valid_len, bucket,
                     steps_done, tokens, generator, eos, gen, stop_fn,
                     stream_cb, contexts):
        """Decode after the first token from step steps_done: speculation
        when the request is greedy with speculative_k >= 2, then chunked
        decode for what is left. Generated tokens occupy cache rows
        [bucket, max_len). contexts: each row's prompt ids, the drafts'
        source. Returns (outs, cache)."""
        B = len(outs)
        if gen.speculative_k >= 2 and not gen.do_sample:
            if B > 1:
                # per-row frontiers do not fit the lockstep loop below
                return self._decode_speculative_batched(
                    outs, done_np, cache, valid_len, bucket, eos, gen,
                    stop_fn, stream_cb, contexts, steps_done)
            outs, cache, steps_done, done_np = self._decode_speculative(
                outs, done_np, cache, valid_len, bucket, eos, gen, stop_fn,
                stream_cb, contexts[0], steps_done)
            tokens = torch.tensor([outs[0][-1]], device=self.device)
        cfg = self.cfg
        done = torch.from_numpy(done_np).to(self.device)
        budget = self.max_len - bucket
        remaining = min(gen.max_new_tokens - len(outs[0]),
                        budget - steps_done)
        while remaining > 0 and not done_np.all():
            steps = min(self.decode_chunk, remaining)
            emitted = []
            for s in range(steps):
                # rows already done feed the (possibly negative) EOS id;
                # their outputs are discarded, so clamp it to a valid row
                te = llm_lib.embed_tokens(self.params["llm"],
                                          tokens.clamp(min=0)[:, None],
                                          self.dtype)
                logits, cache = llm_lib.decode_step(
                    self.params["llm"], cfg.llm, te, cache, valid_len,
                    bucket, steps_done + s, w8a8=True)
                nxt = sampling.select_token(generator, logits, gen.do_sample,
                                            gen.temperature, gen.top_p)
                nxt = torch.where(done, torch.full_like(nxt, eos), nxt)
                done = done | (nxt == eos)
                emitted.append(nxt)
                tokens = nxt
            emitted_np = torch.stack(emitted, dim=1).cpu().numpy()
            for b in range(B):
                if done_np[b]:
                    continue
                self._emit(outs, done_np, b, [int(t) for t in emitted_np[b]],
                           eos, stop_fn)
                if stream_cb is not None:
                    stream_cb(b, outs[b])
            remaining -= steps
            steps_done += steps
            done = done | torch.from_numpy(done_np).to(self.device)
        return outs, cache

    @_one_at_a_time
    @torch.inference_mode()
    def generate_continue(self, session: Session, new_ids: Sequence[int],
                          gen: GenerationConfig = GenerationConfig(),
                          eos_token_id: Optional[int] = None,
                          stop_fn: Optional[Callable] = None,
                          stream_cb: Optional[Callable] = None):
        """Continue a Session with a new text-only turn (prefix caching;
        JAX `generate_continue`).

        Feeds [last_token] + new_ids through verify passes of up to
        VERIFY_W8A8_ROWS slots into the session's cache (the media stays encoded, the
        history prefilled), then decodes as generate does. The tokens are
        those of a fresh generate over the whole history. Raises
        ValueError when the turn and one more token do not fit the cache
        (callers fall back to a fresh generate), when new_ids hold a modal
        tag (media goes through generate) and when the session was used
        up by an earlier call. Returns (new token ids, the next Session).
        """
        eos = (eos_token_id if eos_token_id is not None
               else self.cfg.llm.eos_token_id)
        if any(t < 0 for t in new_ids):
            raise ValueError("continuation turns are text-only; re-send "
                             "media via generate()")
        if session.cache is None:
            raise ValueError("this session was continued already; continue "
                             "the Session that call returned")
        feed = [session.last_token] + [int(t) for t in new_ids]
        budget = self.max_len - session.bucket
        if session.steps_done + len(feed) + 1 > budget:
            raise ValueError("session cache exhausted: "
                             f"{session.steps_done + len(feed)} generated+fed"
                             f" tokens > budget {budget}")
        valid_len = torch.from_numpy(session.valid_len).to(self.device)
        cache, session.cache = session.cache, None
        steps_done = session.steps_done
        # W8A8 quantizes each row on its own and the mask is slot-causal,
        # so a slot's arithmetic does not depend on how the feed is split
        # (the JAX Engine's 32/8/1 chunks are static shapes for XLA)
        for pos in range(0, len(feed), VERIFY_W8A8_ROWS):
            _, last_logits, cache = self._verify(
                [feed[pos:pos + VERIFY_W8A8_ROWS]], cache, valid_len,
                session.bucket, steps_done + pos)
        steps_done += len(feed)

        generator = None
        if gen.do_sample:
            generator = torch.Generator(device=self.device)
            generator.manual_seed(gen.seed)
        first = sampling.select_token(generator, last_logits, gen.do_sample,
                                      gen.temperature, gen.top_p)
        outs = [[int(first[0])]]
        done_np = np.array([outs[0][0] == eos])
        if stream_cb is not None:
            stream_cb(0, outs[0])
        history = session.token_history + list(new_ids)
        feed_end = steps_done            # rows committed after the feed
        outs, cache = self._decode_tail(
            outs, done_np, cache, valid_len, session.bucket, steps_done,
            first, generator, eos, gen, stop_fn, stream_cb,
            [[t for t in history if t >= 0]])
        # as in generate: len(outs) - 1 decode rows after the feed are the
        # sequence's
        return outs, Session(
            cache=cache, bucket=session.bucket,
            steps_done=feed_end + len(outs[0]) - 1,
            valid_len=session.valid_len, last_token=outs[0][-1],
            token_history=history + list(outs[0]))
