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
(models/llm._decode_step_q8). Speculative decoding,
sessions, audio, grouped media and sharding raise NotImplementedError
until their port.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import ModelConfig

from ..models import llm as llm_lib
from ..models import videollama2 as vl2
from ..multimodal import splice as splice_lib
from ..ops import quant as quant_lib
from . import sampling

DEFAULT_BUCKETS = (128, 256, 512, 1024, 2048, 4096)
DECODE_CHUNK = 32


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
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: no CUDA device is available; pass "
                               "device='cpu' to run the plain versions on "
                               "the CPU")
        params = _prepare(params, dtype, self.device)
        if "llm" in params:
            params = dict(params, llm=quant_lib.fuse_qkv(params["llm"]))
        self.params = params

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
        the first frame of each slot is encoded once and broadcast.
        Returns the new token ids per sample, EOS included.
        """
        if audio is not None:
            raise NotImplementedError("audio prompts are not ported yet")
        if media_group is not None:
            raise NotImplementedError("grouped media is not ported yet")
        if return_session:
            raise NotImplementedError("sessions are not ported yet")
        if gen.speculative_k >= 2:
            raise NotImplementedError("speculative decoding is not ported")
        cfg = self.cfg
        eos = eos_token_id if eos_token_id is not None else cfg.llm.eos_token_id
        B = len(batch_input_ids)
        mode = ("text" if frames is None else "image" if image_mode
                else "vision_shared" if share_media else "vision")
        if mode == "vision_shared":
            frames = frames[:1]
        if mode == "image":
            frames = frames[:, :1]

        tpm = cfg.tokens_per_video
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
        elif mode == "vision_shared":
            vis = vl2.encode_frames(params, cfg,
                                    self._frames_to_device(frames),
                                    w8a8=True)
            vis = vis.expand((B,) + tuple(vis.shape[1:]))
            text_emb = llm_lib.embed_tokens(params["llm"], text_ids,
                                            self.dtype)
            embeds = splice_lib.compose_embeds(text_emb, vis, is_visual,
                                               vis_index)
            last, cache = llm_lib.prefill(params["llm"], cfg.llm, embeds,
                                          positions, valid_len, cache,
                                          w8a8=True)
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
        return self._decode_tail(outs, done_np, cache, valid_len, bucket,
                                 first, generator, eos, gen, stop_fn,
                                 stream_cb)

    def _decode_tail(self, outs, done_np, cache, valid_len, bucket, tokens,
                     generator, eos, gen, stop_fn, stream_cb):
        """Chunked decode after the first token. Generated tokens occupy
        cache rows [bucket, max_len)."""
        cfg = self.cfg
        B = len(outs)
        done = torch.from_numpy(done_np).to(self.device)
        budget = self.max_len - bucket
        steps_done = 0
        remaining = min(gen.max_new_tokens - len(outs[0]), budget)
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
                for t in emitted_np[b]:
                    outs[b].append(int(t))
                    if int(t) == eos or (stop_fn is not None
                                         and stop_fn(outs[b])):
                        done_np[b] = True
                        break
                if stream_cb is not None:
                    stream_cb(b, outs[b])
            remaining -= steps
            steps_done += steps
            done = done | torch.from_numpy(done_np).to(self.device)
        return outs
