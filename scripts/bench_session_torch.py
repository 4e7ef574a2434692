#!/usr/bin/env python3
"""Multi-turn latency on the PyTorch port: a prefix-cached session's second
turn against the first, which encodes the video and prefills the prompt
(port of scripts/bench_session.py).

A chat user's turn 2 and later: a fresh generate runs the tower and the
prefill of the whole history again; Engine.generate_continue feeds only
the new turn's tokens into the session's cache (verify passes). Turn 1 is
encode + prefill + 16 tokens of a 16-frame video question; turn 2 feeds 24
new tokens and decodes 16.

Sizes (SESS_SIZE): "7b", the default on a GPU, is VideoLLaMA2-7B-16F
(CLIP-L/336 + STC + Mistral-7B) at full width with the JAX script's tree:
int8 LLM packs (int8 head) and a bf16 tower (utils/synthetic
quantize_vision=False), a bf16 KV cache, bucket the spliced prompt rounded
up to 128 and 256 rows after it. The weights are the port's seeded random
ones (synthetic_params, seed 0), not JAX's constant fills, under which
every logit ties. "tiny" (core/config.tiny_model, fp32, seeded random
weights; bucket 64, max_len 128) is what PLATFORM=cpu runs, on the CPU.
There the prompt's ids are drawn below the tiny vocabulary's 512 (the JAX
script's 10..899 fall outside it, where its embedding lookup fills NaN).
Without a GPU and without PLATFORM=cpu the script raises.

Usage, from the repository root:

    python3 scripts/bench_session_torch.py             # on a CUDA GPU
    PLATFORM=cpu python3 scripts/bench_session_torch.py

Prints the card's name and power limit (on a GPU), the JAX script's
`[sess-bench]` line on stderr and its JSON line (size, bucket,
turn1_fresh_s, turn2_cached_s, turn2_speedup_vs_fresh).
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

NEW_TOKENS = 16


def build(size: str, device: str):
    """(cfg, params, dtype) of a size: "7b" (int8 LLM, bf16 tower) or
    "tiny" (floating fp32)."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    if size == "tiny":
        cfg = cfglib.tiny_model()
        return cfg, synthetic_params(cfg, dtype=torch.float32, device=device,
                                     seed=0), torch.float32
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=16)
    return cfg, synthetic_params(cfg, dtype=torch.bfloat16, device=device,
                                 seed=0, llm_bits=8,
                                 quantize_vision=False), torch.bfloat16


def inputs(cfg, on_gpu: bool):
    """The JAX script's seeded inputs: one uint8 RGB video, turn 1's
    prompt (BOS, 20 ids, the video, 10 ids), turn 2's 24 ids, and the
    bucket (the spliced prompt rounded up to 128 on a GPU, 64 on the
    CPU)."""
    from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
    rng = np.random.default_rng(0)
    T, H = cfg.num_frames, cfg.vision.image_size
    hi = min(900, cfg.llm.vocab_size)
    frames = rng.integers(0, 255, (1, T, H, H, 3), dtype=np.uint8)
    prompt1 = [1] + [int(x) for x in rng.integers(10, hi, 20)] \
        + [VIDEO_TOKEN_INDEX] + [int(x) for x in rng.integers(10, hi, 10)]
    turn2 = [int(x) for x in rng.integers(10, hi, 24)]
    spliced = len(prompt1) - 1 + cfg.tokens_per_video
    bucket = -(-spliced // 128) * 128 if on_gpu else 64
    return frames, prompt1, turn2, bucket


def engine(cfg, params, dtype, device, bucket):
    from videollama2_tpu_torch.inference.engine import Engine
    return Engine(cfg, params, dtype=dtype, buckets=(bucket,),
                  max_len=bucket + 256 if device == "cuda" else 128,
                  decode_chunk=NEW_TOKENS, device=device)


def run(eng, frames, prompt1, turn2, iters: int, hook=None) -> dict:
    """A warm-up of both turns, then `iters` timed pairs: turn 1 (a fresh
    generate with return_session) and turn 2 (generate_continue on its
    session). hook(label, fn) runs each Engine call ("turn 1", "turn 2";
    fn() by default). Returns the medians and the last pair's tokens."""
    from videollama2_tpu_torch.inference.engine import GenerationConfig
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    hook = hook or (lambda label, fn: fn())

    def turn1():
        return hook("turn 1", lambda: eng.generate(
            [prompt1], frames=frames, gen=gen, eos_token_id=-1,
            return_session=True))

    def turn2_of(sess):
        return hook("turn 2", lambda: eng.generate_continue(
            sess, turn2, gen=gen, eos_token_id=-1))

    _, sess = turn1()
    turn2_of(sess)
    fresh_s, cont_s = [], []
    for _ in range(iters):
        t0 = time.perf_counter()
        ans1, sess = turn1()
        fresh_s.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        ans2, _ = turn2_of(sess)
        cont_s.append(time.perf_counter() - t0)
    return {"turn1_fresh_s": float(np.median(fresh_s)),
            "turn2_cached_s": float(np.median(cont_s)),
            "turn1_tokens": ans1[0], "turn2_tokens": ans2[0]}


def main() -> None:
    device = cs.script_device("bench_session_torch")
    on_gpu = device == "cuda"
    if on_gpu:
        print(cs.card(), flush=True)
    size = os.environ.get("SESS_SIZE", "7b" if on_gpu else "tiny")
    cfg, params, dtype = build(size, device)
    frames, prompt1, turn2, bucket = inputs(cfg, on_gpu)
    eng = engine(cfg, params, dtype, device, bucket)
    del params
    res = run(eng, frames, prompt1, turn2, iters=4 if on_gpu else 2)
    fresh, cont = res["turn1_fresh_s"], res["turn2_cached_s"]
    print(f"[sess-bench] turn-1 (encode+prefill+16 tok): {fresh:.3f}s; "
          f"turn-2 cached ({len(turn2)} new toks + 16 out): {cont:.3f}s; "
          f"turn-2 fresh would pay turn-1 cost again",
          file=sys.stderr, flush=True)
    print(json.dumps({
        "size": size, "bucket": bucket,
        "turn1_fresh_s": round(fresh, 3),
        "turn2_cached_s": round(cont, 3),
        "turn2_speedup_vs_fresh": round(fresh / cont, 2)}))


if __name__ == "__main__":
    main()
