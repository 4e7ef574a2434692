#!/usr/bin/env python3
"""Does a video's answer depend on what it is batched with? On an NVIDIA
GPU, the PyTorch port's Mistral int8 serving slice (VideoLLaMA2-7B-16F,
seeded random weights: int8 LLM and tower packs, int8 KV cache), bench.py's
prompt and 4 seeded 16-frame uint8 I420 videos, 32 greedy tokens a request:

1. the tower features and the STC connector's tokens of the 4 videos
   encoded in one batched pass against each encoded alone (max abs
   difference, share of equal elements): why the inference paths run the
   connector one media at a time (models/videollama2.aggregate_each);
2. each row's tokens from a B = 4 generate, in the plain "vision" mode and
   in the grouped mode (`media_group`), against a B = 1 generate;
3. what the exact paths cost: the connector over 16 videos in one batched
   pass against one at a time (CUDA events), and the host resize of 16
   frames 480x640 -> 336x448, PIL's resample (`media/preprocess.py`
   `resize_bicubic`) against torch's antialiased bicubic on uint8, which
   is within 2 levels of PIL (host clock); medians of 5.

Prints the card's name and power limit and one JSON line. Usage, from the
repository root:

    python3 scripts/profile_torch_serve.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

NEW_TOKENS = 32
VIDEOS = 4


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_serve: needs an NVIDIA GPU")
    from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.utils.synthetic import synthetic_params

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)

    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=16)
    H = cfg.vision.image_size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (VIDEOS, cfg.num_frames, H + H // 2, H),
                          dtype=np.uint8)
    text = [int(x) for x in rng.integers(10, 1000, 52)]
    prompts = [[1, 11 + v] + text[:40] + [VIDEO_TOKEN_INDEX] + text[40:]
               for v in range(VIDEOS)]
    spliced = len(prompts[0]) - 1 + cfg.tokens_per_video
    bucket = -(-spliced // 128) * 128
    params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                              seed=0, llm_bits=8)
    eng = Engine(cfg, params, dtype=torch.bfloat16,
                 max_len=bucket + NEW_TOKENS, buckets=(bucket,),
                 decode_chunk=NEW_TOKENS, kv_bits=8, device="cuda")
    del params
    gen = GenerationConfig(max_new_tokens=NEW_TOKENS)
    out = {"device": smi, "bucket": bucket}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    # -- 1. one batched encode against one media at a time ----------------
    with torch.inference_mode():
        feats = vl2.frame_features(eng.params, cfg, dev(frames), w8a8=True)
        batched = vl2.temporal_aggregator(eng.params, cfg, feats)
        rows = []
        for v in range(VIDEOS):
            feats1 = vl2.frame_features(eng.params, cfg,
                                        dev(frames[v:v + 1]), w8a8=True)
            tokens1 = vl2.temporal_aggregator(eng.params, cfg, feats1)
            rows.append({
                "tower_max_abs_diff": (feats[v] - feats1[0]).abs().max()
                .item(),
                "connector_max_abs_diff": (batched[v] - tokens1[0]).abs()
                .max().item(),
                "connector_max_abs": tokens1.abs().max().item(),
                "connector_equal_share": (batched[v] == tokens1[0]).float()
                .mean().item()})
        del feats, batched
    out["encode_batched_vs_1"] = rows

    # -- 2. B = 4 generates against B = 1 ---------------------------------
    alone = [eng.generate([prompts[v]], frames=frames[v:v + 1], gen=gen,
                          eos_token_id=-1)[0] for v in range(VIDEOS)]
    plain = eng.generate(prompts, frames=frames, gen=gen, eos_token_id=-1)
    grouped = eng.generate(prompts, frames=frames,
                           media_group=list(range(VIDEOS)), gen=gen,
                           eos_token_id=-1)
    out["vision_b4_equals_b1"] = [plain[v] == alone[v]
                                  for v in range(VIDEOS)]
    out["grouped_b4_equals_b1"] = [grouped[v] == alone[v]
                                   for v in range(VIDEOS)]

    # -- 3. the cost of the exact paths -----------------------------------
    def cuda_ms(fn):
        times = []
        for _ in range(6):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        return statistics.median(times[1:])

    def host_ms(fn):
        times = []
        for _ in range(6):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times[1:])

    with torch.inference_mode():
        feats = vl2.frame_features(eng.params, cfg,
                                   dev(np.concatenate([frames] * 4)),
                                   w8a8=True)
        out["connector_b16_ms"] = {
            "batched": cuda_ms(
                lambda: vl2.temporal_aggregator(eng.params, cfg, feats)),
            "one_at_a_time": cuda_ms(
                lambda: vl2.aggregate_each(eng.params, cfg, feats))}
        del feats
    import torch.nn.functional as F
    from videollama2_tpu_torch.media import preprocess
    rgb = rng.integers(0, 256, (16, 480, 640, 3), dtype=np.uint8)
    nchw = torch.from_numpy(rgb).permute(0, 3, 1, 2)
    out["resize_16_frames_host_ms"] = {
        "pil_resample": host_ms(
            lambda: preprocess.resize_bicubic(rgb, 336, 448)),
        "torch_antialias": host_ms(
            lambda: F.interpolate(nchw, size=(336, 448), mode="bicubic",
                                  antialias=True).permute(0, 2, 3, 1)
            .contiguous())}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
