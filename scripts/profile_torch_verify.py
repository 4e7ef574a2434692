#!/usr/bin/env python3
"""Where the time of a speculative verify pass goes, on an NVIDIA GPU,
against a plain decode step: the PyTorch port's Mistral int8 serving slice
(VideoLLaMA2-7B-16F, seeded random weights: int8 LLM and tower packs, int8
KV cache), bench.py's prompt and 16-frame uint8 I420 videos prefilled into
a cache with 512 rows after the bucket.

For each case (B rows, K slots; K 0 is a plain decode step on the layered
kernels K3-K5) it times passes at one decode frontier on the host clock
around a synchronized pass (median of ITERS), then profiles PROFILED more
with torch.profiler and prints, a pass, the device-busy time (the union of
kernel intervals), the busy share of the profiled wall time, the
kernels launched and the TOP kernels by device time (names cut to 90
characters), as one JSON line. A verify pass is what
Engine._verify runs: embed, models/llm.decode_verify (W8A8 for B x K <= 64
rows) and the argmax read back. Usage, from the repository root:

    python3 scripts/profile_torch_verify.py
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

ITERS = 10
PROFILED = 3
ROOM = 512
TOP = 6
STEP = 40          # the decode frontier every timed pass writes at
CASES = ((1, 0), (1, 1), (1, 4), (1, 8), (1, 32), (16, 0), (16, 4))


def busy_ms(intervals) -> float:
    """Length of the union of [start, end) intervals (us), in ms."""
    total, end = 0.0, -1.0
    for s, e in sorted(intervals):
        if e <= end:
            continue
        total += e - max(s, end)
        end = e
    return total / 1e3


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_verify: needs an NVIDIA GPU")
    from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (VERIFY_W8A8_ROWS,
                                                        Engine)
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.multimodal import splice as splice_lib
    from videollama2_tpu_torch.utils.synthetic import synthetic_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=16)
    rng = np.random.default_rng(0)
    H = cfg.vision.image_size
    frames = rng.integers(0, 256, (16, cfg.num_frames, H + H // 2, H),
                          dtype=np.uint8)
    prompt = ([1] + [int(x) for x in rng.integers(10, 1000, 40)]
              + [VIDEO_TOKEN_INDEX]
              + [int(x) for x in rng.integers(10, 1000, 12)])
    bucket = -(-(len(prompt) - 1 + cfg.tokens_per_video) // 128) * 128
    eng = Engine(cfg, synthetic_params(cfg, dtype=torch.bfloat16,
                                       device="cuda", seed=0, llm_bits=8),
                 dtype=torch.bfloat16, max_len=bucket + ROOM,
                 buckets=(bucket,), kv_bits=8, device="cuda")
    params, dev = eng.params["llm"], eng.device
    caches = {}
    with torch.inference_mode():
        for B in sorted({b for b, _ in CASES}):
            plan = splice_lib.plan_batch([prompt] * B, cfg.tokens_per_video,
                                         bucket)
            cache = llm_lib.init_cache(cfg.llm, B, eng.max_len, eng.dtype,
                                       kv_bits=8, device=dev)
            valid = torch.from_numpy(plan.valid_len).to(dev)
            vl2.prefill_multimodal(
                eng.params, cfg, eng.upload_frames(frames[:B]),
                torch.from_numpy(plan.text_ids).to(dev).long(),
                torch.from_numpy(plan.is_visual).to(dev),
                torch.from_numpy(plan.vis_index).to(dev),
                torch.from_numpy(plan.positions).to(dev), valid, cache,
                w8a8=True)
            caches[B] = (cache, valid)

    def one_pass(B, K):
        cache, valid = caches[B]
        if K == 0:
            ids = torch.full((B, 1), 22674, device=dev)
            logits, _ = llm_lib.decode_step(
                params, cfg.llm, llm_lib.embed_tokens(params, ids, eng.dtype),
                cache, valid, bucket, STEP, w8a8=True)
            return torch.argmax(logits, -1).tolist()
        ids = torch.full((B, K), 22674, device=dev)
        logits, _ = llm_lib.decode_verify(
            params, cfg.llm, llm_lib.embed_tokens(params, ids, eng.dtype),
            cache, valid, bucket, STEP, w8a8=B * K <= VERIFY_W8A8_ROWS)
        return torch.argmax(logits, -1).tolist()

    rows = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for B, K in CASES:
            for _ in range(2):
                one_pass(B, K)
            times = []
            for _ in range(ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                one_pass(B, K)
                times.append((time.perf_counter() - t0) * 1e3)
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PROFILED):
                    one_pass(B, K)
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [ev for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and ev.time_range.end > ev.time_range.start]
            intervals = [(ev.time_range.start, ev.time_range.end)
                         for ev in kernels]
            busy = busy_ms(intervals)
            by_name = {}
            for ev in kernels:
                name = ev.name[:90]
                by_name[name] = by_name.get(name, 0.0) + (
                    ev.time_range.end - ev.time_range.start) / 1e3 / PROFILED
            row = {"case": (f"B{B} decode step (K3-K5)" if K == 0
                            else f"B{B} verify K{K}"),
                   "host_ms": statistics.median(times),
                   "profiled_wall_ms": wall / PROFILED,
                   "device_busy_ms": busy / PROFILED,
                   "busy_share": busy / wall,
                   "kernels": len(intervals) // PROFILED,
                   "top_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:TOP])}
            print(json.dumps(row), flush=True)
            rows.append(row)
    print(json.dumps({"device": smi, "layers": cfg.llm.num_layers,
                      "cache_rows": eng.max_len, "bucket": bucket,
                      "passes": rows}), flush=True)


if __name__ == "__main__":
    main()
