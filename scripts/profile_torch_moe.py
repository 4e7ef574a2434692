#!/usr/bin/env python3
"""Where the time of a Mixtral decode step goes, on an NVIDIA GPU: the
PyTorch port's VideoLLaMA2-8x7B slice as chip_smoke.py's "mixtral slice"
runs it (CLIP + STC + Mixtral-8x7B at 8 frames, the LLM cut to 8 of 32
layers, seeded bf16 weights, a bf16 cache, the Engine's dense MoE
dispatch), bench.py's prompt and 8-frame uint8 I420 videos prefilled into
a cache with 64 rows after the bucket.

For each case it times calls on the host clock around a synchronized call
(median of ITERS), then profiles PROFILED more with torch.profiler and
prints, a call, the device-busy time (the union of kernel intervals), the
busy share of the profiled wall time, the kernels launched and the TOP
kernels by device time, as one JSON line. Cases: a decode step of
models/llm.decode_step at B 16 and at B 1, and layer 0's MoE FFN alone
(models/llm._ffn_moe, dense) on one token a row at B 16 and B 1. The last
line adds the bytes a decode step's expert products read (every expert of
every layer) and their time at the card's memory rate. Usage, from the
repository root:

    python3 scripts/profile_torch_moe.py
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(1, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from profile_torch_verify import busy_ms  # noqa: E402

ITERS = 10
PROFILED = 3
ROOM = 64
TOP = 6
LAYERS = 8
STEP = 8           # the decode frontier every timed step writes at
HBM_BYTES_PER_S = 3.35e12


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_moe: needs an NVIDIA GPU")
    import dataclasses
    from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import Engine
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.multimodal import splice as splice_lib
    from videollama2_tpu_torch.ops.layers import layer_params
    from videollama2_tpu_torch.utils.synthetic import synthetic_params

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    cfg = cfglib.preset("videollama2_mixtral").replace(num_frames=8)
    cfg = cfg.replace(llm=dataclasses.replace(cfg.llm, num_layers=LAYERS))
    rng = np.random.default_rng(0)
    H = cfg.vision.image_size
    frames = rng.integers(0, 256, (16, cfg.num_frames, H + H // 2, H),
                          dtype=np.uint8)
    prompt = ([1] + [int(x) for x in rng.integers(10, 1000, 40)]
              + [VIDEO_TOKEN_INDEX]
              + [int(x) for x in rng.integers(10, 1000, 12)])
    bucket = -(-(len(prompt) - 1 + cfg.tokens_per_video) // 128) * 128
    eng = Engine(cfg, synthetic_params(cfg, dtype=torch.bfloat16,
                                       device="cuda", seed=0),
                 dtype=torch.bfloat16, max_len=bucket + ROOM,
                 buckets=(bucket,), device="cuda")
    cfg = eng.cfg                        # the Engine's dense dispatch
    params, dev = eng.params["llm"], eng.device
    caches = {}
    with torch.inference_mode():
        for B in (16, 1):
            plan = splice_lib.plan_batch([prompt] * B, cfg.tokens_per_video,
                                         bucket)
            cache = llm_lib.init_cache(cfg.llm, B, eng.max_len, eng.dtype,
                                       device=dev)
            valid = torch.from_numpy(plan.valid_len).to(dev)
            vl2.prefill_multimodal(
                eng.params, cfg, eng.upload_frames(frames[:B]),
                torch.from_numpy(plan.text_ids).to(dev).long(),
                torch.from_numpy(plan.is_visual).to(dev),
                torch.from_numpy(plan.vis_index).to(dev),
                torch.from_numpy(plan.positions).to(dev), valid, cache)
            caches[B] = (cache, valid)
    lp = layer_params(params["layers"], 0)
    gen = torch.Generator(device=dev).manual_seed(1)
    xs = {B: torch.randn((B, 1, cfg.llm.hidden_size), generator=gen,
                         device=dev).bfloat16() for B in (16, 1)}

    def decode(B):
        cache, valid = caches[B]
        ids = torch.full((B, 1), 22674, device=dev)
        logits, _ = llm_lib.decode_step(
            params, cfg.llm, llm_lib.embed_tokens(params, ids, eng.dtype),
            cache, valid, bucket, STEP)
        return torch.argmax(logits, -1).tolist()

    def moe(B):
        return llm_lib._ffn_moe(xs[B], lp, cfg.llm).sum().item()

    cases = (("B16 decode step", lambda: decode(16)),
             ("B1 decode step", lambda: decode(1)),
             ("B16 layer 0 MoE FFN (dense)", lambda: moe(16)),
             ("B1 layer 0 MoE FFN (dense)", lambda: moe(1)))
    rows = []
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        for label, fn in cases:
            for _ in range(2):
                fn()
            times = []
            for _ in range(ITERS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                times.append((time.perf_counter() - t0) * 1e3)
            with torch.profiler.profile(activities=acts) as prof:
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(PROFILED):
                    fn()
                wall = (time.perf_counter() - t0) * 1e3
            kernels = [ev for ev in prof.events()
                       if ev.device_type == torch.autograd.DeviceType.CUDA
                       and ev.time_range.end > ev.time_range.start]
            busy = busy_ms([(ev.time_range.start, ev.time_range.end)
                            for ev in kernels])
            by_name = {}
            for ev in kernels:
                name = ev.name[:90]
                by_name[name] = by_name.get(name, 0.0) + (
                    ev.time_range.end - ev.time_range.start) / 1e3 / PROFILED
            row = {"case": label, "host_ms": statistics.median(times),
                   "profiled_wall_ms": wall / PROFILED,
                   "device_busy_ms": busy / PROFILED,
                   "busy_share": busy / wall,
                   "kernels": len(kernels) // PROFILED,
                   "top_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:TOP])}
            print(json.dumps(row), flush=True)
            rows.append(row)
    expert_bytes = sum(params["layers"][n]["kernel"].nbytes
                       for n in ("gate", "up", "down"))
    print(json.dumps({"device": smi, "layers": LAYERS, "bucket": bucket,
                      "expert_gb_a_step": expert_bytes / 1e9,
                      "expert_read_bound_ms":
                          expert_bytes / HBM_BYTES_PER_S * 1e3,
                      "cases": rows}), flush=True)


if __name__ == "__main__":
    main()
