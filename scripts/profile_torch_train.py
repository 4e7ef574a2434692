#!/usr/bin/env python3
"""Where the time of one training microbatch goes, on an NVIDIA GPU: the
PyTorch port's stage-1 (projector-only) training slice of
VideoLLaMA2-7B-8F (CLIP-L/336 + STC + Mistral-7B, seeded random bf16
weights), 8 videos x 8 uint8 frames at seq 2048 with valid_len spread over
1400-2048, forward_train and its backward (each LLM layer checkpointed).

With --lora, the microbatch of the "lora" phase of chip_smoke.py instead
(the reference's finetune_lora.sh / finetune_qlora.sh): adapters r 128,
alpha 256 on every LLM projection, trained with the connector, over the
bf16 base (--lora bf16) or folded int4 layers (--lora int4); --batch sets
the videos a microbatch (8 by default, the recipes' 4).

After one warm-up microbatch it profiles one more with torch.profiler and
prints the device time by kernel class (the port's flash kernels K1, K2,
K8, K9 by name; GEMMs; convolutions; the int4 unpack's bitwise kernels;
the rest: elementwise, copies, reductions, norms), the kernels that take
the most device time, the device-busy share (the union of kernel
intervals over the profiled wall time) and the peak device memory, as
one JSON line. Usage, from the repository root:

    python3 scripts/profile_torch_train.py
    python3 scripts/profile_torch_train.py --lora int4 --batch 4
"""

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

CLASSES = (  # (class, substrings of the kernel name), first match wins
    ("K8 flash_attention_bwd_dq", ("flash_bwd_dq_kernel",)),
    ("K9 flash_attention_bwd_dkv", ("flash_bwd_dkv_kernel",)),
    ("K2 flash_attention", ("flash_attention_kernel",)),
    ("K1 encoder_attention", ("encoder_attention_kernel",)),
    ("convolution", ("conv", "cudnn", "implicit_gemm", "wgrad", "dgrad")),
    ("gemm", ("gemm", "cutlass", "xmma", "cublas", "sm90_", "nvjet")),
    ("int4 unpack (bitwise)", ("bitwise", "rshift")),
)
TOP_KERNELS = 12


def classify(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "elementwise/copy/reduction/norm"


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lora", choices=("bf16", "int4"), default=None)
    ap.add_argument("--batch", type=int, default=8)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs an NVIDIA GPU")
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.ops import quant
    from videollama2_tpu_torch.train import lora
    from videollama2_tpu_torch.train.optimizer import (OptimizerConfig,
                                                       flatten,
                                                       trainable_mask)
    from videollama2_tpu_torch.train.step import loss_fn
    from videollama2_tpu_torch.utils.synthetic import (synthetic_params,
                                                       synthetic_train_batch)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=8)
    params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                              seed=0)
    if args.lora == "int4":
        quant.quantize_in_place(params["llm"]["layers"],
                                quant.LLM_PROJECTIONS, 4)
    if args.lora:
        params["llm"] = lora.inject_lora(
            torch.Generator(device="cuda").manual_seed(1), params["llm"],
            lora.LoraConfig(r=128, alpha=256), cfg.llm)
    mask = trainable_mask(params, OptimizerConfig(
        lora_enable=bool(args.lora), tune_mm_mlp_adapter=not args.lora))
    trained = [t for p, t in flatten(params).items() if mask[p]]
    for t in trained:
        t.requires_grad_(True)
    B, S = args.batch, 2048
    batch = synthetic_train_batch(cfg, np.random.default_rng(1), B, S, 1400)

    def microbatch():
        loss, _ = loss_fn(params, cfg, batch)
        loss.backward()
        for t in trained:
            t.grad = None

    microbatch()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    microbatch()
    torch.cuda.synchronize()
    wall_plain = (time.perf_counter() - t0) * 1e3
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        microbatch()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_class, by_name, intervals, n = {}, {}, [], 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dur = ev.time_range.end - ev.time_range.start
        if dur <= 0:
            continue
        n += 1
        cls = classify(ev.name)
        by_class[cls] = by_class.get(cls, 0.0) + dur / 1e3
        by_name[ev.name[:120]] = by_name.get(ev.name[:120], 0.0) + dur / 1e3
        intervals.append((ev.time_range.start, ev.time_range.end))
    busy = busy_ms(intervals)
    out = {"device": smi, "trained": (f"LoRA r 128 over a {args.lora} base"
                                      if args.lora else "the connector"),
           "microbatch": f"{B} videos x {cfg.num_frames} "
           f"frames, seq {S}, valid_len {sorted(batch.valid_len.tolist())}",
           "wall_ms_unprofiled": wall_plain, "wall_ms_profiled": wall,
           "device_busy_ms": busy, "busy_share": busy / wall,
           "kernels": n, "device_ms_by_class": dict(sorted(
               by_class.items(), key=lambda kv: -kv[1])),
           "top_kernels_ms": dict(sorted(by_name.items(),
                                         key=lambda kv: -kv[1])[:TOP_KERNELS]),
           "peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
