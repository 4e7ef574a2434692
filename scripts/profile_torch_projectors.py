#!/usr/bin/env python3
"""chip_smoke.py's "2.1 int4 slice" and "projectors" phase alone, on an
NVIDIA GPU, after the kernels' build: VideoLLaMA2.1-7B-16F in bench.py's
BENCH_MODEL=qwen2 BENCH_BITS=4 tree (28 layers, B 16 x 16 frames, two
generates with exact launch counts, decode logits against the plain
kernels), then chip_smoke.run_projectors_phase with its stage-2 remat
pair run twice in turns (True, "dots", True, "dots"), so that each
policy's step time is read twice in one process. Prints the card's name
and power limit and each phase's lines and JSON. Usage, from the
repository root:

    python3 scripts/profile_torch_projectors.py
"""

import gc
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_projectors: no CUDA device")
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.ops import _build
    from videollama2_tpu_torch.ops import attention as attn
    from videollama2_tpu_torch.ops import decode_attention as k3
    from videollama2_tpu_torch.ops import decode_matmul as dk
    from videollama2_tpu_torch.ops import encoder_attention as k1
    from videollama2_tpu_torch.ops import flash_attention as k2
    from videollama2_tpu_torch.utils.synthetic import synthetic_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.log(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip())
    cs.log(f"torch {torch.__version__} cuda {torch.version.cuda}")
    t_all = time.perf_counter()
    _build.library()
    counters = cs.kernel_counters()
    B, steps = 16, cs.NEW_TOKENS - 1
    t0 = time.perf_counter()
    cfg = cfglib.preset("videollama2_qwen2").replace(num_frames=16)
    frames, prompt, bucket = cs.slice_inputs(cfg, B)
    L = cfg.llm.num_layers
    want = dict.fromkeys(counters, 0)
    want.update(encoder_attention=cs.vit_layers(cfg) * (B * 16 // 128),
                flash_attention=L, decode_attention=steps * L,
                matmul_q4_layered=2 * steps * L, ffn_q4_layered=steps * L)
    eng = Engine(cfg, synthetic_params(cfg, dtype=torch.bfloat16,
                                       device="cuda", seed=0, llm_bits=4,
                                       quantize_embed=True),
                 dtype=torch.bfloat16, max_len=bucket + cs.NEW_TOKENS,
                 buckets=(bucket,), decode_chunk=cs.NEW_TOKENS, kv_bits=8,
                 device="cuda")
    _, stage = cs.run_slice("2.1 int4 slice", eng, cfg, frames, prompt,
                            GenerationConfig(max_new_tokens=cs.NEW_TOKENS),
                            counters, want)
    cs.check_decode_against_plain(eng, cfg, frames[:2], prompt, bucket, k3,
                                  dk, 4)
    stage.update(peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 slice_s=time.perf_counter() - t0)
    cs.log(json.dumps({"2.1 int4 slice": stage}))
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    # the training phases' settings, which chip_smoke sets before it
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cs.REMAT_ORDER = (True, "dots", True, "dots")
    proj, _ = cs.run_projectors_phase(counters, attn, k1, k2)
    cs.log(json.dumps({"projectors": proj}))
    cs.log(f"[total] {time.perf_counter() - t_all:.1f} s")


if __name__ == "__main__":
    main()
