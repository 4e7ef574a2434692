#!/usr/bin/env python3
"""The parallel layer across cards, on NVIDIA GPUs: chip_smoke.py's
"parallel" phase's multi-card part on 2 and 4 ranks (one card each, NCCL)
against the unsharded runs on card 0.

The unsharded runs: a stage-2 Trainer step (Mistral-7B at full width, 8
of 32 LLM layers, the LLM and the connector trained in bf16 with fp32
masters) on a seeded batch of 2 and of 4 videos of 8 frames at seq 2048,
and a greedy generate of 2 videos of 16 frames (16 tokens) with its
first-token logits. Then for each world W in (2, 4) that the cards allow,
W spawned ranks run the same step on a fsdp W mesh (each rank its rows)
and the generate on a tensor W mesh (`shard_fn`). The script holds the
step to the unsharded one (chip_smoke's compare_step: the loss within
PAR_LOSS_REL_TOL, each trained leaf's Adam first moment within
PAR_GRAD_REL_TOL in relative L2, its fp32 update at a cosine of
PAR_UPDATE_COS_MIN or more) and the first-token logits to the unsharded
ones (compare_logits: max 0.4, mean 0.05 of the logits' std), prints how
many greedy tokens a row agree, writes
chiprun_out/profile_torch_parallel.json, and exits non-zero when a rank
failed or a reading is past its limit. Usage, from the repository root,
on a host with two cards or more:

    python3 scripts/profile_torch_parallel.py
"""

import json
import os
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.multiprocessing as mp  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main():
    if torch.cuda.device_count() < 2:
        raise SystemExit("profile_torch_parallel: needs 2 cards or more, "
                         f"found {torch.cuda.device_count()}")
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.ops import _build
    from videollama2_tpu_torch.utils.synthetic import synthetic_train_batch
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    counters = cs.kernel_counters()
    cfg = cs.parallel_config(cfglib)
    worlds = [w for w in (2, 4) if w <= torch.cuda.device_count()]
    ref = {}
    for B in sorted({max(cs.PAR_TRAIN_B, w) for w in worlds}):
        batch = synthetic_train_batch(cfg, np.random.default_rng(3), B,
                                      cs.TRAIN_S, cs.TRAIN_MIN_VALID)
        got = cs.parallel_train_step(cfg, batch, counters, "cuda")
        ref[B] = {"loss": got["loss"], "samples": got["samples"]}
        print(f"unsharded step, {B} videos: loss {got['loss']:.6f}, "
              f"{got['step_s']:.2f} s", flush=True)
        del got
        torch.cuda.empty_cache()
    gcfg = cfg.replace(num_frames=16)
    frames, prompt, bucket = cs.slice_inputs(gcfg, cs.PAR_GEN_B)
    tokens, _, logits = cs.parallel_generate(gcfg, frames, prompt, bucket,
                                             counters)
    print(f"unsharded tokens {tokens}", flush=True)
    torch.cuda.empty_cache()
    out, failed = {}, []
    for world in worlds:
        with tempfile.TemporaryDirectory() as d:
            result = os.path.join(d, "result.pt")
            ctx = mp.get_context("spawn")
            t0 = time.perf_counter()
            procs = [ctx.Process(target=cs.parallel_rank,
                                 args=(r, world, d, result))
                     for r in range(world)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(cs.PAR_TIMEOUT)
            for p in procs:
                if p.is_alive():
                    p.kill()
            codes = [p.exitcode for p in procs]
            print(f"world {world}: exit codes {codes} in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
            if any(codes):
                raise SystemExit(f"world {world}: a rank failed")
            got = torch.load(result)
        B = max(cs.PAR_TRAIN_B, world)
        step = cs.compare_step(f"fsdp {world}", got, ref[B])
        if step["failed"]:
            failed.append(step["failed"])
        try:
            cs.compare_logits(f"tensor {world} first token", got["logits"],
                              logits)
        except RuntimeError as e:
            failed.append(str(e))
        diff = (got["logits"] - logits).abs()
        agree = [next((i for i, (a, b) in enumerate(zip(r2, r1)) if a != b),
                      len(r1)) for r2, r1 in zip(got["tokens"], tokens)]
        print(f"world {world}: tensor {world} tokens agree for the first "
              f"{agree} of {len(tokens[0])} a row", flush=True)
        out[world] = {"fsdp_step": step, "tokens": got["tokens"],
                      "tokens_agree": agree,
                      "logits_max_abs_diff": diff.max().item(),
                      "logits_mean_abs_diff": diff.mean().item(),
                      "logit_std": logits.std().item()}
    os.makedirs("chiprun_out", exist_ok=True)
    with open("chiprun_out/profile_torch_parallel.json", "w") as f:
        json.dump({"unsharded_tokens": tokens, "worlds": out,
                   "failed": failed}, f)
    print(json.dumps({"worlds": out}), flush=True)
    if failed:
        raise SystemExit("profile_torch_parallel: " + " | ".join(failed))


if __name__ == "__main__":
    main()
