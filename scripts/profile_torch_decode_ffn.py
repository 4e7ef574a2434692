#!/usr/bin/env python3
"""The int8 SwiGLU FFN of the decode (K5) on an NVIDIA GPU at chip_smoke.py's
cases.

Times K5 (`ffn_q8_layered`) and its plain PyTorch version with CUDA events
behind a spin kernel (chip_smoke.cuda_ms), beside the bound (every weight
byte read once at 3.35 TB/s), and checks K5 against the plain version
(chip_smoke.MATMUL_REL_TOL of max|out|): x [16, D] bf16 through two layers
of int8 gate/up [D, F] and down [F, D] packs with bf16 scales, rotated
between launches, at Mistral-7B's (4096, 14336) and Qwen2-7B's
(3584, 18944) widths. No one PyTorch call computes the FFN, so there is no
library yardstick.

--tree DIR takes the port and chip_smoke.py from another checkout (for an
A/B of two commits in one run: unpack the other commit into a directory
and time both, in turns). For this tree's split-K core, --passes adds
each of K5's two launches' device time (torch.profiler), and
--blocks-per-sm N [N ...] times K5 with the split plan aimed at N blocks
an SM instead of ops/decode_matmul.SPLIT_BLOCKS_PER_SM.

Usage, from the repository root, on a machine with a CUDA GPU:

    python3 scripts/profile_torch_decode_ffn.py [--tree DIR] [--passes]
        [--blocks-per-sm N [N ...]]

Prints the card's name and power limit, a line per case and one JSON line
of the results.
"""

import argparse
import json
import os
import subprocess
import sys

WIDTHS = ((4096, 14336), (3584, 18944))
ROWS, LAYERS = 16, 2


def cases(cs, gen, quantize_int8):
    """chip_smoke's K5 cases, built from the helpers every checkout's
    chip_smoke.py has."""
    out = []
    for D, F in WIDTHS:
        x = cs.rand_bf16(gen, (ROWS, D))

        def pack(din, dout):
            p = quantize_int8(cs.rand_bf16(gen, (LAYERS, din, dout), 0.02),
                              axis=-2)
            return p["q"], p["scale"].bfloat16()
        g, u, d = pack(D, F), pack(D, F), pack(F, D)
        cyc = cs.layer_cycle(LAYERS)
        yard = (cs.bound(2 * ROWS * 3 * D * F,
                         sum(t[0].nbytes for t in (*g, *u, *d))
                         + 2 * x.nbytes), None)
        out.append((f"x[{ROWS},{D}] gate/up[{LAYERS},{D},{F}] "
                    f"down[{LAYERS},{F},{D}]",
                    ((x, *g, *u, *d, 1), {}),
                    ((x.float(), *g, *u, *d, 1), {}),
                    lambda f, x=x, g=g, u=u, d=d, cyc=cyc: (
                        lambda: f(x, *g, *u, *d, cyc())), yard))
    return out


def pass_times(torch, dk, case) -> list:
    """(kernel name, mean device us) of each launch of K5 on `case`."""
    from torch.profiler import ProfilerActivity, profile
    run = case[3](dk.ffn_q8_layered)
    for _ in range(3):
        run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(20):
            run()
        torch.cuda.synchronize()
    return [(e.key, e.device_time_total / e.count)
            for e in prof.key_averages() if "splitk_kernel" in e.key]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--passes", action="store_true")
    ap.add_argument("--blocks-per-sm", type=int, nargs="*", default=[])
    opts = ap.parse_args()
    tree = os.path.abspath(opts.tree)
    sys.path.insert(0, tree)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_decode_ffn: needs an NVIDIA GPU")
    import chip_smoke as cs
    from videollama2_tpu_torch.ops import decode_matmul as dk
    from videollama2_tpu_torch.ops.quant import quantize_int8
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    k5 = cases(cs, gen, quantize_int8)
    res = cs.check_kernel("ffn_q8_layered", dk.ffn_q8_layered,
                          dk.ffn_q8_layered_plain, k5, cs.MATMUL_REL_TOL,
                          rel=True)
    if opts.passes:
        res["passes"] = {case[0]: pass_times(torch, dk, case)
                         for case in k5}
        for label, times in res["passes"].items():
            print(f"[passes] {label}: " + ", ".join(
                f"{name} {us:.2f} us" for name, us in times), flush=True)
    res["blocks_per_sm"] = {}
    for n in opts.blocks_per_sm:
        dk.SPLIT_BLOCKS_PER_SM = n
        dk._split_buffers.clear()
        for label, _, _, timed, _ in k5:
            ms = cs.cuda_ms(timed(dk.ffn_q8_layered))
            res["blocks_per_sm"][f"{n} {label}"] = ms
            print(f"[{n} blocks an SM] {label}: {ms:.4f} ms", flush=True)
    print(json.dumps({"device": smi, "tree": tree, **res}), flush=True)


if __name__ == "__main__":
    main()
