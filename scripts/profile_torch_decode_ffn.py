#!/usr/bin/env python3
"""The decode's weight-only matmuls on the split-K core, on an NVIDIA GPU, at
chip_smoke.py's cases: K4 (`matmul_q8_layered`) and K6
(`matmul_q4_layered`, over folded int4 packs) at the fused qkv and o
projections of Mistral-7B ([4096, 6144], [4096, 4096]) and Qwen2-7B
([3584, 4608], [3584, 3584]), and the int8 and int4 SwiGLU FFNs, K5
(`ffn_q8_layered`) and K7 (`ffn_q4_layered`), at Mistral-7B's (4096, 14336)
and Qwen2-7B's (3584, 18944) widths.

Times each kernel and its plain PyTorch version with CUDA events behind a
spin kernel (chip_smoke.cuda_ms), beside the bound (every weight byte read
once at 3.35 TB/s), and checks the kernel against the plain version
(chip_smoke.MATMUL_REL_TOL of max|out|): x [16, D] bf16, packs with bf16
scales, layers rotated between launches (four for K4 and eight for K6,
so that they overflow the 50 MB L2; two for the FFNs). No one PyTorch call
computes the FFN; K4's and K6's library yardsticks are chip_smoke's
(torch._weight_int8pack_mm, torch._weight_int4pack_mm).

--tree DIR takes the port and chip_smoke.py from another checkout (for an
A/B of two commits in one run: unpack the other commit into a directory
and time both, in turns). --passes adds the device time of each launch of
the split-K core (torch.profiler), and --blocks-per-sm N [N ...] times the
kernels with the split plan aimed at N blocks an SM instead of
ops/decode_matmul.SPLIT_BLOCKS_PER_SM (this tree's plan only).

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

PROJECTIONS = ((4096, 6144), (4096, 4096), (3584, 4608), (3584, 3584))
WIDTHS = ((4096, 14336), (3584, 18944))
ROWS, LAYERS = 16, 2


def mm_cases(cs, gen, quantize, library, layers):
    """K4 (or K6) at the four projections, built from the helpers every
    checkout's chip_smoke.py has; quantize(w) -> (weight bytes, scale),
    library(x, q, s) -> the yardstick."""
    out = []
    for din, dout in PROJECTIONS:
        x = cs.rand_bf16(gen, (ROWS, din))
        q, s = quantize(cs.rand_bf16(gen, (layers, din, dout), 0.02))
        s = s.bfloat16()
        cyc = cs.layer_cycle(layers)
        yard = (cs.bound(2 * ROWS * din * dout, q[0].nbytes + s[0].nbytes
                         + x.nbytes + ROWS * dout * 2), library(x, q, s))
        out.append((f"x[{ROWS},{din}] [{layers},{din},{dout}]",
                     ((x, q, s, 1), {}), ((x.float(), q, s, 1), {}),
                     lambda f, x=x, q=q, s=s, cyc=cyc: (
                         lambda: f(x, q, s, cyc())), yard))
    return out


def ffn_cases(cs, gen, quantize):
    """The FFN at both widths; quantize(w) -> (weight bytes, scale)."""
    out = []
    for D, F in WIDTHS:
        x = cs.rand_bf16(gen, (ROWS, D))

        def pack(din, dout):
            q, s = quantize(cs.rand_bf16(gen, (LAYERS, din, dout), 0.02))
            return q, s.bfloat16()
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


def pass_times(torch, fn, case) -> list:
    """(kernel name, mean device us) of each launch of the split-K core
    that fn makes on `case`."""
    from torch.profiler import ProfilerActivity, profile
    run = case[3](fn)
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
    from videollama2_tpu_torch.ops.quant import quantize_int4, quantize_int8
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def q8(w):
        return tuple(quantize_int8(w, axis=-2).values())

    def q4(w):
        return tuple(quantize_int4(w, axis=-2)[k] for k in ("q4", "scale"))
    kernels = (
        ("matmul_q8_layered", lambda: mm_cases(
            cs, gen, q8, lambda x, q, s: cs.int8pack_library(
                x, q, s, dk._mm_plain), 4)),
        ("matmul_q4_layered", lambda: mm_cases(
            cs, gen, q4, lambda x, q, s: cs.int4pack_library(
                x, q, s, lambda x, q4, s: dk._mm_plain(
                    x, dk.unpack_int4(q4), s)), 8)),
        ("ffn_q8_layered", lambda: ffn_cases(cs, gen, q8)),
        ("ffn_q4_layered", lambda: ffn_cases(cs, gen, q4)))
    out = {"device": smi, "tree": tree}
    target = getattr(dk, "SPLIT_BLOCKS_PER_SM", None)
    for name, make in kernels:
        fn, cases = getattr(dk, name), make()
        res = cs.check_kernel(name, fn, getattr(dk, name + "_plain"), cases,
                              cs.MATMUL_REL_TOL, rel=True)
        if opts.passes:
            res["passes"] = {case[0]: pass_times(torch, fn, case)
                             for case in cases}
            for label, times in res["passes"].items():
                print(f"[passes] {name} {label}: " + ", ".join(
                    f"{kname} {us:.2f} us" for kname, us in times),
                    flush=True)
        res["blocks_per_sm"] = {}
        for n in opts.blocks_per_sm:
            dk.SPLIT_BLOCKS_PER_SM = n
            dk.split_plan.cache_clear()
            for label, _, _, timed, _ in cases:
                ms = cs.cuda_ms(timed(fn))
                res["blocks_per_sm"][f"{n} {label}"] = ms
                print(f"[{n} blocks an SM] {name} {label}: {ms:.4f} ms",
                      flush=True)
        if opts.blocks_per_sm:  # the next kernel starts from the default
            dk.SPLIT_BLOCKS_PER_SM = target
            dk.split_plan.cache_clear()
        out[name] = res
        del cases
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
