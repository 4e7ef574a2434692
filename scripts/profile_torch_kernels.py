#!/usr/bin/env python3
"""The decode's kernels on their own, on the PyTorch port (port of
scripts/profile_kernels.py): the cost of a trivial launch, one layer's
decode matmuls back to back (the q, k, v and o projections on
`matmul_q8_layered`, K4, and the SwiGLU FFN on `ffn_q8_layered`, K5;
ops/decode_matmul), and 32 layers of those matmuls with nothing else of
the decode step.

Weights are the JAX script's constant fills: int8 packs of ones with
fp32 scales 1e-4 for q [L, 4096, 4096], k and v (one pack [L, 4096,
1024], read twice), o, gate (read as gate and up) [L, 4096, 14336] and
down; x is 0.01 in bf16, B = 8 rows. The kernels only time; constant
weights time as random ones do.

Each measurement prints the host clock (the JAX script's: calls enqueued,
one synchronize) and, on a GPU, the device time from CUDA events behind
a spin kernel long enough to cover the calls' enqueue
(chip_smoke.spin_timed_ms): the gap between the two is the time the
device waits on the host's launches. Bandwidths count the int8 weight
bytes, as the JAX script does, beside their share of the H100's 3.35
TB/s. The JAX script's block sweeps (block_out, block_f) have their
counterpart in scripts/profile_torch_decode_ffn.py --blocks-per-sm, which
times the split-K core's plans; they are not repeated here.

PLATFORM=cpu runs the plain versions on the CPU at small widths (2
layers, D 256, F 512), without a device clock; without a GPU and without
PLATFORM=cpu the script raises. Usage, from the repository root:

    python3 scripts/profile_torch_kernels.py           # on a CUDA GPU
    PLATFORM=cpu python3 scripts/profile_torch_kernels.py
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def shapes(device: str) -> dict:
    """Mistral-7B's decode widths on a GPU, small ones on the CPU."""
    if device == "cuda":
        return dict(L=32, D=4096, F=14336, B=8, Hhd=4096, Khd=1024)
    return dict(L=2, D=256, F=512, B=8, Hhd=256, Khd=128)


def weights(sh: dict, device) -> dict:
    """(q, scale) packs of ones and 1e-4 for q, kv, o, gate and down."""
    L, D, F = sh["L"], sh["D"], sh["F"]

    def pack(din, dout):
        return (torch.ones((L, din, dout), dtype=torch.int8, device=device),
                torch.full((L, 1, dout), 1e-4, dtype=torch.float32,
                           device=device))
    return {"q": pack(D, sh["Hhd"]), "kv": pack(D, sh["Khd"]),
            "o": pack(sh["Hhd"], D), "gate": pack(D, F), "down": pack(F, D)}


def layer_mms(w: dict, x, li: int):
    """One layer's decode matmuls (the JAX script's layer_mms)."""
    from videollama2_tpu_torch.ops import decode_matmul as dk
    q = dk.matmul_q8_layered(x, *w["q"], li)
    k = dk.matmul_q8_layered(x, *w["kv"], li)
    v = dk.matmul_q8_layered(x, *w["kv"], li)
    o = dk.matmul_q8_layered(q, *w["o"], li)
    f = dk.ffn_q8_layered(x + o, *w["gate"], *w["gate"], *w["down"], li)
    return f + k.sum() + v.sum()


def scan_mms(w: dict, x, layers: int):
    """Every layer's matmuls in turn, each layer's output the next one's
    input (the JAX script's scan_mms)."""
    for li in range(layers):
        x = layer_mms(w, x, li)
    return x


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def clocks(fn, device, iters: int) -> dict:
    """fn's ms on the host clock (a warm-up call, then `iters` calls and
    one synchronize) and, on a GPU, its device ms (the median of `iters`
    spin-timed calls) and whether every spin covered its call's
    enqueue."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    _sync(device)
    out = {"host_ms": (time.perf_counter() - t0) / iters * 1e3,
           "device_ms": None, "covered": None}
    if device.type == "cuda":
        timed = [cs.spin_timed_ms(fn, out["host_ms"]) for _ in range(iters)]
        out["device_ms"] = statistics.median(ms for ms, _ in timed)
        out["covered"] = all(c for _, c in timed)
    return out


def null_dispatch(device, iters: int = 16) -> dict:
    """A trivial launch (a + 1 on an 8 x 8 fp32 tensor): the ms a call of
    `iters` chained calls and one synchronize (the JAX script's), and the
    median ms of one launch and its synchronize."""
    a = torch.zeros((8, 8), dtype=torch.float32, device=device)
    a + 1
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        b = a + 1
    _sync(device)
    chained = (time.perf_counter() - t0) / iters * 1e3
    trips = []
    for _ in range(iters):
        t0 = time.perf_counter()
        b = a + 1
        _sync(device)
        trips.append((time.perf_counter() - t0) * 1e3)
    del b
    return {"chained_ms": chained, "round_trip_ms": statistics.median(trips)}


def _line(label, c, nbytes, us: bool) -> str:
    def fmt(ms):
        rate = nbytes / (ms / 1e3)
        return ((f"{ms * 1e3:.0f} us" if us else f"{ms:.2f} ms")
                + f" {rate / 1e9:.0f} GB/s ({rate / cs.HBM_BYTES_PER_S:.1%} "
                "of 3.35 TB/s)")
    line = f"{label}: {fmt(c['host_ms'])}"
    if c["device_ms"] is not None:
        line += (f"; CUDA events {fmt(c['device_ms'])}, spin covered the "
                 f"enqueue: {c['covered']}")
    return line


def run(device: str, iters: int = 8, scan_iters: int = 4,
        hook=None) -> dict:
    """The JAX script's measurements, each through hook(label, fn) (fn()
    by default; labels "null dispatch", "one layer", "32 layers"): a
    layer's or the scan's call runs once to warm up, `iters` (scan_iters)
    times on the host clock and as many on the device clock. Prints the
    JAX script's lines; returns their numbers."""
    hook = hook or (lambda label, fn: fn())
    dev = torch.device(device)
    print("platform:", dev.type, flush=True)
    out = {}
    nd = hook("null dispatch", lambda: null_dispatch(dev))
    out["null_dispatch"] = nd
    print(f"null dispatch: {nd['chained_ms']:.2f} ms (one launch and its "
          f"synchronize: {nd['round_trip_ms']:.3f} ms)", flush=True)
    print("block sweeps: scripts/profile_torch_decode_ffn.py "
          "--blocks-per-sm N [N ...] times the split-K core's plans",
          flush=True)
    sh = shapes(device)
    D, F, Hhd, Khd = sh["D"], sh["F"], sh["Hhd"], sh["Khd"]
    w = weights(sh, dev)
    x = torch.full((sh["B"], D), 0.01, dtype=torch.bfloat16, device=dev)
    per_layer_bytes = D * Hhd + 2 * D * Khd + Hhd * D + 3 * D * F
    with torch.inference_mode():
        li = 3 % sh["L"]      # the JAX script's layer 3
        c = hook("one layer", lambda: clocks(lambda: layer_mms(w, x, li),
                                             dev, iters))
        out["one_layer"] = c
        print(_line("one layer all matmuls", c, per_layer_bytes, True),
              flush=True)
        c = hook("32 layers", lambda: clocks(
            lambda: scan_mms(w, x, sh["L"]), dev, scan_iters))
        out["layers"] = c
        print(_line(f"scan {sh['L']} layers matmuls only", c,
                    per_layer_bytes * sh["L"], False), flush=True)
    return out


def main() -> None:
    device = cs.script_device("profile_torch_kernels")
    if device == "cuda":
        print(cs.card(), flush=True)
    run(device)


if __name__ == "__main__":
    main()
