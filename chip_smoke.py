#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (videollama2_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main paths give it (and K10, the
head-pair tower attention, against K1 as well; its own path, the
`pack_pairs=True` entry of scripts/profile_torch_vit_attn.py, is driven
once with every counter at 0), then drives two full-width video-QA models
(seeded random weights) through Engine.generate twice in each of five
slices. VideoLLaMA2-7B-16F (CLIP-L/336 + STC + Mistral-7B): bf16 (bf16
weights and KV cache), int8 serving (int8 LLM and tower packs, W8A8
prefill, int8 KV cache, decode on the layered int8 kernels) and int4
serving, `load_4bit` (folded int4 LLM layers, int8 head and tower, W4A8
prefill, int8 KV cache, decode on the layered int4 kernels).
VideoLLaMA2.1-7B-16F (SigLIP-SO400M/384 + STCv35 + Qwen2-7B, 28 query
heads on 4 kv heads): bf16, and bench.py's BENCH_MODEL=qwen2 serving tree
(int8 layers, head, tower and embedding, int8 KV cache). It checks that
each run went through its kernels, the exact launch counts, and the
first-token (bf16) and decode (int8, int4) logits against the plain
versions. Last, the stage-1 training slice (VideoLLaMA2-7B-8F pretrain:
only the connector trains) runs two optimizer steps of 16 videos
(grad_accum 2 x 8) at seq 2048 through Trainer.train, twice, with the
flash-attention LSE forward (K2) and backward kernels (K8, K9), and one
microbatch's loss and connector gradient are held against the plain
attention.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Prints the card's name and power limit, each phase's numbers, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed phase raises and the exit code
is non-zero; without a CUDA device it exits non-zero before printing
anything on stdout.
"""

import functools
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

K1_TOL = 2e-2   # bf16 output rounding + bf16 P in the PV product
K2_TOL = 2e-2   # (outputs are averages of N(0, 1) values, |o| <= ~3)
K3_TOL = 2e-2   # the same; q is scaled so each softmax is peaked, |o| ~ 1
MATMUL_REL_TOL = 1e-2  # of max|out|: bf16 output (and the FFNs' h) rounding
TIMING_ITERS = 10
SPIN_CYCLES = 4_000_000  # ~2 ms at the H100's clocks, longer than any enqueue
TRAIN_B, TRAIN_S, GRAD_ACCUM, TRAIN_STEPS = 8, 2048, 2, 2
TRAIN_MIN_VALID = 1400  # valid_len spreads over [TRAIN_MIN_VALID, TRAIN_S]
LSE_TOL = 1e-3      # absolute, on lse values of ~8: fp32 sums, fast exp
# K8/K9, of max|grad|: they round p and ds to bf16 (2^-9 relative) for the
# dq, dk and dv products and round their outputs to bf16
BWD_REL_TOL = 2e-2
# kernel vs plain attention through the whole training slice (one
# microbatch of 2 rows): see check_training_against_plain
TRAIN_LOSS_REL_TOL = 1e-2
TRAIN_GRAD_COS = 0.99
PEAK_BF16_FLOPS = 989e12   # H100 SXM dense bf16 (data sheet, 700 W)
HBM_BYTES_PER_S = 3.35e12
NEW_TOKENS = 32
# bench.py's prompt (40 + 12 text tokens around the video) splices to 1574
# tokens with Mistral's 1536 visual tokens and to 1405 with Qwen2's 1352;
# the bucket is the next multiple of 128 and max_len adds the 32 new
# tokens (rounded to 256 under kv8: 1792 and 1536)
BUCKET = 1664
QWEN2_BUCKET = 1408
DECODE_CHECK_STEPS = 3


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Median over `iters` launches of fn's device time (CUDA events). A
    spin kernel queued first keeps the device busy while the host enqueues
    the start event, fn's launches and the end event, so the interval holds
    fn's device work and not the host time to enqueue it (which exceeds a
    decode kernel's few tens of microseconds)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(ms, "bytes" or "operations"): the least time the card could take,
    the larger of the bytes over the memory rate and the operations over
    the bf16 tensor-core rate."""
    t_ops = flops / PEAK_BF16_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def attention_pairs(Sq: int, valid, causal: bool) -> int:
    """Visible (query, key) pairs of one head, summed over the batch: key
    j < valid_len[b] and, causal, j <= i; the work the data needs."""
    i = np.arange(Sq)
    return int(sum((np.minimum(i + 1, v) if causal else np.full(Sq, v))
                   .sum() for v in np.asarray(valid)))


def attention_bound(q, k, valid, causal: bool, products: int, extra_bytes):
    """bound() of an attention pass over q [B, Sq, Hq, D], k/v [B, Sk, Hkv,
    D]: `products` matrix products of 2 * D FLOPs per visible pair and head;
    bytes: q, k and v read once plus `extra_bytes`."""
    B, Sq, Hq, D = q.shape
    if valid is None:
        valid = [k.shape[1]] * B
    flops = products * 2 * D * Hq * attention_pairs(Sq, valid.cpu()
                                                     if torch.is_tensor(valid)
                                                     else valid, causal)
    return bound(flops, q.nbytes + 2 * k.nbytes + extra_bytes)


def sdpa_args(q, k, v, valid, causal):
    """q/k/v [B, S, H, D] as torch SDPA's [B, H, S, D] (k/v heads repeated
    to q's) and the boolean mask of the same attention."""
    rep = q.shape[2] // k.shape[2]
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    kt, vt = (t.repeat_interleave(rep, dim=1) for t in (kt, vt))
    Sq, Sk = q.shape[1], k.shape[1]
    i = torch.arange(Sq, device=q.device)[:, None]
    j = torch.arange(Sk, device=q.device)[None, :]
    mask = (j <= i) if causal else torch.ones_like(j <= i)
    mask = mask[None, None]
    if valid is not None:
        mask = mask & (j < valid[:, None, None, None])
    return qt, kt, vt, mask


def rand_bf16(gen, shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).bfloat16()


def layer_cycle(n_layers):
    """Layer indices 0, 1, ..., n-1, 0, ... for timing loops: consecutive
    launches read different layers, as the decode does, so a layer's
    weights are not found in L2 from the previous launch."""
    state = {"i": -1}

    def nxt():
        state["i"] = (state["i"] + 1) % n_layers
        return state["i"]
    return nxt


def check_kernel(name, kernel, plain, cases, tol, rel=False,
                 deterministic=False):
    """cases: (label, (args, kwargs), (ref_args, ref_kwargs), timed,
    yard). The kernel on args is compared with the plain version on
    ref_args (fp32 values of the same inputs); `timed(fn)` returns a
    zero-argument launch of fn on the kernel's inputs, which times both;
    yard is (bound(), library) with `library` a zero-argument call of one
    PyTorch function computing the same, timed as a yardstick (None where
    there is none; the text of its refusal where PyTorch refuses it). With
    rel, the error bound is tol * max|ref|; with deterministic, a second
    call must give the same bits. Returns {"max_abs_err": the worst,
    "cases": a row per case}."""
    worst, rows = 0.0, []
    for label, (args, kw), (rargs, rkw), timed, yard in cases:
        got = kernel(*args, **kw)
        again = kernel(*args, **kw) if deterministic else got
        ref = plain(*rargs, **rkw).float()
        torch.cuda.synchronize()
        if not torch.equal(got, again):
            raise RuntimeError(f"{name} {label}: two calls differ")
        got = got.float()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: non-finite output")
        err = (got - ref).abs().max().item()
        bound = tol * ref.abs().max().item() if rel else tol
        del got, again, ref
        (bound_ms, bound_by), library = yard
        row = {"case": label, "max_abs_err": err,
               "ms": cuda_ms(timed(kernel)),
               "plain_ms": cuda_ms(timed(plain), iters=3),
               "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": cuda_ms(library) if callable(library) else None}
        if isinstance(library, str):
            row["library_refused"] = library
        log(f"[{name}] {label}: max_abs_err {err:.3e} (bound {bound:.3e}), "
            f"kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.3f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}), library "
            + (f"{row['library_ms']:.4f} ms" if callable(library)
               else library or "none")
            + (", two calls bit-equal" if deterministic else ""))
        if not err <= bound:
            raise RuntimeError(f"{name} {label}: max_abs_err {err} > {bound}")
        worst = max(worst, err)
        rows.append(row)
        torch.cuda.empty_cache()
    return {"max_abs_err": worst, "cases": rows}


def attention_cases(gen):
    """K1 and K10 (the same tensors) at the towers' shapes, K2 at both
    prefills' shapes; each case's bound and the torch SDPA yardstick with
    the same mask (k/v heads repeated; no mask where every key counts)."""
    F = torch.nn.functional

    def qkv_case(label, qkv, kw):
        valid, causal = kw.get("valid_len"), kw.get("causal", False)
        sq, sk, sv, mask = sdpa_args(*qkv, valid, causal)
        if valid is None and not causal:
            mask = None
        yard = (attention_bound(qkv[0], qkv[1], valid, causal, 2,
                                qkv[0].nbytes),
                lambda: F.scaled_dot_product_attention(sq, sk, sv,
                                                       attn_mask=mask))
        return (label, (qkv, kw), (tuple(t.float() for t in qkv), kw),
                lambda f: (lambda: f(*qkv, **kw)), yard)
    clip = tuple(rand_bf16(gen, (64, 577, 16, 64)) for _ in range(3))
    ragged = torch.randint(300, 578, (64,), generator=gen, device="cuda",
                           dtype=torch.int32)
    siglip = tuple(rand_bf16(gen, (128, 729, 16, 72)) for _ in range(3))
    tower = [qkv_case("[64,577,16,64]", clip, {}),
             qkv_case("[64,577,16,64] ragged valid_len", clip,
                      {"valid_len": ragged}),
             qkv_case("[128,729,16,72]", siglip, {})]
    prefill = []
    for B, S, H, K, valid in ((4, BUCKET, 32, 8, [1574, 1200, 1664, 900]),
                              (4, QWEN2_BUCKET, 28, 4,
                               [1405, 1000, 1408, 700])):
        qkv = (rand_bf16(gen, (B, S, H, 128)), rand_bf16(gen, (B, S, K, 128)),
               rand_bf16(gen, (B, S, K, 128)))
        prefill.append(qkv_case(
            f"q[{B},{S},{H},128] kv[{B},{S},{K},128] causal, valid_len "
            f"{valid}", qkv, {"causal": True, "valid_len": torch.tensor(
                valid, dtype=torch.int32, device="cuda")}))
    return tower, prefill


def check_pairs_against_k1(k1, cases) -> dict:
    """K10 against K1 on each tower case (the same function and softmax,
    K10's products on wgmma, K1's on mma.sync): within K1_TOL, and whether
    the two are bit-equal."""
    out = {}
    for label, (args, kw), _, _, _ in cases:
        pairs = k1.encoder_attention(*args, pack_pairs=True, **kw)
        single = k1.encoder_attention(*args, **kw)
        diff = (pairs.float() - single.float()).abs().max().item()
        equal = torch.equal(pairs, single)
        log(f"[encoder_attention_pairs] {label}: vs K1 max abs diff "
            f"{diff:.3e} (bound {K1_TOL}), bit-equal {equal}")
        if not diff <= K1_TOL:
            raise RuntimeError(f"K10 and K1 differ by {diff} at {label}")
        out[label] = {"max_abs_diff": diff, "bit_equal": equal}
    return out


def decode_attention_cases(gen, quantize_rows, k3, H, K, bucket, variants):
    """K3 at a slice's decode shape: B 16, H query heads on K kv heads of
    128, M the kv8 max_len, the prompt bucket, the 32nd token (write_pos
    bucket + 31), valid_len ragged over [bucket - 464, bucket], four cache
    layers rotated in timing. variants: (cache "int8" or "bf16", window).
    Each case's bound counts the cache rows K3 reads (prompt rows below
    valid_len and the generated rows, inside the window) with their
    scales, q, the new k/v rows and the output; the yardstick is SDPA over
    the same rows of a bf16 cache, the new row read from the cache."""
    F = torch.nn.functional
    L, B, hd = 4, 16, 128
    M = -(-(bucket + NEW_TOKENS) // 256) * 256
    write_pos = bucket + NEW_TOKENS - 1
    valid = torch.randint(bucket - 464, bucket + 1, (B,), generator=gen,
                          device="cuda", dtype=torch.int32)
    q = rand_bf16(gen, (B, H, hd), 4.0)
    k_new, v_new = rand_bf16(gen, (B, K, hd)), rand_bf16(gen, (B, K, hd))
    rows = [torch.randn((L, B, M, K, hd), generator=gen, device="cuda")
            for _ in range(2)]
    (kq, ks), (vq, vs) = quantize_rows(rows[0]), quantize_rows(rows[1])
    caches = {"int8": ((kq.reshape(L, B, M, -1), vq.reshape(L, B, M, -1)),
                       dict(k_scale=ks.transpose(2, 3).contiguous(),
                            v_scale=vs.transpose(2, 3).contiguous()))}
    if any(cache == "bf16" for cache, _ in variants):
        caches["bf16"] = (tuple(r.reshape(L, B, M, -1).bfloat16()
                                for r in rows), {})
    sq, sk, sv, _ = sdpa_args(q[:, None], rows[0][1].bfloat16(),
                              rows[1][1].bfloat16(), None, False)
    del rows
    j = torch.arange(M, device="cuda")
    cases = []
    for cache, window in variants:
        (ck, cv), kw = caches[cache]
        if window is not None:
            kw = dict(kw, window=window)
        keep = k3._keep(valid, write_pos, bucket, window, M)
        rows_read = keep.sum().item()
        row_bytes = K * (hd + 4) if cache == "int8" else K * hd * 2
        mask = (keep | (j[None] == write_pos))[:, None, None]
        yard = (bound(4 * H * hd * rows_read,
                      rows_read * 2 * row_bytes + 2 * q.nbytes
                      + k_new.nbytes + v_new.nbytes),
                lambda mask=mask: F.scaled_dot_product_attention(
                    sq, sk, sv, attn_mask=mask))
        args = (q, k_new, v_new, ck, cv, 1, valid, write_pos, bucket)
        cyc = layer_cycle(L)
        cases.append((
            f"q[{B},{H},{hd}] {cache}[{L},{B},{M},{K * hd}] ragged "
            f"valid_len, write_pos {write_pos}"
            + (f", window {window}" if window else ""),
            (args, kw), ((q.float(),) + args[1:], kw),
            lambda f, ck=ck, cv=cv, kw=kw, cyc=cyc: (
                lambda: f(q, k_new, v_new, ck, cv, cyc(), valid, write_pos,
                          bucket, **kw)), yard))
    return cases


def int8pack_library(x, q, s, plain):
    """torch._weight_int8pack_mm(x, w [Dout, Din] int8, scales [Dout] bf16)
    computes (x @ w.T) * scales: K4's and matmul_q8's function. q [L, Din,
    Dout] int8 and s [L, 1, Dout]: a transposed copy of every layer is made
    here, outside the timing, and the call rotates over them as the kernel
    does. Returns a zero-argument call, or the refusal's text when PyTorch
    refuses the call (this build or this shape)."""
    wt = [q[i].t().contiguous() for i in range(q.shape[0])]
    sc = [s[i].reshape(-1).bfloat16() for i in range(q.shape[0])]
    return _library_call(
        "torch._weight_int8pack_mm",
        lambda i: torch._weight_int8pack_mm(x, wt[i], sc[i]),
        len(wt), lambda: plain(x.float(), q[0], s[0]))


def int4pack_library(x, q4, s, plain):
    """torch._weight_int4pack_mm(x, w, 256, scales_and_zeros) with w the
    int4 values (v + 8, two a byte, even k in the high nibble) packed by
    torch._convert_weight_to_int4pack and each group of 256 given the
    layer's per-channel scale and a zero of 0: (q - 8) * scale + 0 = v *
    scale, K6's function. Every layer is repacked here, outside the
    timing; returns a call, or the refusal's text."""
    from videollama2_tpu_torch.ops.quant import unpack_int4
    try:
        packs = []
        for i in range(q4.shape[0]):
            u = (unpack_int4(q4[i]).t().to(torch.int16) + 8).to(torch.uint8)
            w = torch._convert_weight_to_int4pack(
                (u[:, ::2] << 4 | u[:, 1::2]).contiguous(), 8)
            scale = s[i].reshape(1, -1, 1).bfloat16().expand(
                u.shape[1] // 256, -1, 1)
            packs.append((w, torch.cat([scale, torch.zeros_like(scale)],
                                       -1).contiguous()))
    except RuntimeError as e:
        return _refused("torch._weight_int4pack_mm", e)
    return _library_call(
        "torch._weight_int4pack_mm",
        lambda i: torch._weight_int4pack_mm(x, packs[i][0], 256,
                                            packs[i][1]),
        len(packs), lambda: plain(x.float(), q4[0], s[0]))


def _refused(name, e) -> str:
    text = f"{name} refused: {str(e).splitlines()[0][:160]}"
    log(f"[library] {text}")
    return text


def _library_call(name, call, n_layers, ref):
    """call(i) on layer i; one call on layer 0 is checked against the plain
    version (ref) and logged, so the yardstick is known to compute the
    kernel's function. Returns a zero-argument call rotating over the
    layers, or the refusal's text."""
    try:
        got = call(0).float()
        torch.cuda.synchronize()
    except RuntimeError as e:
        return _refused(name, e)
    want = ref().float()
    log(f"[library] {name} at x{list(got.shape[:1])} -> {got.shape[1]}: vs "
        f"plain max abs diff {(got - want).abs().max().item():.3e} "
        f"(max|out| {want.abs().max().item():.3e})")
    cyc = layer_cycle(n_layers)
    return lambda: call(cyc())


def matmul_cases(gen, quantize, library, mm_layers, D, qkv_out, F_):
    """K4 (K6 with int4 packs) at the fused qkv [D -> qkv_out] and o
    [D -> D], K5 (K7) at [D, F_], R = 16 rows, bf16 scales as the Engine
    casts them; `mm_layers` (K4/K6: enough that the rotated layers
    overflow the 50 MB L2) or two (K5/K7) layers rotated in timing.
    `quantize(w)` -> (weight bytes, scale) of an [..., in, out] kernel;
    `library(x, q, s)` -> K4's or K6's PyTorch yardstick (int8pack_library,
    int4pack_library). Bounds: each weight byte read once (h, the FFN's
    intermediate, stays inside the kernel's work); no one PyTorch call
    computes the FFN, so K5 and K7 have no library yardstick."""
    def pack(L, din, dout):
        q, s = quantize(rand_bf16(gen, (L, din, dout), 0.02))
        return q, s.bfloat16()
    x = rand_bf16(gen, (16, D))
    k4 = []
    for label, dout in ((f"qkv x[16,{D}] [{mm_layers},{D},{qkv_out}]",
                         qkv_out),
                        (f"o x[16,{D}] [{mm_layers},{D},{D}]", D)):
        q, s = pack(mm_layers, D, dout)
        yard = (bound(2 * 16 * D * dout, q[0].nbytes + s[0].nbytes
                      + x.nbytes + 16 * dout * 2), library(x, q, s))
        cyc = layer_cycle(mm_layers)
        k4.append((label, ((x, q, s, 1), {}), ((x.float(), q, s, 1), {}),
                   lambda f, q=q, s=s, cyc=cyc: (
                       lambda: f(x, q, s, cyc())), yard))
    g, u, d = pack(2, D, F_), pack(2, D, F_), pack(2, F_, D)
    cyc = layer_cycle(2)
    yard = (bound(2 * 16 * 3 * D * F_, sum(t[0].nbytes for t in (*g, *u, *d))
                  + 2 * x.nbytes), None)
    k5 = [(f"x[16,{D}] gate/up[2,{D},{F_}] down[2,{F_},{D}]",
           ((x, *g, *u, *d, 1), {}), ((x.float(), *g, *u, *d, 1), {}),
           lambda f: (lambda: f(x, *g, *u, *d, cyc())), yard)]
    return k4, k5


def head_matmul_case(gen, quantize_int8, plain):
    """matmul_q8 at the int8 head's shape, x[16,4096] q[4096,32000], fp32
    scales (the JAX pack's); its yardstick is torch._weight_int8pack_mm."""
    x = rand_bf16(gen, (16, 4096))
    p = quantize_int8(rand_bf16(gen, (4096, 32000), 0.02), axis=-2)
    q, s = p["q"], p["scale"][0]
    yard = (bound(2 * 16 * 4096 * 32000,
                  q.nbytes + s.nbytes + x.nbytes + 16 * 32000 * 2),
            int8pack_library(x, q[None], s[None, None],
                             lambda x, q, s: plain(x, q, s)))
    return [("x[16,4096] q[4096,32000]", ((x, q, s), {}),
             ((x.float(), q, s), {}), lambda f: (lambda: f(x, q, s)), yard)]


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def run_slice(name, eng, cfg, frames, prompt, gcfg, counters, want):
    """Two generate runs of 16 videos; checks the launch counts of every
    kernel on the path (counters: name -> wrapper) against `want`, the
    token shapes, and that both runs gave the same tokens. Returns the
    counts and the stage split of the second run."""
    B = frames.shape[0]
    runs, stage = [], {}
    for run in range(2):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_frames = eng.upload_frames(frames)
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        stamps = {}
        t0 = time.perf_counter()
        out = eng.generate([prompt] * B, frames=dev_frames, gen=gcfg,
                           eos_token_id=-1,
                           stream_cb=lambda b, toks: stamps.setdefault(
                               len(toks), time.perf_counter()))
        t_end = time.perf_counter()
        counts = {n: fn.launches for n, fn in counters.items()}
        log(f"[{name}] run {run + 1}: launches {counts} (want {want})")
        if counts != want:
            raise RuntimeError(f"{name}: kernel launch counts {counts} != "
                               f"{want}")
        toks = np.asarray(out)
        if toks.shape != (B, NEW_TOKENS) or toks.min() < 0 \
                or toks.max() >= cfg.llm.vocab_size:
            raise RuntimeError(f"bad tokens: shape {toks.shape}, range "
                               f"[{toks.min()}, {toks.max()}]")
        runs.append(toks)
        t_first = min(stamps.values())
        stage = {"upload_s": t_upload,
                 "encode_prefill_first_token_s": t_first - t0,
                 "decode_ms_per_token":
                     (t_end - t_first) / (NEW_TOKENS - 1) * 1e3,
                 "generate_s": t_end - t0}
        log(f"[{name}] run {run + 1}: upload {t_upload * 1e3:.1f} ms "
            f"({frames.nbytes / 1e6:.0f} MB), encode+prefill+first token "
            f"{stage['encode_prefill_first_token_s']:.3f} s, decode "
            f"{stage['decode_ms_per_token']:.2f} ms/token, generate "
            f"{stage['generate_s']:.3f} s")
    if not np.array_equal(runs[0], runs[1]):
        raise RuntimeError(f"{name}: the two runs gave different tokens")
    log(f"[{name}] {B}x{NEW_TOKENS} tokens, identical in both runs; "
        f"first row: {runs[1][0][:8].tolist()}...")
    return counts, stage


def _plan_args(cfg, frames, prompt, dev, bucket):
    from videollama2_tpu_torch.multimodal import splice as splice_lib
    plan = splice_lib.plan_batch([prompt] * frames.shape[0],
                                 cfg.tokens_per_video, bucket)
    return (torch.from_numpy(frames).to(dev),
            torch.from_numpy(plan.text_ids).to(dev).long(),
            torch.from_numpy(plan.is_visual).to(dev),
            torch.from_numpy(plan.vis_index).to(dev),
            torch.from_numpy(plan.positions).to(dev),
            torch.from_numpy(plan.valid_len).to(dev))


def compare_logits(name, fast, plain) -> None:
    """The bounds are relative to the logits' std: a wrong mask, head
    mapping or weight slice moves logits by about a std; rounding in
    another order moves them by a few hundredths of one."""
    if not (torch.isfinite(fast).all() and torch.isfinite(plain).all()):
        raise RuntimeError(f"{name}: non-finite logits")
    diff = (fast - plain).abs()
    std = plain.std().item()
    agree = (fast.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[{name}] kernels vs plain: max abs diff {diff.max().item():.4f} "
        f"(bound 0.4 std), mean abs diff {diff.mean().item():.4f} (bound "
        f"0.05 std), logit std {std:.4f}, argmax agreement {agree:.2f}")
    if not (diff.max().item() <= 0.4 * std
            and diff.mean().item() <= 0.05 * std):
        raise RuntimeError(f"{name}: kernel path logits differ from the "
                           "plain path beyond the bounds")


def check_against_plain(eng, cfg, frames, prompt, bucket, attn, k1,
                        k2) -> None:
    """First-token logits of two videos through the kernels and through
    the plain attention path (attend swapped for attend_plain), both at
    full width in bf16. The two differ only by rounding inside attention
    (the order of the fp32 sums, exp), which the tower's and the LLM's
    bf16 layers amplify."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2

    args = _plan_args(cfg, frames, prompt, eng.device, bucket)

    def first_logits():
        cache = llm_lib.init_cache(cfg.llm, frames.shape[0], bucket,
                                   torch.bfloat16, device=eng.device)
        with torch.inference_mode():
            last, _ = vl2.prefill_multimodal(eng.params, cfg, *args, cache)
            return llm_lib.lm_logits(eng.params["llm"], cfg.llm, last)

    before = (k1.encoder_attention.launches, k2.flash_attention.launches)
    fast = first_logits()
    if (k1.encoder_attention.launches, k2.flash_attention.launches) == before:
        raise RuntimeError("kernel path did not launch the kernels")
    kernel_attend = attn.attend
    attn.attend = lambda q, k, v, valid_len=None, causal=True, window=None, \
        scale=None: attn.attend_plain(q, k, v, valid_len, causal, window,
                                      scale)
    try:
        plain = first_logits()
    finally:
        attn.attend = kernel_attend
    torch.cuda.synchronize()
    compare_logits("bf16 first-token logits", fast, plain)


def check_decode_against_plain(eng, cfg, frames, prompt, bucket, k3, dk,
                               bits) -> None:
    """Decode logits of two videos over the int8 (bits 8) or int4 (bits 4)
    packs and the int8 cache: a W8A8/W4A8 prefill fills the cache, then
    DECODE_CHECK_STEPS teacher-forced decode steps run once on K3 and
    K4/K5 (or K6/K7) and once, from a copy of the same cache, with their
    plain versions swapped in. Both run in bf16."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2

    args = _plan_args(cfg, frames, prompt, eng.device, bucket)
    valid = args[-1]
    B, L = frames.shape[0], cfg.llm.num_layers
    cache = llm_lib.init_cache(cfg.llm, B, eng.max_len, kv_bits=8,
                               device=eng.device)
    with torch.inference_mode():
        vl2.prefill_multimodal(eng.params, cfg, *args, cache, w8a8=True)
    snapshot = llm_lib.KVCache(*(t.clone() for t in (
        cache.k, cache.v, cache.k_scale, cache.v_scale)))
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        10, min(1000, cfg.llm.vocab_size), (DECODE_CHECK_STEPS, B))
    ).to(eng.device)

    def decode_logits(c):
        out = []
        with torch.inference_mode():
            for s in range(DECODE_CHECK_STEPS):
                te = llm_lib.embed_tokens(eng.params["llm"],
                                          tokens[s][:, None], eng.dtype)
                logits, c = llm_lib.decode_step(
                    eng.params["llm"], cfg.llm, te, c, valid, bucket, s,
                    w8a8=True)
                out.append(logits)
        return torch.stack(out)

    mm, ffn = f"matmul_q{bits}_layered", f"ffn_q{bits}_layered"
    swaps = ((k3, "decode_attention_layered", k3.decode_attention_plain),
             (dk, mm, getattr(dk, mm + "_plain")),
             (dk, ffn, getattr(dk, ffn + "_plain")))
    before = [getattr(m, n).launches for m, n, _ in swaps]
    fast = decode_logits(cache)
    added = [getattr(m, n).launches - b for (m, n, _), b in zip(swaps, before)]
    want = [DECODE_CHECK_STEPS * L, 2 * DECODE_CHECK_STEPS * L,
            DECODE_CHECK_STEPS * L]
    if added != want:
        raise RuntimeError(f"int{bits} decode launches {added} != {want}")
    saved = [getattr(m, n) for m, n, _ in swaps]
    for m, n, plain_fn in swaps:
        setattr(m, n, plain_fn)
    try:
        plain = decode_logits(snapshot)
    finally:
        for (m, n, _), fn in zip(swaps, saved):
            setattr(m, n, fn)
    torch.cuda.synchronize()
    compare_logits(f"int{bits} decode logits, {DECODE_CHECK_STEPS} "
                   "teacher-forced steps", fast, plain)


PTXAS_KERNELS = ("flash_bwd_dq_kernel", "flash_bwd_dkv_kernel",
                 "flash_attention_kernel", "encoder_attention_pairs_kernel",
                 "encoder_attention_pipelined_kernel", "decode_chunk_kernel",
                 "decode_combine_kernel", "splitk_kernel")


def ptxas_report(path) -> dict:
    """Registers and spills of the attention and decode matmul kernels
    (each template instance by its integer and bool arguments: head dim,
    then causal flag or query heads a kv head; decode_chunk_kernel's cache
    type a = int8; splitk_kernel (K4, matmul_q8, K5, K6, K7) weights,
    16-row tiles, fp32 scales, folded int4: <1, ., ., 0> is K4 and K5's
    down pass, <2, ., ., 0> K5's gate/up, <1, ., ., 1> K6 and K7's down
    pass, <2, ., ., 1> K7's gate/up), from the ptxas report the build
    wrote beside the library. Logs each and returns {instance: (registers
    line, spill line)}; ptxas counts the warpgroup kernels' (K10, K2, K8,
    K9) registers at launch, before setmaxnreg."""
    if not path.exists():
        log(f"[ptxas] no report at {path}")
        return {}
    name, found = None, {}
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((n for n in PTXAS_KERNELS if n in line), None)
            if name:
                tmpl = line.split(name, 1)[1].split("'", 1)[0]
                args = re.findall(r"L[ib](\d+)E", tmpl)
                name += f" <{', '.join(args)}>" + (
                    " int8" if "EaE" in tmpl else "")
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            used = line.split(":", 1)[1].strip()
            log(f"[ptxas] {name}: {used}; {spill}")
            found[name] = (used, spill)
            name = None
    return found


def check_no_spills(report: dict, kernels) -> None:
    """Every D 128 instance of `kernels` (K2, K8, K9) is in the report and
    spills nothing."""
    for kernel in kernels:
        rows = {n: s for n, (_, s) in report.items()
                if n.startswith(f"{kernel} <128,")}
        if not rows:
            raise RuntimeError(f"ptxas report has no D 128 {kernel}")
        for n, spill in rows.items():
            if "0 bytes spill stores, 0 bytes spill loads" not in spill:
                raise RuntimeError(f"{n} spills: {spill}")
    log(f"[ptxas] no spills in the D 128 instances of {', '.join(kernels)}")


def check_training_attention(gen, k2) -> dict:
    """K2 with its LSE, K8 and K9 at the training slice's shape (q
    [8, 2048, 32, 128], k/v [8, 2048, 8, 128] bf16, causal, valid_len
    spread over 1400-2048) against their plain versions on the fp32 values
    (the same o and lse feed both backward versions), with CUDA-event
    times, bounds and the torch SDPA forward and backward as yardsticks."""
    F = torch.nn.functional
    B, S = TRAIN_B, TRAIN_S
    q = rand_bf16(gen, (B, S, 32, 128))
    k, v = rand_bf16(gen, (B, S, 8, 128)), rand_bf16(gen, (B, S, 8, 128))
    do = rand_bf16(gen, (B, S, 32, 128))
    valid = torch.tensor(np.linspace(TRAIN_MIN_VALID, S, B).round(),
                         dtype=torch.int32, device="cuda")
    label = f"q[{B},{S},32,128] kv[{B},{S},8,128] causal, valid_len " \
        f"{valid.tolist()}"
    qf, kf, vf = q.float(), k.float(), v.float()
    out = {}

    def report(name, errs, fn, plain_fn, bnd, library_ms):
        ms, plain_ms = cuda_ms(fn), cuda_ms(plain_fn, iters=3)
        worst = max(e for e, _ in errs)
        log(f"[{name}] {label}: max_abs_err "
            + ", ".join(f"{e:.3e} (bound {b:.3e})" for e, b in errs)
            + f"; kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
            f"{bnd[0]:.4f} ms ({bnd[1]}), torch SDPA {library_ms:.4f} ms")
        for e, b in errs:
            if not e <= b:
                raise RuntimeError(f"{name}: max_abs_err {e} > {b}")
        out[name] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                     "bound_ms": bnd[0], "bound_by": bnd[1],
                     "library_ms": library_ms}

    def err(got, ref, tol):
        return ((got.float() - ref.float()).abs().max().item(),
                tol * ref.abs().max().item())

    o, lse = k2.flash_attention(q, k, v, valid, True, return_lse=True)
    ro, rlse = k2.flash_attention_plain(qf, kf, vf, valid, True,
                                        return_lse=True)
    errs = [(err(o, ro, 1)[0], K2_TOL), (err(lse, rlse, 1)[0], LSE_TOL)]
    del ro, rlse
    sq, sk, sv, smask = sdpa_args(q, k, v, valid, True)
    sq, sk, sv = (t.detach().requires_grad_(True) for t in (sq, sk, sv))
    report("flash_attention +lse", errs,
           lambda: k2.flash_attention(q, k, v, valid, True, return_lse=True),
           lambda: k2.flash_attention_plain(q, k, v, valid, True,
                                            return_lse=True),
           attention_bound(q, k, valid, True, 2, q.nbytes + lse.nbytes),
           cuda_ms(lambda: F.scaled_dot_product_attention(
               sq, sk, sv, attn_mask=smask)))
    sdpa_out = F.scaled_dot_product_attention(sq, sk, sv, attn_mask=smask)
    sdo = do.transpose(1, 2)
    sdpa_bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        sdpa_out, (sq, sk, sv), sdo, retain_graph=True))
    del sdpa_out, sq, sk, sv, smask

    dq, delta = k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid, True)
    rdq, rdelta = k2.flash_attention_bwd_dq_plain(qf, kf, vf, o.float(), lse,
                                                  do.float(), valid, True)
    errs = [err(dq, rdq, BWD_REL_TOL), err(delta, rdelta, 1e-5)]
    again = k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid, True)[0]
    if not torch.equal(dq, again):
        raise RuntimeError("flash_attention_bwd_dq: two runs differ")
    del rdq, rdelta, again
    row_bytes = lse.nbytes  # lse and delta: fp32 [B, Hq, S]
    report("flash_attention_bwd_dq", errs,
           lambda: k2.flash_attention_bwd_dq(q, k, v, o, lse, do, valid,
                                             True),
           lambda: k2.flash_attention_bwd_dq_plain(q, k, v, o, lse, do,
                                                   valid, True),
           attention_bound(q, k, valid, True, 3,
                           3 * q.nbytes + 2 * row_bytes),
           sdpa_bwd_ms)

    dk, dv = k2.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid, True)
    rdk, rdv = k2.flash_attention_bwd_dkv_plain(qf, kf, vf, do.float(), lse,
                                                delta, valid, True)
    errs = [err(dk, rdk, BWD_REL_TOL), err(dv, rdv, BWD_REL_TOL)]
    again = k2.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid, True)
    if not (torch.equal(dk, again[0]) and torch.equal(dv, again[1])):
        raise RuntimeError("flash_attention_bwd_dkv: two runs differ")
    del rdk, rdv, again
    report("flash_attention_bwd_dkv", errs,
           lambda: k2.flash_attention_bwd_dkv(q, k, v, do, lse, delta, valid,
                                              True),
           lambda: k2.flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta,
                                                    valid, True),
           attention_bound(q, k, valid, True, 4,
                           q.nbytes + 2 * k.nbytes + 2 * row_bytes),
           sdpa_bwd_ms)
    log("[training attention] K8 and K9 gave bit-identical results in two "
        "runs each")
    return out


def _checksums(tensors) -> list:
    """Exact checksums: each tensor's bits summed as integers."""
    ints = {2: torch.int16, 4: torch.int32, 1: torch.int8}
    return [torch.sum(t.detach().view(ints[t.element_size()]),
                      dtype=torch.int64).item() for t in tensors]


def run_training(cfg, params, batches, counters, want, out_dir) -> dict:
    """Two runs of TRAIN_STEPS optimizer steps through Trainer.train from
    the same params; checks launch counts, losses (finite, equal in both
    runs), that the connector changed and that no frozen tensor did."""
    from videollama2_tpu_torch.train.optimizer import (OptimizerConfig,
                                                       flatten)
    from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig
    flat = flatten(params)
    conn = {p: t for p, t in flat.items() if p[0] == "connector"}
    conn0 = {p: t.detach().clone() for p, t in conn.items()}
    frozen = [t for p, t in flat.items() if p[0] != "connector"]
    frozen0 = _checksums(frozen)
    valid_tokens = [int(b.valid_len.sum()) for b in batches]
    runs = []
    for run in range(2):
        with torch.no_grad():
            for p, t in conn.items():
                t.copy_(conn0[p])
        trainer = Trainer(
            cfg, params,
            OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0,
                            weight_decay=0.0, tune_mm_mlp_adapter=True),
            TrainerConfig(output_dir=out_dir,
                          gradient_accumulation_steps=GRAD_ACCUM,
                          max_steps=TRAIN_STEPS, log_steps=1,
                          save_steps=10 ** 9))
        inner, steps = trainer.step_fn, []

        def timed(state, batch, inner=inner, steps=steps):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            state, metrics = inner(state, batch)
            torch.cuda.synchronize()
            steps.append({"s": time.perf_counter() - t0,
                          "loss": float(metrics["loss"]),
                          "num_tokens": int(metrics["num_tokens"]),
                          "accuracy": float(metrics["accuracy"]),
                          "peak_gb": torch.cuda.max_memory_allocated()
                          / 1e9})
            return state, metrics
        trainer.step_fn = timed
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        trainer.train(iter(batches))
        t_train = time.perf_counter() - t0
        counts = {n: fn.launches for n, fn in counters.items()}
        for i, st in enumerate(steps):
            log(f"[training slice] run {run + 1} step {i + 1}: "
                f"{st['s']:.3f} s, {valid_tokens[i] / st['s']:.0f} valid "
                f"tokens/s ({valid_tokens[i]} tokens, {st['num_tokens']} "
                f"supervised), loss {st['loss']:.6f}, accuracy "
                f"{st['accuracy']:.4f}, peak {st['peak_gb']:.1f} GB")
        log(f"[training slice] run {run + 1}: Trainer.train {t_train:.1f} s "
            f"with the projector save; launches {counts} (want {want})")
        if counts != want:
            raise RuntimeError(f"training: launch counts {counts} != {want}")
        if not all(np.isfinite(st["loss"]) for st in steps):
            raise RuntimeError("training: non-finite loss")
        if run == 0 and all(torch.equal(t, conn0[p])
                            for p, t in conn.items()):
            raise RuntimeError("training: the connector did not change")
        runs.append([st["loss"] for st in steps])
        stats = steps
    if runs[0] != runs[1]:
        raise RuntimeError(f"training: the two runs' losses differ: {runs}")
    if _checksums(frozen) != frozen0:
        raise RuntimeError("training: a frozen tensor changed")
    log(f"[training slice] losses identical in both runs {runs[1]}; the "
        f"connector changed; all {len(frozen)} frozen tensors unchanged "
        "(bit checksums)")
    return {"steps": stats, "valid_tokens": valid_tokens}


def check_training_against_plain(cfg, params, batch, k2, counters) -> dict:
    """One microbatch of 2 rows through forward_train and its backward,
    with the flash kernels, with FlashAttention's halves swapped for their
    plain versions, and with the kernels' attention outputs and gradients
    each moved by up to one bf16 ulp (x (1 + 2^-8 u), u uniform in
    [-1, 1), seeded). The tower's K1 runs in all three.

    Bounds: the kernel and plain runs compute the same bf16 model and
    differ by where attention rounds (bf16 P and dS inside the kernels'
    products, fp32 sums in another order, fast exp; the plain backward has
    no bf16 intermediates), which is of the size of one more bf16 rounding
    of each attention output and gradient, and the 32 layers carry it
    forward and back to the connector. The jittered run measures how far
    exactly that moves the connector gradient on this batch (the rounding
    floor), so the kernel-vs-plain difference is held to twice the floor's
    relative L2; besides, cosine >= TRAIN_GRAD_COS and the loss to
    TRAIN_LOSS_REL_TOL."""
    from videollama2_tpu_torch.train.data import Batch
    from videollama2_tpu_torch.train.optimizer import flatten
    from videollama2_tpu_torch.train.step import loss_fn
    mb = Batch(*(a[:2] for a in batch))
    conn = list(flatten(params["connector"]).values())

    def loss_and_grad():
        for t in conn:
            t.grad = None
        loss, _ = loss_fn(params, cfg, mb)
        loss.backward()
        g = torch.cat([t.grad.float().flatten() for t in conn])
        for t in conn:
            t.grad = None
        return loss.item(), g

    def swapped(**attrs):
        saved = {n: getattr(k2, n) for n in attrs}
        for n, fn in attrs.items():
            setattr(k2, n, fn)
        try:
            return loss_and_grad()
        finally:
            for n, fn in saved.items():
                setattr(k2, n, fn)

    names = ("flash_attention", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv")
    before = [counters[n].launches for n in names]
    loss_k, g_k = loss_and_grad()
    added = [counters[n].launches - b for n, b in zip(names, before)]
    L = cfg.llm.num_layers
    if added != [2 * L, L, L]:
        raise RuntimeError(f"kernel microbatch launches {added}")
    before = [counters[n].launches for n in names]
    loss_p, g_p = swapped(flash_attention=k2.flash_attention_plain,
                          flash_attention_bwd=k2.flash_attention_bwd_plain)
    if [counters[n].launches for n in names] != before:
        raise RuntimeError("the plain microbatch launched a kernel")

    noise = torch.Generator(device=g_k.device).manual_seed(0)

    def jitter(t):
        if t is None:
            return None
        u = torch.rand(t.shape, generator=noise, device=t.device) * 2 - 1
        return (t.float() * (1 + 2.0 ** -8 * u)).to(t.dtype)
    kernels = k2.FlashAttention

    class Jittered(torch.autograd.Function):
        """FlashAttention on the kernels, its output and gradients each
        moved by up to one bf16 ulp."""
        @staticmethod
        def forward(ctx, *args):
            return jitter(kernels.forward(ctx, *args))

        @staticmethod
        def backward(ctx, do):
            return tuple(jitter(g) for g in kernels.backward(ctx, do))
    before = [counters[n].launches for n in names]
    loss_j, g_j = swapped(FlashAttention=Jittered)
    if [counters[n].launches - b for n, b in zip(names, before)] \
            != [2 * L, L, L]:
        raise RuntimeError("the jittered microbatch skipped the kernels")

    def rel_l2(a, b):
        return ((a - b).norm() / b.norm()).item()
    cos = torch.nn.functional.cosine_similarity
    res = {"loss_kernels": loss_k, "loss_plain": loss_p,
           "loss_rel_diff": abs(loss_k - loss_p) / abs(loss_p),
           "grad_rel_l2": rel_l2(g_k, g_p),
           "grad_cosine": cos(g_k, g_p, dim=0).item(),
           "floor_loss_rel_diff": abs(loss_j - loss_k) / abs(loss_k),
           "floor_grad_rel_l2": rel_l2(g_j, g_k),
           "floor_grad_cosine": cos(g_j, g_k, dim=0).item()}
    log(f"[training vs plain attention] {json.dumps(res)} (bounds: loss "
        f"{TRAIN_LOSS_REL_TOL}, rel L2 2 x floor = "
        f"{2 * res['floor_grad_rel_l2']:.4f}, cosine >= {TRAIN_GRAD_COS})")
    if not (res["loss_rel_diff"] <= TRAIN_LOSS_REL_TOL
            and res["grad_rel_l2"] <= 2 * res["floor_grad_rel_l2"]
            and res["grad_cosine"] >= TRAIN_GRAD_COS):
        raise RuntimeError("training: kernel and plain-attention loss or "
                           "connector gradient differ beyond the bounds")
    return res


def vit_layers(cfg) -> int:
    """Encoder layers the tower runs (select_layer -2: all but the last)."""
    return cfg.vision.select_layer % (cfg.vision.num_layers + 1)


def slice_inputs(cfg, B: int):
    """bench.py's inputs for B videos: seeded uint8 I420 frames and its
    prompt (40 text tokens, the video, 12 more), and the bucket: the
    spliced length rounded up to a multiple of 128."""
    H = cfg.vision.image_size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, cfg.num_frames, H + H // 2, H),
                          dtype=np.uint8)
    from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
    prompt = ([1] + [int(x) for x in rng.integers(10, 1000, 40)]
              + [VIDEO_TOKEN_INDEX]
              + [int(x) for x in rng.integers(10, 1000, 12)])
    spliced = len(prompt) - 1 + cfg.tokens_per_video
    return frames, prompt, -(-spliced // 128) * 128


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.models.llm import _quantize_kv_rows
    from videollama2_tpu_torch.ops import _build
    from videollama2_tpu_torch.ops import attention as attn
    from videollama2_tpu_torch.ops import decode_attention as k3
    from videollama2_tpu_torch.ops import decode_matmul as dk
    from videollama2_tpu_torch.ops import encoder_attention as k1
    from videollama2_tpu_torch.ops import flash_attention as k2
    from videollama2_tpu_torch.ops import quant_matmul as qm
    from videollama2_tpu_torch.ops.quant import quantize_int4, quantize_int8
    from videollama2_tpu_torch.utils.synthetic import (synthetic_params,
                                                       synthetic_train_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()

    # -- build -----------------------------------------------------------
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] nvcc sm_90a build of csrc/*.cu (one process a source) "
        f"{'(found built already) ' if cached else ''}and load: "
        f"{time.perf_counter() - t0:.1f} s")
    ptxas = ptxas_report(_build.library_path().parent / _build.BUILD_LOG)
    check_no_spills(ptxas, ("flash_attention_kernel", "flash_bwd_dq_kernel",
                            "flash_bwd_dkv_kernel"))

    # every kernel's counter, checked in every run of a path: a kernel off
    # the path must launch no time
    counters = {"encoder_attention": k1.encoder_attention,
                "encoder_attention_pairs": k1.encoder_attention_pairs,
                "flash_attention": k2.flash_attention,
                "decode_attention": k3.decode_attention_layered,
                "matmul_q8_layered": dk.matmul_q8_layered,
                "ffn_q8_layered": dk.ffn_q8_layered,
                "matmul_q4_layered": dk.matmul_q4_layered,
                "ffn_q4_layered": dk.ffn_q4_layered,
                "matmul_q8": qm.matmul_q8,
                "flash_attention_bwd_dq": k2.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": k2.flash_attention_bwd_dkv}

    # -- every kernel against its plain version at main-path shapes ---------
    gen = torch.Generator(device="cuda").manual_seed(0)
    res = {}
    tower_cases, prefill_cases = attention_cases(gen)
    res["encoder_attention"] = check_kernel(
        "encoder_attention", k1.encoder_attention, k1.encoder_attention_plain,
        tower_cases, K1_TOL)
    res["encoder_attention_pairs"] = check_kernel(
        "encoder_attention_pairs",
        functools.partial(k1.encoder_attention, pack_pairs=True),
        k1.encoder_attention_pairs_plain, tower_cases, K1_TOL)
    pairs_vs_k1 = check_pairs_against_k1(k1, tower_cases)
    res["flash_attention"] = check_kernel(
        "flash_attention", k2.flash_attention, k2.flash_attention_plain,
        prefill_cases, K2_TOL)
    del tower_cases, prefill_cases
    res["decode_attention_layered"] = check_kernel(
        "decode_attention", k3.decode_attention_layered,
        k3.decode_attention_plain,
        decode_attention_cases(gen, _quantize_kv_rows, k3, 32, 8, BUCKET,
                               (("int8", None), ("bf16", None),
                                ("int8", 1024)))
        + decode_attention_cases(gen, _quantize_kv_rows, k3, 28, 4,
                                 QWEN2_BUCKET, (("int8", None),)),
        K3_TOL)
    gc.collect()
    torch.cuda.empty_cache()
    # K4/K5 at Mistral-7B's and Qwen2-7B's widths; K6/K7 (int4, a Mistral
    # slice only) at Mistral-7B's, and also at Qwen2-7B's as kernel cases
    # (widths: D, qkv out, F)
    for mm, ffn, mm_layers, quantize, library, widths in (
            ("matmul_q8_layered", "ffn_q8_layered", 4,
             lambda w: tuple(quantize_int8(w, axis=-2).values()),
             lambda x, q, s: int8pack_library(x, q, s, dk._mm_plain),
             ((4096, 6144, 14336), (3584, 4608, 18944))),
            ("matmul_q4_layered", "ffn_q4_layered", 8,
             lambda w: tuple(quantize_int4(w, axis=-2)[k]
                             for k in ("q4", "scale")),
             lambda x, q, s: int4pack_library(
                 x, q, s, lambda x, q4, s: dk._mm_plain(
                     x, dk.unpack_int4(q4), s)),
             ((4096, 6144, 14336), (3584, 4608, 18944)))):
        mm_cases, ffn_cases = [], []
        for D, qkv_out, F_ in widths:
            k4, k5 = matmul_cases(gen, quantize, library, mm_layers, D,
                                  qkv_out, F_)
            mm_cases += k4
            ffn_cases += k5
        for name, cases in ((mm, mm_cases), (ffn, ffn_cases)):
            # the split-K core must give the same bits in two calls
            res[name] = check_kernel(
                name, getattr(dk, name), getattr(dk, name + "_plain"),
                cases, MATMUL_REL_TOL, rel=True, deterministic=True)
        del mm_cases, ffn_cases, k4, k5
        gc.collect()
        torch.cuda.empty_cache()
    res["matmul_q8"] = check_kernel(
        "matmul_q8", qm.matmul_q8, qm.matmul_q8_plain,
        head_matmul_case(gen, quantize_int8, qm.matmul_q8_plain),
        MATMUL_REL_TOL, rel=True, deterministic=True)
    gc.collect()
    torch.cuda.empty_cache()
    train_kernels = check_training_attention(gen, k2)
    gc.collect()
    torch.cuda.empty_cache()

    # -- K10's path: the pack_pairs entry (profile_torch_vit_attn.py) -------
    # at both towers' chunk shapes, every counter at 0 before
    want = dict.fromkeys(counters, 0)
    want["encoder_attention_pairs"] = 2
    for fn in counters.values():
        fn.launches = 0
    for S, D in ((577, 64), (729, 72)):
        qkv = [rand_bf16(gen, (128, S, 16, D)) for _ in range(3)]
        out = k1.encoder_attention(*qkv, pack_pairs=True)
        torch.cuda.synchronize()
        if out.shape != qkv[0].shape or not torch.isfinite(out).all():
            raise RuntimeError(f"K10 path at S {S}: bad output")
        del qkv, out
    pairs_counts = {n: fn.launches for n, fn in counters.items()}
    log(f"[K10 path] encoder_attention(..., pack_pairs=True) at "
        f"[128,577,16,64] and [128,729,16,72]: launches {pairs_counts}")
    if pairs_counts != want:
        raise RuntimeError(f"K10 path: launch counts {pairs_counts} != {want}")
    torch.cuda.empty_cache()

    # -- the five serving slices at full width ------------------------------
    B = 16
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    steps = NEW_TOKENS - 1
    stages, slice_counts = {}, {}
    for slice_name, preset, bits, int8_embed in (
            ("bf16 slice", "videollama2_mistral", None, False),
            ("int8 slice", "videollama2_mistral", 8, False),
            ("int4 slice", "videollama2_mistral", 4, False),
            ("2.1 bf16 slice", "videollama2_qwen2", None, False),
            ("2.1 int8 slice", "videollama2_qwen2", 8, True)):
        cfg = cfglib.preset(preset).replace(num_frames=16)
        frames, prompt, bucket = slice_inputs(cfg, B)
        L = cfg.llm.num_layers
        want = dict.fromkeys(counters, 0)
        want.update(encoder_attention=vit_layers(cfg)
                    * (B * cfg.num_frames // 128),
                    flash_attention=L)
        if bits is not None:
            want.update({"decode_attention": steps * L,
                         f"matmul_q{bits}_layered": 2 * steps * L,
                         f"ffn_q{bits}_layered": steps * L})
        t0 = time.perf_counter()
        params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                                  seed=0, llm_bits=bits,
                                  quantize_embed=int8_embed)
        torch.cuda.synchronize()
        log(f"[{slice_name}] {preset}: {cfg.tokens_per_video} visual tokens "
            f"a video, prompt {len(prompt) - 1 + cfg.tokens_per_video} "
            f"tokens, bucket {bucket}; weights made on the card in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB, "
            f"embed {sorted(params['llm']['embed'])})")
        eng = Engine(cfg, params, dtype=torch.bfloat16,
                     max_len=bucket + NEW_TOKENS, buckets=(bucket,),
                     decode_chunk=NEW_TOKENS,
                     kv_bits=16 if bits is None else 8, device="cuda")
        del params
        slice_counts[slice_name], stages[slice_name] = run_slice(
            slice_name, eng, cfg, frames, prompt, gcfg, counters, want)
        if bits is None:
            check_against_plain(eng, cfg, frames[:2], prompt, bucket, attn,
                                k1, k2)
        else:
            check_decode_against_plain(eng, cfg, frames[:2], prompt, bucket,
                                       k3, dk, bits)
        stages[slice_name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[{slice_name}] peak device memory "
            f"{stages[slice_name]['peak_gb']:.1f} GB")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(json.dumps({"stages": stages}))

    # -- the stage-1 training slice at full width ----------------------------
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=8)
    L = cfg.llm.num_layers
    # cuDNN's convolution backward may pick algorithms that sum with
    # atomics; the two training runs must agree bit for bit
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    t0 = time.perf_counter()
    params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                              seed=0)
    torch.cuda.synchronize()
    log(f"[training slice] weights made on the card in "
        f"{time.perf_counter() - t0:.2f} s ({sum(t.nbytes for t in _leaves(params)) / 1e9:.2f} GB, "
        f"connector {sum(t.numel() for t in _leaves(params['connector'])) / 1e6:.1f} M params); "
        f"{cfg.tokens_per_video} visual tokens a video")
    rng = np.random.default_rng(1)
    batches = [synthetic_train_batch(cfg, rng, GRAD_ACCUM * TRAIN_B, TRAIN_S,
                                     TRAIN_MIN_VALID)
               for _ in range(TRAIN_STEPS)]
    micro = GRAD_ACCUM * TRAIN_STEPS
    per_mb = {"encoder_attention": vit_layers(cfg)
              * (TRAIN_B * cfg.num_frames // 128 or 1),
              "flash_attention": 2 * L, "flash_attention_bwd_dq": L,
              "flash_attention_bwd_dkv": L}
    want = dict.fromkeys(counters, 0)
    want.update({n: c * micro for n, c in per_mb.items()})
    log(f"[training slice] launches a microbatch wanted: {per_mb} (x "
        f"{micro} microbatches a run)")
    with tempfile.TemporaryDirectory() as out_dir:
        train = run_training(cfg, params, batches, counters, want, out_dir)
    train["vs_plain"] = check_training_against_plain(cfg, params, batches[0],
                                                     k2, counters)
    log(json.dumps({"training": train}))
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()

    def by_slice(name):
        return {s: c[name] for s, c in slice_counts.items()}

    def entry(name, source, replaces, launches, **extra):
        """The kernel's line: the numbers of its first (timed) case at the
        top, every case's numbers, and its launches in each slice."""
        r = res[name]
        first = r["cases"][0]
        return {"name": name, "route": "cuda",
                "source": f"videollama2_tpu_torch/csrc/{source}",
                "replaces": f"videollama2_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": r["max_abs_err"],
                **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                "cases": r["cases"], **extra}

    def train_entry(name, key, source, replaces, **extra):
        return {"name": name, "route": "cuda",
                "source": f"videollama2_tpu_torch/csrc/{source}",
                "replaces": f"videollama2_tpu/ops/{replaces}",
                "launches": want[name], **train_kernels[key], **extra}

    def registers(kernel):
        return {n: u for n, (u, _) in ptxas.items()
                if n.startswith(kernel + " ")}

    lse = train_kernels["flash_attention +lse"]
    # launches: each kernel's count in the run of the first slice whose
    # path runs it (K10: its own path; matmul_q8 is on no path: 0, checked
    # in every slice); launches_by_slice: every serving slice's counts
    kernels = [
        entry("encoder_attention", "encoder_attention.cu",
              "encoder_attention.py:230",
              slice_counts["bf16 slice"]["encoder_attention"],
              launches_by_slice=by_slice("encoder_attention")),
        entry("encoder_attention_pairs", "encoder_attention_pairs.cu",
              "encoder_attention.py:164",
              pairs_counts["encoder_attention_pairs"],
              launches_by_slice=by_slice("encoder_attention_pairs"),
              vs_k1=pairs_vs_k1,
              note="reached through encoder_attention(..., "
              "pack_pairs=True), the entry of scripts/profile_torch_vit_"
              "attn.py; 0 launches on every model path, as in JAX"),
        entry("flash_attention", "flash_attention.cu",
              "flash_attention.py:179",
              slice_counts["bf16 slice"]["flash_attention"],
              launches_by_slice=by_slice("flash_attention"),
              note=f"bf16 serving prefill; with the LSE in the training "
              f"slice: {want['flash_attention']} launches a run, "
              f"{lse['ms']:.4f} ms (plain {lse['plain_ms']:.3f}, bound "
              f"{lse['bound_ms']:.4f}, SDPA {lse['library_ms']:.4f}) at "
              f"q[{TRAIN_B},{TRAIN_S},32,128], max_abs_err "
              f"{lse['max_abs_err']:.3e}",
              ptxas=registers("flash_attention_kernel")),
        entry("decode_attention_layered", "decode_attention.cu",
              "decode_attention.py:249",
              slice_counts["int8 slice"]["decode_attention"],
              launches_by_slice=by_slice("decode_attention")),
    ] + [entry(name, source, replaces, slice_counts[first][name],
               launches_by_slice=by_slice(name),
               entry=f"videollama2_tpu_torch/csrc/{entry_file}")
         # source: the file of the kernel; entry: that of its C entry point
         for name, source, entry_file, replaces, first in (
             ("matmul_q8_layered", "splitk_matmul.cuh", "decode_matmul.cu",
              "decode_matmul.py:89", "int8 slice"),
             ("ffn_q8_layered", "splitk_matmul.cuh", "decode_matmul.cu",
              "decode_matmul.py:346", "int8 slice"),
             ("matmul_q4_layered", "splitk_matmul.cuh", "decode_matmul_q4.cu",
              "decode_matmul.py:164", "int4 slice"),
             ("ffn_q4_layered", "splitk_matmul.cuh", "decode_matmul_q4.cu",
              "decode_matmul.py:297", "int4 slice"),
             ("matmul_q8", "splitk_matmul.cuh", "decode_matmul.cu",
              "quant_matmul.py:51", "int4 slice"))] + [
        train_entry("flash_attention_bwd_dq", "flash_attention_bwd_dq",
                    "flash_attention_bwd.cu", "flash_attention.py:352",
                    ptxas=registers("flash_bwd_dq_kernel")),
        train_entry("flash_attention_bwd_dkv", "flash_attention_bwd_dkv",
                    "flash_attention_dkv.cu", "flash_attention.py:383",
                    ptxas=registers("flash_bwd_dkv_kernel"))]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
