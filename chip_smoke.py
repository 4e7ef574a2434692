#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (videollama2_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main path gives it, then drives the
full-width VideoLLaMA2-7B-16F video-QA path (CLIP-L/336 + STC + Mistral-7B,
seeded random weights) through Engine.generate twice in each of three
slices: bf16 (bf16 weights and KV cache), int8 serving (int8 LLM and tower
packs, W8A8 prefill, int8 KV cache, decode on the layered int8 kernels) and
int4 serving, `load_4bit` (folded int4 LLM layers, int8 head and tower,
W4A8 prefill, int8 KV cache, decode on the layered int4 kernels). It checks
that each run went through its kernels, the exact launch counts, and the
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

import gc
import json
import os
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
BUCKET = 1664
MAX_LEN = 1696      # the bucket plus 32 tokens (1792 under kv8)
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


def check_kernel(name, kernel, plain, cases, tol, rel=False):
    """cases: (label, (args, kwargs), (ref_args, ref_kwargs), timed). The
    kernel on args is compared with the plain version on ref_args (fp32
    values of the same inputs); `timed(fn)` returns a zero-argument launch
    of fn on the kernel's inputs, which times both. With rel, the bound is
    tol * max|ref|."""
    worst = 0.0
    times = []
    for label, (args, kw), (rargs, rkw), timed in cases:
        got = kernel(*args, **kw).float()
        ref = plain(*rargs, **rkw).float()
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: non-finite output")
        err = (got - ref).abs().max().item()
        bound = tol * ref.abs().max().item() if rel else tol
        del got, ref
        ms = cuda_ms(timed(kernel))
        plain_ms = cuda_ms(timed(plain), iters=3)
        log(f"[{name}] {label}: max_abs_err {err:.3e} (bound {bound:.3e}), "
            f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms")
        if not err <= bound:
            raise RuntimeError(f"{name} {label}: max_abs_err {err} > {bound}")
        worst = max(worst, err)
        times.append((ms, plain_ms))
        torch.cuda.empty_cache()
    return worst, times


def attention_cases(gen):
    """K1 at tower shapes, K2 at prefill shapes (q/k/v, same for both)."""
    def qkv_case(label, qkv, kw):
        return (label, (qkv, kw), (tuple(t.float() for t in qkv), kw),
                lambda f: (lambda: f(*qkv, **kw)))
    clip = tuple(rand_bf16(gen, (64, 577, 16, 64)) for _ in range(3))
    ragged = torch.randint(300, 578, (64,), generator=gen, device="cuda",
                           dtype=torch.int32)
    siglip = tuple(rand_bf16(gen, (16, 729, 16, 72)) for _ in range(3))
    k1 = [qkv_case("[64,577,16,64]", clip, {}),
          qkv_case("[64,577,16,64] ragged valid_len", clip,
                   {"valid_len": ragged}),
          qkv_case("[16,729,16,72]", siglip, {})]
    prefill = (rand_bf16(gen, (4, BUCKET, 32, 128)),
               rand_bf16(gen, (4, BUCKET, 8, 128)),
               rand_bf16(gen, (4, BUCKET, 8, 128)))
    valid = torch.tensor([1574, 1200, 1664, 900], dtype=torch.int32,
                         device="cuda")
    k2 = [qkv_case("q[4,1664,32,128] kv[4,1664,8,128] causal", prefill,
                   {"valid_len": valid, "causal": True})]
    # bound and library yardstick of each kernel's timed (first) case
    cq, ck, cv = sdpa_args(*clip, None, False)[:3]
    pq, pk, pv, pmask = sdpa_args(*prefill, valid, True)
    extras = {
        "encoder_attention": (
            attention_bound(clip[0], clip[1], None, False, 2,
                            clip[0].nbytes),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                cq, ck, cv)),
        "flash_attention": (
            attention_bound(prefill[0], prefill[1], valid, True, 2,
                            prefill[0].nbytes),
            lambda: torch.nn.functional.scaled_dot_product_attention(
                pq, pk, pv, attn_mask=pmask))}
    return k1, k2, extras


def decode_attention_cases(gen, quantize_rows):
    """K3 at the slice's decode shape: B 16, 32 query on 8 kv heads, hd
    128, M 1792, prompt bucket 1664, the 32nd token (write_pos 1695), four
    cache layers rotated in timing."""
    L, B, M, K, hd = 4, 16, 1792, 8, 128
    write_pos = BUCKET + NEW_TOKENS - 1
    valid = torch.randint(1200, BUCKET + 1, (B,), generator=gen,
                          device="cuda", dtype=torch.int32)
    q = rand_bf16(gen, (B, 32, hd), 4.0)
    k_new, v_new = rand_bf16(gen, (B, K, hd)), rand_bf16(gen, (B, K, hd))
    rows = [torch.randn((L, B, M, K, hd), generator=gen, device="cuda")
            for _ in range(2)]
    (kq, ks), (vq, vs) = quantize_rows(rows[0]), quantize_rows(rows[1])
    int8 = dict(k_scale=ks.transpose(2, 3).contiguous(),
                v_scale=vs.transpose(2, 3).contiguous())
    caches = {"int8": (kq.reshape(L, B, M, -1), vq.reshape(L, B, M, -1)),
              "bf16": tuple(r.reshape(L, B, M, -1).bfloat16() for r in rows)}
    del rows
    # bound of the timed (int8) case: the cache rows K3 reads (prompt rows
    # below valid_len, the generated rows) with their scales, q, the new
    # k/v rows and the output; the yardstick is SDPA over the same rows of
    # the bf16 cache, the new row read from the cache
    rows_read = (valid.long() + write_pos - BUCKET).sum().item()
    k3_bound = bound(4 * 32 * hd * rows_read,
                     rows_read * 2 * K * (hd + 4) + 2 * q.nbytes
                     + k_new.nbytes + v_new.nbytes)
    bk, bv = (t[1].reshape(B, M, K, hd) for t in caches["bf16"])
    sq, sk, sv, _ = sdpa_args(q[:, None], bk, bv, None, False)
    j = torch.arange(M, device="cuda")
    smask = ((j[None] < valid[:, None])
             | ((j[None] >= BUCKET) & (j[None] <= write_pos)))[:, None, None]
    k3_extra = (k3_bound, lambda: torch.nn.functional
                .scaled_dot_product_attention(sq, sk, sv, attn_mask=smask))
    cases = []
    for label, cache, kw in (
            ("int8 cache", "int8", int8),
            ("bf16 cache", "bf16", {}),
            ("int8 cache, window 1024", "int8", dict(int8, window=1024))):
        ck, cv = caches[cache]
        args = (q, k_new, v_new, ck, cv, 1, valid, write_pos, BUCKET)
        ref_args = (q.float(),) + args[1:]
        cyc = layer_cycle(L)
        cases.append((
            f"q[16,32,128] {cache}[{L},16,1792,1024] ragged valid_len, "
            f"write_pos {write_pos}{', window 1024' if 'window' in kw else ''}",
            (args, kw), (ref_args, kw),
            lambda f, ck=ck, cv=cv, kw=kw, cyc=cyc: (
                lambda: f(q, k_new, v_new, ck, cv, cyc(), valid, write_pos,
                          BUCKET, **kw))))
    return cases, k3_extra


def matmul_cases(gen, quantize, mm_layers):
    """K4 (K6 with int4 packs) at the fused qkv [4096 -> 6144] and o
    [4096 -> 4096], K5 (K7) at [4096, 14336], R = 16 rows, bf16 scales as
    the Engine casts them; `mm_layers` (K4/K6: enough that the rotated
    layers overflow the 50 MB L2) or two (K5/K7) layers rotated in timing.
    `quantize(w)` -> (weight bytes, scale) of an [..., in, out] kernel."""
    def pack(L, din, dout):
        q, s = quantize(rand_bf16(gen, (L, din, dout), 0.02))
        return q, s.bfloat16()
    x = rand_bf16(gen, (16, 4096))
    k4, extras = [], []
    for label, dout in ((f"qkv x[16,4096] [{mm_layers},4096,6144]", 6144),
                        (f"o x[16,4096] [{mm_layers},4096,4096]", 4096)):
        q, s = pack(mm_layers, 4096, dout)
        extras.append(bound(2 * 16 * 4096 * dout, q[0].nbytes + s[0].nbytes
                            + x.nbytes + 16 * dout * 2))
        cyc = layer_cycle(mm_layers)
        k4.append((label, ((x, q, s, 1), {}), ((x.float(), q, s, 1), {}),
                   lambda f, q=q, s=s, cyc=cyc: (
                       lambda: f(x, q, s, cyc()))))
    g, u, d = pack(2, 4096, 14336), pack(2, 4096, 14336), \
        pack(2, 14336, 4096)
    cyc = layer_cycle(2)
    k5 = [("x[16,4096] gate/up[2,4096,14336] down[2,14336,4096]",
           ((x, *g, *u, *d, 1), {}), ((x.float(), *g, *u, *d, 1), {}),
           lambda f: (lambda: f(x, *g, *u, *d, cyc())))]
    # bounds of the timed cases: each weight byte read once (h, the FFN's
    # intermediate, stays inside the kernel's work)
    ffn_bound = bound(2 * 16 * 3 * 4096 * 14336,
                      sum(t[0].nbytes for t in (*g, *u, *d))
                      + 2 * x.nbytes)
    return k4, k5, extras[0], ffn_bound


def head_matmul_case(gen, quantize_int8):
    """matmul_q8 at the int8 head's shape, x[16,4096] q[4096,32000], fp32
    scales (the JAX pack's)."""
    x = rand_bf16(gen, (16, 4096))
    p = quantize_int8(rand_bf16(gen, (4096, 32000), 0.02), axis=-2)
    q, s = p["q"], p["scale"][0]
    return [("x[16,4096] q[4096,32000]", ((x, q, s), {}),
             ((x.float(), q, s), {}), lambda f: (lambda: f(x, q, s)))], \
        bound(2 * 16 * 4096 * 32000,
              q.nbytes + s.nbytes + x.nbytes + 16 * 32000 * 2)


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


def _plan_args(cfg, frames, prompt, dev):
    from videollama2_tpu_torch.multimodal import splice as splice_lib
    plan = splice_lib.plan_batch([prompt] * frames.shape[0],
                                 cfg.tokens_per_video, BUCKET)
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


def check_against_plain(eng, cfg, frames, prompt, attn, k1, k2) -> None:
    """First-token logits of two videos through the kernels and through
    the plain attention path (attend swapped for attend_plain), both at
    full width in bf16. The two differ only by rounding inside attention
    (the order of the fp32 sums, exp), which 23 + 32 bf16 layers amplify.
    """
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2

    args = _plan_args(cfg, frames, prompt, eng.device)

    def first_logits():
        cache = llm_lib.init_cache(cfg.llm, frames.shape[0], BUCKET,
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


def check_decode_against_plain(eng, cfg, frames, prompt, k3, dk, bits) -> None:
    """Decode logits of two videos over the int8 (bits 8) or int4 (bits 4)
    packs and the int8 cache: a W8A8/W4A8 prefill fills the cache, then
    DECODE_CHECK_STEPS teacher-forced decode steps run once on K3 and
    K4/K5 (or K6/K7) and once, from a copy of the same cache, with their
    plain versions swapped in. Both run in bf16."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2

    args = _plan_args(cfg, frames, prompt, eng.device)
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
                    eng.params["llm"], cfg.llm, te, c, valid, BUCKET, s,
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


def ptxas_report(path) -> None:
    """Registers and spills of the flash-attention kernels, from the
    ptxas report the build wrote beside the library."""
    if not path.exists():
        log(f"[ptxas] no report at {path}")
        return
    name = None
    for line in path.read_text().splitlines():
        if "Compiling entry function" in line:
            name = next((n for n in ("flash_bwd_dq_kernel",
                                     "flash_bwd_dkv_kernel",
                                     "flash_attention_kernel") if n in line),
                        None)
            if name:
                tmpl = line.split(name, 1)[1]
                name += (" D" + tmpl.split("ILi", 1)[1].split("E", 1)[0]
                         + (" causal" if "Lb1" in tmpl else ""))
            spill = ""
        elif name and "spill" in line:
            spill = line.strip()
        elif name and "Used" in line:
            log(f"[ptxas] {name}: {line.split(':', 1)[1].strip()}; {spill}")
            name = None


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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    from videollama2_tpu_torch.constants import VIDEO_TOKEN_INDEX
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
    ptxas_report(_build.library_path().parent / _build.BUILD_LOG)

    # -- every kernel against its plain version at main-path shapes ---------
    gen = torch.Generator(device="cuda").manual_seed(0)
    k1_cases, k2_cases, yard = attention_cases(gen)
    k1_err, k1_times = check_kernel(
        "encoder_attention", k1.encoder_attention, k1.encoder_attention_plain,
        k1_cases, K1_TOL)
    k2_err, k2_times = check_kernel(
        "flash_attention", k2.flash_attention, k2.flash_attention_plain,
        k2_cases, K2_TOL)
    del k1_cases, k2_cases
    k3_cases, yard["decode_attention_layered"] = decode_attention_cases(
        gen, _quantize_kv_rows)
    k3_err, k3_times = check_kernel(
        "decode_attention", k3.decode_attention_layered,
        k3.decode_attention_plain, k3_cases, K3_TOL)
    del k3_cases
    for name in ("encoder_attention", "flash_attention",
                 "decode_attention_layered"):
        bnd, lib_fn = yard[name]
        yard[name] = (bnd, cuda_ms(lib_fn))
        log(f"[{name}] bound {bnd[0]:.4f} ms ({bnd[1]}), torch SDPA "
            f"yardstick {yard[name][1]:.4f} ms")
    errs, times = {}, {}
    for mm, ffn, mm_layers, quantize in (
            ("matmul_q8_layered", "ffn_q8_layered", 4,
             lambda w: tuple(quantize_int8(w, axis=-2).values())),
            ("matmul_q4_layered", "ffn_q4_layered", 8,
             lambda w: tuple(quantize_int4(w, axis=-2)[k]
                             for k in ("q4", "scale")))):
        mm_cases, ffn_cases, yard[mm], yard[ffn] = matmul_cases(
            gen, quantize, mm_layers)
        yard[mm], yard[ffn] = (yard[mm], None), (yard[ffn], None)
        for name, cases in ((mm, mm_cases), (ffn, ffn_cases)):
            errs[name], times[name] = check_kernel(
                name, getattr(dk, name), getattr(dk, name + "_plain"),
                cases, MATMUL_REL_TOL, rel=True)
        del mm_cases, ffn_cases
    head_cases, head_bound = head_matmul_case(gen, quantize_int8)
    yard["matmul_q8"] = (head_bound, None)
    errs["matmul_q8"], times["matmul_q8"] = check_kernel(
        "matmul_q8", qm.matmul_q8, qm.matmul_q8_plain, head_cases,
        MATMUL_REL_TOL, rel=True)
    del head_cases
    gc.collect()
    torch.cuda.empty_cache()
    train_kernels = check_training_attention(gen, k2)
    gc.collect()
    torch.cuda.empty_cache()

    # -- the three slices at full width -------------------------------------
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=16)
    B, T, H = 16, cfg.num_frames, cfg.vision.image_size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, T, H + H // 2, H), dtype=np.uint8)
    prompt = ([1] + [int(x) for x in rng.integers(10, 1000, 40)]
              + [VIDEO_TOKEN_INDEX]
              + [int(x) for x in rng.integers(10, 1000, 12)])
    n_layers_vit = cfg.vision.select_layer % (cfg.vision.num_layers + 1)
    L = cfg.llm.num_layers
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    steps = NEW_TOKENS - 1
    # every kernel's counter, checked in every slice: a kernel off the
    # slice's path must launch no time
    counters = {"encoder_attention": k1.encoder_attention,
                "flash_attention": k2.flash_attention,
                "decode_attention": k3.decode_attention_layered,
                "matmul_q8_layered": dk.matmul_q8_layered,
                "ffn_q8_layered": dk.ffn_q8_layered,
                "matmul_q4_layered": dk.matmul_q4_layered,
                "ffn_q4_layered": dk.ffn_q4_layered,
                "matmul_q8": qm.matmul_q8,
                "flash_attention_bwd_dq": k2.flash_attention_bwd_dq,
                "flash_attention_bwd_dkv": k2.flash_attention_bwd_dkv}
    stages, slice_counts = {}, {}

    for slice_name, bits in (("bf16 slice", None), ("int8 slice", 8),
                             ("int4 slice", 4)):
        want = dict.fromkeys(counters, 0)
        want.update(encoder_attention=n_layers_vit * (B * T // 128),
                    flash_attention=L)
        if bits is not None:
            want.update({"decode_attention": steps * L,
                         f"matmul_q{bits}_layered": 2 * steps * L,
                         f"ffn_q{bits}_layered": steps * L})
        t0 = time.perf_counter()
        params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                                  seed=0, llm_bits=bits)
        torch.cuda.synchronize()
        log(f"[{slice_name}] weights made on the card in "
            f"{time.perf_counter() - t0:.1f} s "
            f"({sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9:.2f} GB)")
        eng = Engine(cfg, params, dtype=torch.bfloat16, max_len=MAX_LEN,
                     buckets=(BUCKET,), decode_chunk=NEW_TOKENS,
                     kv_bits=16 if bits is None else 8, device="cuda")
        del params
        slice_counts[bits], stages[slice_name] = run_slice(
            slice_name, eng, cfg, frames, prompt, gcfg, counters, want)
        if bits is None:
            check_against_plain(eng, cfg, frames[:2], prompt, attn, k1, k2)
        else:
            check_decode_against_plain(eng, cfg, frames[:2], prompt, k3, dk,
                                       bits)
        log(f"[{slice_name}] peak device memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(json.dumps({"stages": stages}))

    # -- the stage-1 training slice at full width ----------------------------
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=8)
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
    per_mb = {"encoder_attention": n_layers_vit * (TRAIN_B * cfg.num_frames
                                                   // 128 or 1),
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

    def entry(name, source, replaces, launches, err, times, **extra):
        (bound_ms, bound_by), library_ms = yard[name]
        return {"name": name, "route": "cuda",
                "source": f"videollama2_tpu_torch/csrc/{source}",
                "replaces": f"videollama2_tpu/ops/{replaces}",
                "launches": launches, "max_abs_err": err,
                "ms": times[0][0], "plain_ms": times[0][1],
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library_ms, **extra}

    def train_entry(name, key, replaces):
        return {"name": name, "route": "cuda",
                "source": "videollama2_tpu_torch/csrc/flash_attention_bwd.cu",
                "replaces": f"videollama2_tpu/ops/{replaces}",
                "launches": want[name], **train_kernels[key]}

    lse = train_kernels["flash_attention +lse"]
    # launches: each kernel's count in the run of the slice whose path runs
    # it (matmul_q8 is on no path: 0, checked in every slice)
    kernels = [
        entry("encoder_attention", "encoder_attention.cu",
              "encoder_attention.py:230",
              slice_counts[None]["encoder_attention"], k1_err, k1_times),
        entry("flash_attention", "flash_attention.cu",
              "flash_attention.py:179", slice_counts[None]["flash_attention"],
              k2_err, k2_times,
              note=f"bf16 serving prefill; with the LSE in the training "
              f"slice: {want['flash_attention']} launches a run, "
              f"{lse['ms']:.4f} ms (plain {lse['plain_ms']:.3f}, bound "
              f"{lse['bound_ms']:.4f}, SDPA {lse['library_ms']:.4f}) at "
              f"q[{TRAIN_B},{TRAIN_S},32,128], max_abs_err "
              f"{lse['max_abs_err']:.3e}"),
        entry("decode_attention_layered", "decode_attention.cu",
              "decode_attention.py:249", slice_counts[8]["decode_attention"],
              k3_err, k3_times),
    ] + [entry(name, source, replaces, slice_counts[bits][name],
               errs[name], times[name])
         for name, source, replaces, bits in (
             ("matmul_q8_layered", "decode_matmul.cu",
              "decode_matmul.py:89", 8),
             ("ffn_q8_layered", "decode_matmul.cu", "decode_matmul.py:346",
              8),
             ("matmul_q4_layered", "decode_matmul_q4.cu",
              "decode_matmul.py:164", 4),
             ("ffn_q4_layered", "decode_matmul_q4.cu",
              "decode_matmul.py:297", 4),
             ("matmul_q8", "decode_matmul.cu", "quant_matmul.py:51", 4))] + [
        train_entry("flash_attention_bwd_dq", "flash_attention_bwd_dq",
                    "flash_attention.py:352"),
        train_entry("flash_attention_bwd_dkv", "flash_attention_bwd_dkv",
                    "flash_attention.py:383")]
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
