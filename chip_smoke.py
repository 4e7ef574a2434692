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
versions. On the int8 and 2.1 bf16 slices' weights the "speculative +
sessions" phase runs greedy prompt-lookup speculation (k = 4; B = 1 and
B = 16) against plain greedy and a session's two continued turns
against fresh generates, each call with exact launch counts and every
token difference held to a near-tie. On the int8 slice's Engine the
"serve" phase runs the media layer and the serving plane: the
processors on a 16-frame 480x640 directory (PNG and BMP frames, written
here) and a 480x640 PNG; a controller and a model worker on localhost
streaming a video and an image request (exact launch counts, the tokens
of a direct Engine.generate); 16 concurrent video requests over 4
videos plus 2 text ones on a dynamic-batching worker against the plain
worker (requests/s; answers held to B = 1 up to near-ties; each
distinct video of a batch encoded once); two chat completions of the
OpenAI-compatible server; and the container paths (the decoder built
from media/csrc where libavcodec is, else a named error and an
error_code 1 answer). The "api" phase loads a checkpoint
in the released 7B-16F layout (LLM cut to 8 layers) through model_init
and answers through mm_infer, mm_infer_batch, a 3-turn ChatSession and
mm_infer_session. The "av" phase runs VideoLLaMA2.1-AV (the 2.1 slice's
model with the BEATs audio tower and its projector) on the 2.1 int8
slice's weights plus a seeded bf16 audio branch: 16 audio-visual prompts
(16 frames and 10.24 s of audio each, fbank made on the host) twice, 16
audio-only ones twice, the BEATs encode timed, and first-token and decode
logits held against the plain versions; its api calls load a checkpoint
in the released VideoLLaMA2.1-AV layout (LLM cut to 8 layers) and answer
through mm_infer (audio on a .wav, and av) and mm_infer_session. Last,
the stage-1 training slice (VideoLLaMA2-7B-8F pretrain:
only the connector trains) runs two optimizer steps of 16 videos
(grad_accum 2 x 8) at seq 2048 through Trainer.train, twice, with the
flash-attention LSE forward (K2) and backward kernels (K8, K9), and one
microbatch's loss and connector gradient are held against the plain
attention. Last, the "lora" phase runs the reference's LoRA and QLoRA
finetune recipes (adapters r 128 on every LLM projection, 16 videos a
step as 4 x 4, over the bf16 base and over folded int4 layers) twice
each with the same checks (every adapter b and the connector moved,
every frozen tensor bit-unchanged, adapter gradients against the plain
attention), reads the QLoRA adapters' split save back bit for bit, serves
the unmerged QLoRA tree (the packed decode kernels at 0), and loads a
LoRA directory over the api phase's checkpoint through model_init, its
int8 packs held bit-equal to an independent quantize(base + a @ b * s).

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Prints the card's name and power limit, each phase's numbers, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed phase raises and the exit code
is non-zero; without a CUDA device it exits non-zero before printing
anything on stdout.
"""

import base64
import dataclasses
import functools
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
import types
import zlib

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
# the test writers of AVI, PNG and BMP files (another "tests" package may
# be installed, so they are imported by their own names)
sys.path.insert(1, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))

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
# the api phase: a checkpoint in the released VideoLLaMA2-7B-16F key layout
# (every key at its released shape, bf16) with the LLM cut to its first
# API_LLM_LAYERS layers of 32, loaded through model_init
MANIFEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                        "fixtures", "manifests", "videollama2_7b_16f.json")
API_LLM_LAYERS = 8
API_BATCH = 16
# the "av" phase: VideoLLaMA2.1-AV on the 2.1 int8 slice's tree plus a
# seeded bf16 audio branch; each row's 10.24 s of 16 kHz audio makes 1022
# fbank frames, padded to audio.max_frames (1024: 512 BEATs tokens). Its
# api calls load a checkpoint in the released VideoLLaMA2.1-AV layout with
# the LLM cut to API_LLM_LAYERS of 28 layers.
AV_SECONDS = 10.24
MANIFEST_AV = os.path.join(os.path.dirname(MANIFEST),
                           "videollama2_1_7b_av.json")
# the "speculative + sessions" phase: prompt-lookup speculation at k = 4
# (B = 1 over SPEC_NEW_TOKENS tokens; B = 16, 64 verify rows, over
# NEW_TOKENS), a session of two continued turns that feed
# SESSION_TURN_TOKENS text tokens each and decode SESSION_NEW_TOKENS, and
# the api model's chat entries at CHAT_NEW_TOKENS a reply (three turns fit
# its cache of 128 rows after the bucket)
SPEC_K = 4
SPEC_NEW_TOKENS = 64
SPEC_ROOM = 512        # cache rows after the bucket; 256 of them a bucket
SESSION_TURN_TOKENS = 30
SESSION_NEW_TOKENS = 16
CHAT_NEW_TOKENS = 8
# the serving slices the phase runs on: the int8 one (W8A8 verify, the int8
# cache) and the 2.1 bf16 one (a bf16 cache, 7 query heads a kv head, the
# qkv bias)
SPEC_SLICES = {"int8 slice": dict(batched=True, session=True),
               "2.1 bf16 slice": dict(batched=False, session=False)}
# the "lora" phase: the reference's LoRA and QLoRA finetune recipes
# (scripts/custom/finetune_lora.sh, finetune_qlora.sh: adapters r 128,
# alpha 256 on q, k, v, o, gate, up and down, 8 frames, per-device batch
# 4, grad-accum 4, learning rate and mm_projector_lr 2e-5, cosine after a
# 3% warmup; QLoRA over a 4-bit base) at full width, LORA_STEPS steps;
# then the QLoRA tree served unmerged (LORA_NEW_TOKENS greedy tokens) and
# a LoRA directory over the api phase's checkpoint through model_init
LORA_R, LORA_ALPHA = 128, 256
LORA_MB, LORA_ACCUM, LORA_STEPS = 4, 4, 2
LORA_LR = 2e-5
LORA_NEW_TOKENS = 8
# the "serve" phase on the int8 slice's Engine: SERVE_VIDEO_REQUESTS
# concurrent video requests over SERVE_VIDEOS distinct 16-frame 480x640
# videos plus SERVE_TEXT_REQUESTS text requests, on a worker with dynamic
# batching and on the plain one
SERVE_VIDEOS = 4
SERVE_VIDEO_REQUESTS = 16
SERVE_TEXT_REQUESTS = 2


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


def run_slice(name, eng, cfg, frames, prompt, gcfg, counters, want,
              audio=None):
    """Two generate runs of 16 videos (or, with `audio`, fbank features:
    16 audio-visual prompts, or audio-only ones where frames is None);
    checks the launch counts of every kernel on the path (counters: name
    -> wrapper) against `want`, the token shapes, and that both runs gave
    the same tokens. Returns the counts and the stage split of the second
    run."""
    media = [m for m in (frames, audio) if m is not None]
    B = media[0].shape[0]
    runs, stage = [], {}
    for run in range(2):
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev_frames, dev_audio = (None if m is None else eng.upload_frames(m)
                                 for m in (frames, audio))
        torch.cuda.synchronize()
        t_upload = time.perf_counter() - t0
        stamps = {}
        t0 = time.perf_counter()
        out = eng.generate([prompt] * B, frames=dev_frames, audio=dev_audio,
                           gen=gcfg, eos_token_id=-1,
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
            f"({sum(m.nbytes for m in media) / 1e6:.0f} MB), "
            f"encode+prefill+first token "
            f"{stage['encode_prefill_first_token_s']:.3f} s, decode "
            f"{stage['decode_ms_per_token']:.2f} ms/token, generate "
            f"{stage['generate_s']:.3f} s")
    if not np.array_equal(runs[0], runs[1]):
        raise RuntimeError(f"{name}: the two runs gave different tokens")
    log(f"[{name}] {B}x{NEW_TOKENS} tokens, identical in both runs; "
        f"first row: {runs[1][0][:8].tolist()}...")
    return counts, stage


def _plan_args(cfg, frames, prompt, dev, bucket, B=None, tpm=None):
    """The prefill's inputs for B copies of prompt (B: frames' rows by
    default): frames on the device (None stays None) and the splice plan
    (tpm: the tokens a modal tag stands for, cfg.tokens_per_video by
    default)."""
    from videollama2_tpu_torch.multimodal import splice as splice_lib
    plan = splice_lib.plan_batch([prompt] * (B or frames.shape[0]),
                                 tpm or cfg.tokens_per_video, bucket)
    return (None if frames is None else torch.from_numpy(frames).to(dev),
            torch.from_numpy(plan.text_ids).to(dev).long(),
            torch.from_numpy(plan.is_visual).to(dev),
            torch.from_numpy(plan.vis_index).to(dev),
            torch.from_numpy(plan.positions).to(dev),
            torch.from_numpy(plan.valid_len).to(dev))


def _prefill(eng, cfg, args, cache, fbank=None, w8a8=False):
    """Prefill of _plan_args' args into cache: prefill_multimodal, or with
    fbank features the audio / audio-visual prefill. -> (last, cache)."""
    from videollama2_tpu_torch.models import videollama2 as vl2
    if fbank is None:
        return vl2.prefill_multimodal(eng.params, cfg, *args, cache,
                                      w8a8=w8a8)
    return vl2.prefill_audio_visual(
        eng.params, cfg, args[0],
        torch.from_numpy(fbank).to(eng.device, eng.dtype), *args[1:], cache,
        w8a8=w8a8)


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
    # a row whose argmax differs is a near-tie when the plain path's top-2
    # margin is below that row's largest logit difference (logged only)
    rows_f = fast.reshape(-1, fast.shape[-1])
    rows_p = plain.reshape(-1, plain.shape[-1])
    top2 = rows_p.topk(2, dim=-1).values
    for r in torch.nonzero(rows_f.argmax(-1) != rows_p.argmax(-1))[:, 0]:
        r = int(r)
        margin = (top2[r, 0] - top2[r, 1]).item()
        row_diff = (rows_f[r] - rows_p[r]).abs().max().item()
        log(f"[{name}] argmax differs on row {r}: plain top-2 margin "
            f"{margin:.4f}, row max abs diff {row_diff:.4f}, near-tie "
            f"{margin < row_diff}")
    if not (diff.max().item() <= 0.4 * std
            and diff.mean().item() <= 0.05 * std):
        raise RuntimeError(f"{name}: kernel path logits differ from the "
                           "plain path beyond the bounds")


def check_against_plain(eng, cfg, frames, prompt, bucket, attn, k1,
                        k2, fbank=None, tpm=None, label="bf16") -> None:
    """First-token logits of two videos (with fbank, two audio-visual or,
    frames None, audio-only prompts) through the kernels and through the
    plain attention path (attend swapped for attend_plain), both at full
    width in bf16. The two differ only by rounding inside attention (the
    order of the fp32 sums, exp), which the tower's and the LLM's bf16
    layers amplify. Int8 packs take their dequantize branch here: under
    W8A8 that rounding also flips activations' int8 steps from layer to
    layer, which these bounds are not set for (the AV model's W8A8
    first-token logits differ by 0.80 at most and 0.135 on average,
    against bounds of 0.48 and 0.06, on an H100 80GB HBM3 at 700 W)."""
    from videollama2_tpu_torch.models import llm as llm_lib

    B = len(frames if frames is not None else fbank)
    args = _plan_args(cfg, frames, prompt, eng.device, bucket, B, tpm)

    def first_logits():
        cache = llm_lib.init_cache(cfg.llm, B, bucket, torch.bfloat16,
                                   device=eng.device)
        with torch.inference_mode():
            last, _ = _prefill(eng, cfg, args, cache, fbank)
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
    compare_logits(f"{label} first-token logits", fast, plain)


def check_decode_against_plain(eng, cfg, frames, prompt, bucket, k3, dk,
                               bits, fbank=None, tpm=None,
                               label=None) -> None:
    """Decode logits of two videos (with fbank, two audio-visual or,
    frames None, audio-only prompts) over the int8 (bits 8) or int4 (bits
    4) packs and the int8 cache: a W8A8/W4A8 prefill fills the cache, then
    DECODE_CHECK_STEPS teacher-forced decode steps run once on K3 and
    K4/K5 (or K6/K7) and once, from a copy of the same cache, with their
    plain versions swapped in. Both run in bf16."""
    from videollama2_tpu_torch.models import llm as llm_lib

    B = len(frames if frames is not None else fbank)
    args = _plan_args(cfg, frames, prompt, eng.device, bucket, B, tpm)
    valid = args[-1]
    L = cfg.llm.num_layers
    cache = llm_lib.init_cache(cfg.llm, B, eng.max_len, kv_bits=8,
                               device=eng.device)
    with torch.inference_mode():
        _prefill(eng, cfg, args, cache, fbank, w8a8=True)
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
    compare_logits(f"{label or f'int{bits}'} decode logits, "
                   f"{DECODE_CHECK_STEPS} teacher-forced steps", fast, plain)


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


def run_training(label, cfg, params, batches, counters, want, out_dir,
                 opt_cfg, grad_accum, each_changes=()) -> dict:
    """Two runs of len(batches) optimizer steps through Trainer.train
    (opt_cfg, grad_accum microbatches a step) from the same params;
    checks launch counts, losses (finite, equal in both runs), that the
    connector and every tensor of `each_changes` (paths) changed and that
    no frozen tensor did (every leaf the trainable mask leaves out)."""
    from videollama2_tpu_torch.train.optimizer import (flatten,
                                                       trainable_mask)
    from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig
    flat = flatten(params)
    mask = trainable_mask(params, opt_cfg)
    trained = {p: t for p, t in flat.items() if mask[p]}
    start = {p: t.detach().clone() for p, t in trained.items()}
    frozen = [t for p, t in flat.items() if not mask[p]]
    frozen0 = _checksums(frozen)
    valid_tokens = [int(b.valid_len.sum()) for b in batches]
    runs = []
    for run in range(2):
        with torch.no_grad():
            for p, t in trained.items():
                t.copy_(start[p])
        trainer = Trainer(
            cfg, params, opt_cfg,
            TrainerConfig(output_dir=out_dir,
                          gradient_accumulation_steps=grad_accum,
                          max_steps=len(batches), log_steps=1,
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
            st["valid_tokens_per_s"] = valid_tokens[i] / st["s"]
            log(f"[{label}] run {run + 1} step {i + 1}: "
                f"{st['s']:.3f} s, {st['valid_tokens_per_s']:.0f} valid "
                f"tokens/s ({valid_tokens[i]} tokens, {st['num_tokens']} "
                f"supervised), loss {st['loss']:.6f}, accuracy "
                f"{st['accuracy']:.4f}, peak {st['peak_gb']:.1f} GB")
        log(f"[{label}] run {run + 1}: Trainer.train {t_train:.1f} s "
            f"with its save; launches {counts} (want {want})")
        if counts != want:
            raise RuntimeError(f"{label}: launch counts {counts} != {want}")
        if not all(np.isfinite(st["loss"]) for st in steps):
            raise RuntimeError(f"{label}: non-finite loss")
        if run == 0:
            if all(torch.equal(t, start[p]) for p, t in trained.items()
                   if p[0] == "connector"):
                raise RuntimeError(f"{label}: the connector did not change")
            same = [p for p in each_changes
                    if torch.equal(trained[p], start[p])]
            if same:
                raise RuntimeError(f"{label}: unchanged: {same}")
        runs.append([st["loss"] for st in steps])
        stats = steps
    if runs[0] != runs[1]:
        raise RuntimeError(f"{label}: the two runs' losses differ: {runs}")
    if _checksums(frozen) != frozen0:
        raise RuntimeError(f"{label}: a frozen tensor changed")
    b_note = (f" and all {len(each_changes)} tensors of b" if each_changes
              else "")
    log(f"[{label}] losses identical in both runs {runs[1]}; the "
        f"connector{b_note} changed; all {len(frozen)} frozen tensors "
        "unchanged (bit checksums)")
    return {"steps": stats, "valid_tokens": valid_tokens,
            "trainer_train_s": t_train}


def check_training_against_plain(label, cfg, params, batch, k2, counters,
                                 tensors) -> dict:
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
    TRAIN_LOSS_REL_TOL. The gradient is that of `tensors` (the connector's,
    or the LoRA adapters'), concatenated."""
    from videollama2_tpu_torch.train.data import Batch
    from videollama2_tpu_torch.train.optimizer import flatten
    from videollama2_tpu_torch.train.step import loss_fn
    mb = Batch(*(a[:2] for a in batch))
    leaves = list(flatten(params).values())
    for t in tensors:
        t.requires_grad_(True)

    def loss_and_grad():
        loss, _ = loss_fn(params, cfg, mb)
        loss.backward()
        g = torch.cat([t.grad.float().flatten() for t in tensors])
        for t in leaves:
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
    log(f"[{label} vs plain attention] {json.dumps(res)} (bounds: loss "
        f"{TRAIN_LOSS_REL_TOL}, rel L2 2 x floor = "
        f"{2 * res['floor_grad_rel_l2']:.4f}, cosine >= {TRAIN_GRAD_COS})")
    if not (res["loss_rel_diff"] <= TRAIN_LOSS_REL_TOL
            and res["grad_rel_l2"] <= 2 * res["floor_grad_rel_l2"]
            and res["grad_cosine"] >= TRAIN_GRAD_COS):
        raise RuntimeError(f"{label}: kernel and plain-attention loss or "
                           "gradient differ beyond the bounds")
    return res


class ToyTokenizer:
    """A word-level tokenizer with what the port's mm_infer calls: text is
    split on whitespace, id i decodes to "w<i>" and "w<i>" encodes back to
    i (so a reply retokenizes to its own ids, as a chat session's prefix
    match needs), any other word is hashed to an id in [3, vocab_size);
    the chat template is Mistral's, and eos_token_id is -1 (bench.py's),
    so every request decodes all its tokens."""
    eos_token_id = -1
    pad_token = unk_token = "<unk>"

    def __init__(self, vocab_size: int):
        self.vocab_size = vocab_size

    def _id(self, word: str) -> int:
        m = re.fullmatch(r"w(\d+)", word)
        if m and 3 <= int(m.group(1)) < self.vocab_size:
            return int(m.group(1))
        return 3 + zlib.crc32(word.encode()) % (self.vocab_size - 3)

    def __call__(self, text, add_special_tokens=False):
        ids = [self._id(w) for w in text.split()]
        return types.SimpleNamespace(
            input_ids=([1] if add_special_tokens else []) + ids)

    def apply_chat_template(self, messages, tokenize=False,
                            add_generation_prompt=True):
        out = "<s>"
        for m in messages:
            if m["role"] == "system":
                out += m["content"]
            elif m["role"] == "user":
                out += f"[INST] {m['content']} [/INST]"
            else:
                out += f" {m['content']} </s>"
        return out

    def decode(self, ids, skip_special_tokens=True):
        return " ".join(f"w{i}" for i in ids
                        if not (skip_special_tokens and i < 3))


def write_safetensors(path, shapes, make) -> None:
    """A bf16 safetensors file of `shapes` ({name: shape}), each tensor
    made by make(name, shape) and written as it is made: an 8-byte
    little-endian header length, the JSON header padded to 8 bytes, then
    the raw little-endian bytes in the header's order."""
    header, offset = {}, 0
    for name, shape in shapes.items():
        n = 2 * math.prod(shape)
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for name, shape in shapes.items():
            t = make(name, shape).reshape(-1).view(torch.uint8)
            f.write(t.cpu().numpy())


def api_init(name, shape, gen) -> torch.Tensor:
    """A released key's seeded bf16 value on the card, with
    utils/synthetic.py's scales: biases 0, norm scales (the 1-D weights)
    and BEATs's gate constants 1, the connector's convolutions He-normal
    and its readout 1/sqrt(fan_in), every other weight normal(0, 0.02)."""
    if name.endswith(".bias"):
        return torch.zeros(shape, dtype=torch.bfloat16, device="cuda")
    if (len(shape) == 1 and name.endswith(".weight")) \
            or name.endswith(".gru_rel_pos_const"):
        return torch.ones(shape, dtype=torch.bfloat16, device="cuda")
    std = 0.02
    if name.startswith("model.mm_projector."):
        fan_in = math.prod(shape[1:])  # torch layout [out, in, *k]
        std = math.sqrt((1.0 if ".readout." in name else 2.0) / fan_in)
    return torch.randn(shape, generator=gen, dtype=torch.bfloat16,
                       device="cuda").mul_(std)


def api_config():
    """The api phase's model: VideoLLaMA2-7B-16F with the LLM cut to
    API_LLM_LAYERS layers."""
    from videollama2_tpu_torch.core import config as cfglib
    base = cfglib.preset("videollama2_mistral").replace(num_frames=16)
    return base.replace(llm=dataclasses.replace(base.llm,
                                               num_layers=API_LLM_LAYERS))


def run_api_phase(ckpt, counters, attn, k1, k2, k3, dk):
    """The public API on a released-layout checkpoint: writes it (LLM depth
    API_LLM_LAYERS, everything else as released) into the directory
    `ckpt` (the "lora" phase's model_base later), loads it with
    model_init(load_8bit=True, kv_bits=8), answers one 16-frame I420 clip
    through mm_infer and API_BATCH questions about one shared clip through
    mm_infer_batch (twice: the answers must agree) and chats through
    ChatSession and mm_infer_session (run_chat), each call with exact
    launch counts of every kernel, then holds the first-token and decode
    logits of the loaded model against the plain paths.
    Returns the phase's numbers and the launch counts of each call."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        model_config_to_hf
    from videollama2_tpu_torch.inference import api

    cfg = api_config()
    with open(MANIFEST) as f:
        manifest = json.load(f)
    shapes = {k: s for k, s in manifest.items()
              if not re.match(r"model\.layers\.(\d+)\.", k)
              or int(k.split(".")[2]) < API_LLM_LAYERS}
    n_params = sum(math.prod(s) for s in shapes.values())
    out = {}
    t0 = time.perf_counter()
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(model_config_to_hf(cfg), f)
    gen = torch.Generator(device="cuda").manual_seed(0)
    write_safetensors(os.path.join(ckpt, "model.safetensors"), shapes,
                      lambda n, s: api_init(n, s, gen))
    out["checkpoint_gb"] = os.path.getsize(
        os.path.join(ckpt, "model.safetensors")) / 1e9
    log(f"[api] wrote {len(shapes)} of {len(manifest)} released keys "
        f"(LLM layers 0-{API_LLM_LAYERS - 1} of 32), "
        f"{n_params / 1e9:.3f} B params, {out['checkpoint_gb']:.2f} GB "
        f"bf16 safetensors in {time.perf_counter() - t0:.1f} s")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, processor, tok = api.model_init(
        ckpt, load_8bit=True, kv_bits=8, max_len=1792, buckets=(BUCKET,),
        tokenizer=ToyTokenizer(cfg.llm.vocab_size))
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[api] model_init(load_8bit=True, kv_bits=8): {out['load_s']:.2f} s "
        f"(read + map + quantize + move, the file in the page cache), peak "
        f"device memory {out['load_peak_gb']:.2f} GB")
    if dataclasses.asdict(model.config) != dataclasses.asdict(cfg):
        raise RuntimeError(f"api: loaded config {model.config} != {cfg}")
    eng = model.engine
    if not all("kernel_q8" in eng.params["llm"]["layers"][n]
               for n in ("qkv", "o", "gate", "up", "down")) \
            or "kernel_q8" not in eng.params["vision"]["layers"]["qkv"] \
            or eng.kv_bits != 8:
        raise RuntimeError("api: load_8bit did not give int8 packs")

    H = cfg.vision.image_size
    rng = np.random.default_rng(2)
    clips = rng.integers(0, 256, (2, cfg.num_frames, H + H // 2, H),
                         dtype=np.uint8)
    want = phase_launches(counters, cfg, 1, True, NEW_TOKENS - 1, True)
    questions = [f"question {i} : what happens in the video" + " then" * i
                 + " ?" for i in range(API_BATCH)]
    counts = {}

    def call(label, fn):
        answer, res, counts[label] = counted_call(f"api {label}", counters,
                                                  want, fn)
        answers = answer if isinstance(answer, list) else [answer]
        if not all(isinstance(a, str) and a for a in answers):
            raise RuntimeError(f"api {label}: answers {answers!r}")
        log(f"[api] {label}: answer 0: {answers[0][:60]!r}...")
        return answers, res

    _, out["mm_infer"] = call("mm_infer", lambda cb: api.mm_infer(
        clips[0], questions[0], model, tok, max_new_tokens=NEW_TOKENS,
        stream_cb=cb))
    batch = []
    for run in range(2):
        answers, out[f"mm_infer_batch run {run + 1}"] = call(
            f"mm_infer_batch run {run + 1}", lambda cb: api.mm_infer_batch(
                clips[0], questions, model, tok, max_new_tokens=NEW_TOKENS,
                stream_cb=cb))
        batch.append(answers)
    if batch[0] != batch[1] or len(batch[0]) != API_BATCH:
        raise RuntimeError("api: the two mm_infer_batch runs differ")
    out["chat"], chat_counts = run_chat(model, tok, clips[0], counters)
    counts.update(chat_counts)
    prompt = api.build_prompt_ids(questions[0], cfg, tok, "video")
    check_against_plain(eng, cfg, clips, prompt, BUCKET, attn, k1, k2)
    check_decode_against_plain(eng, cfg, clips, prompt, BUCKET, k3, dk, 8)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[api] peak device memory {out['peak_gb']:.2f} GB")
    return out, counts


class LogitTap:
    """Within `with tap:`, records what the Engine takes its tokens from and
    changes nothing: each select_token call's logits [B, V] (the first
    token of a generate or of a continued turn, then each plain decode
    step), each verify pass's per-row frontiers and logits [B, K, V] and
    what it was fed (its embeddings and step0, for verify_logits' replay),
    and each verify round's accepted draft count."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self.picks, self.verifies, self.accepted = [], [], []
        self.fed = []

    def record(self) -> dict:
        return {"picks": list(self.picks), "verifies": list(self.verifies),
                "fed": list(self.fed)}

    def __enter__(self):
        from videollama2_tpu_torch.inference import sampling, speculative
        from videollama2_tpu_torch.models import llm
        self._saved = [(sampling, "select_token", sampling.select_token),
                       (llm, "decode_verify", llm.decode_verify),
                       (speculative, "accept_drafts",
                        speculative.accept_drafts)]
        select, verify, accept = (f for _, _, f in self._saved)

        def select_token(generator, logits, *args):
            self.picks.append(logits)
            return select(generator, logits, *args)

        def decode_verify(params, cfg, embeds, cache, valid_len, prompt_len,
                          step0, w8a8=False):
            self.fed.append((embeds.clone(), step0.clone()
                             if isinstance(step0, torch.Tensor) else step0))
            logits, cache = verify(params, cfg, embeds, cache, valid_len,
                                   prompt_len, step0, w8a8)
            per_row = isinstance(step0, torch.Tensor) and step0.dim() == 1
            self.verifies.append((step0.tolist() if per_row
                                  else [int(step0)] * logits.shape[0],
                                  logits))
            return logits, cache

        def accept_drafts(drafts, greedy):
            emitted, accepted = accept(drafts, greedy)
            self.accepted.append(accepted)
            return emitted, accepted

        sampling.select_token = select_token
        llm.decode_verify = decode_verify
        speculative.accept_drafts = accept_drafts
        return self

    def __exit__(self, *exc):
        for module, name, fn in self._saved:
            setattr(module, name, fn)
        self.reset()


def logits_at(record, b, p, speculative) -> torch.Tensor:
    """The logits behind token p of row b in a recorded run: a plain run
    (or a continued turn) takes token p from select_token call p; a
    speculative run takes its first token from select_token and token
    p > 0 from the last verify pass whose slot p - 1 - frontier lies in
    its block (slot j at frontier s predicts token s + 1 + j)."""
    if not speculative or p == 0:
        return record["picks"][p][b]
    for fronts, logits in reversed(record["verifies"]):
        j = p - 1 - fronts[b]
        if 0 <= j < logits.shape[1]:
            return logits[b, j]
    raise RuntimeError(f"no verify pass produced token {p} of row {b}")


def check_tokens(label, plain, other, plain_logits, other_logits,
                 recompute=None) -> dict:
    """Token streams of two paths over the same requests (plain: the
    reference path; each *_logits(b, p) gives that path's logits behind
    token p of row b). Logs the equal tokens. At each row's first
    differing position p both paths have consumed the same prefix; there
    the plain path's top-2 margin must be below the max abs difference
    that the other path's arithmetic makes (a near-tie the paths' rounding
    flips, ROADMAP §3), and each difference held must stay within
    compare_logits' bound, 0.4 of the plain logits' std. Where both paths
    share their arithmetic (bf16 weights, a continued turn against a fresh
    one) that is the difference of the two logit rows. Where the other
    path's verify passes take W8A8 over int8 packs against the weight-only
    int8 decode kernels, `recompute` ({row: p} -> {mode: {row: logits}},
    verify_logits) recomputes verify over the same prefix in weight-only
    arithmetic and with the independent W8A8 reference (w8a8_reference):
    the bound holds weight-only verify against the plain path and the
    recorded W8A8 verify against the reference, and the margin is held
    against the reference's difference from the plain path (the W8A8
    effect, reference minus weight-only, is logged). The recompute replays
    the recorded run's verify passes, so each logit row comes from the
    same pass and slot, over the same cache history, as the recorded one.
    Returns the numbers and "ok"."""
    equal = sum(x == y for pr, orow in zip(plain, other)
                for x, y in zip(pr, orow))
    total = sum(len(pr) for pr in plain)
    log(f"[{label}] equal tokens {equal} of {total} "
        f"({sum(pr == orow for pr, orow in zip(plain, other))} of "
        f"{len(plain)} rows identical)")
    if any(len(pr) != len(orow) for pr, orow in zip(plain, other)):
        raise RuntimeError(f"{label}: rows of different lengths")
    firsts = {b: next(i for i, (x, y) in enumerate(zip(pr, orow)) if x != y)
              for b, (pr, orow) in enumerate(zip(plain, other)) if pr != orow}
    recomputed = recompute(firsts) if recompute and firsts else None
    ties, ok = [], True
    for b, p in firsts.items():
        lp = plain_logits(b, p).float()
        lo = other_logits(b, p).float()
        if int(lp.argmax()) != plain[b][p] or int(lo.argmax()) != other[b][p]:
            raise RuntimeError(f"{label}: row {b} position {p}: the "
                               "recorded logits do not give the tokens")
        diff = (lp - lo).abs().max().item()
        top2 = lp.topk(2).values
        tie = {"row": b, "position": p, "max_abs_diff": diff,
               "bound": 0.4 * lp.std().item(),
               "plain_top2_margin": (top2[0] - top2[1]).item()}
        held, flip = [diff], diff
        if recomputed is not None:
            lm = recomputed["weight_only"][b].float()
            lr = recomputed["w8a8_reference"][b].float()
            held = [(lm - lp).abs().max().item(), (lo - lr).abs().max().item()]
            tie["weight_only_max_abs_diff"], \
                tie["w8a8_vs_reference_max_abs_diff"] = held
            flip = tie["reference_max_abs_diff"] = \
                (lr - lp).abs().max().item()
            tie["w8a8_effect_max_abs_diff"] = (lr - lm).abs().max().item()
        tie["ok"] = (max(held) <= tie["bound"]
                     and tie["plain_top2_margin"] < flip)
        log(f"[{label}] row {b} first differs at token {p}: "
            + ", ".join(f"{k} {v:.4f}" for k, v in tie.items()
                        if isinstance(v, float)) + f", ok {tie['ok']}")
        ok = ok and tie["ok"]
        ties.append(tie)
    return {"equal_tokens": equal, "tokens": total, "near_ties": ties,
            "ok": ok}


def w8a8_reference(x: torch.Tensor, pack: dict) -> torch.Tensor:
    """W8A8 of an int8 pack emulated in fp32, independent of the port's
    ops/layers code and of torch._int_mm: each row of x rounded to int8 on
    its own absmax / 127, the product of the rounded rows and the int8
    weights in fp32 (TF32 off; its integer partial sums stay below 2^24
    at these widths, so it matches an int32 product), times the row scale
    and the pack's column scale, cast to x's dtype."""
    xf = x.float()
    xs = xf.abs().amax(dim=-1, keepdim=True).clamp(min=1e-8) / 127.0
    xq = torch.round(xf / xs).clamp(-127, 127)
    y = torch.matmul(xq, pack["q"].float())
    return (y * xs * pack["scale"][..., 0, :].float()).to(x.dtype)


def verify_logits(eng, cfg, frames, prompt, bucket, record, firsts) -> dict:
    """The verify path's logits behind token firsts[b] of row b in two
    arithmetics: "weight_only" (w8a8 False, the weight-only int8
    arithmetic of the decode kernels) and "w8a8_reference" (w8a8 True with
    every packed dense through w8a8_reference). The prompt is prefilled
    once into a fresh cache for frames' B rows; each mode replays, on its
    own copy of that cache, the verify passes of `record` (a LogitTap
    record of a speculative run) with their embeddings and per-row
    frontiers, and takes token p from the pass and slot that logits_at
    takes it from in the record. Lockstep passes from other frontiers
    would write the cache from other passes, which at full width alone
    moves a logit by about 0.4 std. Returns {mode: {row: logits}}."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.ops import layers
    args = _plan_args(cfg, frames, prompt, eng.device, bucket)
    params = eng.params["llm"]
    prefilled = llm_lib.init_cache(cfg.llm, frames.shape[0], eng.max_len,
                                   eng.dtype, kv_bits=eng.kv_bits,
                                   device=eng.device)
    out = {}
    with torch.inference_mode():
        vl2.prefill_multimodal(eng.params, cfg, *args, prefilled, w8a8=True)
        for mode in ("weight_only", "w8a8_reference"):
            cache = dataclasses.replace(prefilled, **{
                f.name: getattr(prefilled, f.name).clone()
                for f in dataclasses.fields(prefilled)
                if getattr(prefilled, f.name) is not None})
            saved = layers.dense_w8a8
            if mode == "w8a8_reference":
                layers.dense_w8a8 = w8a8_reference
            try:
                verifies = []
                for (fronts, _), (embeds, step0) in zip(record["verifies"],
                                                        record["fed"]):
                    logits, cache = llm_lib.decode_verify(
                        params, cfg.llm, embeds, cache, args[-1], bucket,
                        step0, w8a8=mode != "weight_only")
                    verifies.append((fronts, logits))
                out[mode] = {b: logits_at({"verifies": verifies}, b, p, True)
                             for b, p in firsts.items()}
            finally:
                layers.dense_w8a8 = saved
            del cache
    return out


def phase_launches(counters, cfg, B, prefill, decode_steps, packed,
                   frames=True):
    """Launch counts of a call: the tower (K1; not for an audio-only
    prompt, frames False) and the prefill (K2) when it prefills B prompts,
    and K3-K5 for each plain decode step of packed int8 weights; 0 for
    every other kernel."""
    L = cfg.llm.num_layers
    want = dict.fromkeys(counters, 0)
    if prefill:
        want.update(encoder_attention=vit_layers(cfg)
                    * (B * cfg.num_frames // 128 or 1) if frames else 0,
                    flash_attention=L)
    if packed and decode_steps:
        want.update(decode_attention=decode_steps * L,
                    matmul_q8_layered=2 * decode_steps * L,
                    ffn_q8_layered=decode_steps * L)
    return want


def counted_call(label, counters, want, fn, tap=None):
    """fn(stream_cb) once with every launch counter at 0 (and the tap
    cleared); raises unless the counts equal want. Returns (fn's result,
    its numbers, the counts)."""
    for c in counters.values():
        c.launches = 0
    if tap is not None:
        tap.reset()
    stamps = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = fn(lambda b, toks: stamps.setdefault(len(toks),
                                                  time.perf_counter()))
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    counts = {n: c.launches for n, c in counters.items()}
    log(f"[{label}] launches {counts} (want {want})")
    if counts != want:
        raise RuntimeError(f"{label}: kernel launch counts {counts} != "
                           f"{want}")
    stats = {"call_s": t_end - t0}
    if stamps:
        t_first, n = min(stamps.values()), max(stamps)
        stats.update(first_token_s=t_first - t0,
                     ms_per_token=(t_end - t_first) / (n - 1) * 1e3)
    if tap is not None and tap.verifies:
        stats["verify_passes"] = len(tap.verifies)
        if tap.accepted:
            outs = result[0] if isinstance(result, tuple) else result
            emitted = sum(len(o) - 1 for o in outs)
            stats.update(tokens_per_pass=emitted / len(tap.verifies),
                         accepted_drafts_mean=statistics.mean(tap.accepted))
    log(f"[{label}] " + ", ".join(f"{k} {v:.4f}" if isinstance(v, float)
                                  else f"{k} {v}" for k, v in stats.items()))
    return result, stats, counts


def run_speculation(name, base, cfg, frames, prompt, bucket, counters,
                    batched: bool, session: bool):
    """The "speculative + sessions" phase on a slice's weights, through an
    Engine over base's params (no copy) with SPEC_ROOM rows after the
    bucket and a second bucket for fresh prompts over a session's history.
    B = 1 greedy speculation (k = SPEC_K, SPEC_NEW_TOKENS tokens) against
    plain greedy; with `batched`, B = 16 against plain greedy over
    NEW_TOKENS; with `session`, generate(return_session=True) and two
    generate_continue turns, each against a fresh generate over the whole
    history. Every call has exact launch counts (a speculative generate
    whose budget suffices launches no decode kernel; a continued turn no
    tower or prefill kernel); every comparison goes through check_tokens.
    Returns the numbers and the launch counts of each call."""
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    packed = "kernel_q8" in base.params["llm"]["layers"]["qkv"]
    eng = Engine(cfg, base.params, dtype=torch.bfloat16,
                 max_len=bucket + SPEC_ROOM,
                 buckets=(bucket, bucket + SPEC_ROOM // 2),
                 decode_chunk=NEW_TOKENS, kv_bits=base.kv_bits,
                 device="cuda")
    out, counts = {}, {}
    tap = LogitTap()

    def call(label, B, prefill, decode_steps, fn):
        res, out[label], counts[label] = counted_call(
            f"{name} {label}", counters,
            phase_launches(counters, cfg, B, prefill, decode_steps, packed),
            fn, tap)
        return res, tap.record()

    def against_plain(B, n):
        prompts, fr = [prompt] * B, frames[:B]
        spec, spec_rec = call(
            f"B{B} k{SPEC_K}", B, True, 0, lambda cb: eng.generate(
                prompts, frames=fr, gen=GenerationConfig(
                    max_new_tokens=n, speculative_k=SPEC_K),
                eos_token_id=-1, stream_cb=cb))
        plain, plain_rec = call(
            f"B{B} plain", B, True, n - 1, lambda cb: eng.generate(
                prompts, frames=fr, gen=GenerationConfig(max_new_tokens=n),
                eos_token_id=-1, stream_cb=cb))
        out[f"B{B} k{SPEC_K}"]["vs_plain"] = check_tokens(
            f"{name} B{B} k{SPEC_K} vs plain", plain, spec,
            lambda b, p: logits_at(plain_rec, b, p, False),
            lambda b, p: logits_at(spec_rec, b, p, True),
            (lambda firsts: verify_logits(eng, cfg, fr, prompt, bucket,
                                          spec_rec, firsts))
            if packed else None)

    gen = GenerationConfig(max_new_tokens=SESSION_NEW_TOKENS)
    with tap, torch.inference_mode():
        against_plain(1, SPEC_NEW_TOKENS)
        if batched:
            against_plain(frames.shape[0], NEW_TOKENS)
        if session:
            (_, sess), _ = call(
                "session turn 1", 1, True, SESSION_NEW_TOKENS - 1,
                lambda cb: eng.generate([prompt], frames=frames[:1], gen=gen,
                                        eos_token_id=-1, stream_cb=cb,
                                        return_session=True))
            rng = np.random.default_rng(3)
            for turn in (2, 3):
                ids = [int(x) for x in rng.integers(10, 1000,
                                                    SESSION_TURN_TOKENS)]
                history = sess.token_history + ids
                (cont, sess), cont_rec = call(
                    f"session turn {turn}", 1, False, SESSION_NEW_TOKENS - 1,
                    lambda cb: eng.generate_continue(
                        sess, ids, gen=gen, eos_token_id=-1, stream_cb=cb))
                fresh, fresh_rec = call(
                    f"fresh turn {turn}", 1, True, SESSION_NEW_TOKENS - 1,
                    lambda cb: eng.generate([history], frames=frames[:1],
                                            gen=gen, eos_token_id=-1,
                                            stream_cb=cb))
                out[f"session turn {turn}"]["vs_fresh"] = check_tokens(
                    f"{name} session turn {turn} vs fresh", fresh, cont,
                    lambda b, p: logits_at(fresh_rec, b, p, False),
                    lambda b, p: logits_at(cont_rec, b, p, False))
                log(f"[{name}] turn {turn}: first token continued "
                    f"{out[f'session turn {turn}']['first_token_s']:.4f} s "
                    f"({SESSION_TURN_TOKENS + 1} tokens fed) against fresh "
                    f"{out[f'fresh turn {turn}']['first_token_s']:.4f} s "
                    f"({len(history)} prompt ids)")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    failed = [label for label, o in out.items()
              if not o.get("vs_plain", o.get("vs_fresh", {})).get("ok", True)]
    if failed:
        raise RuntimeError(f"{name}: token differences beyond a near-tie "
                           f"in {failed}")
    return out, counts


def run_chat(model, tok, clip, counters) -> tuple:
    """The api model's chat entries: a 3-turn ChatSession (turns 2 and 3
    from the cache: no tower or prefill launch) and two mm_infer_session
    calls through one SessionStore (a miss, then a hit), each call with
    exact launch counts. Returns the numbers and the counts."""
    from videollama2_tpu_torch.inference import api
    cfg = model.config
    out, counts = {}, {}
    steps = CHAT_NEW_TOKENS - 1

    def call(label, cached, fn):
        want = phase_launches(counters, cfg, 1, not cached, steps, True)
        res, out[label], counts[label] = counted_call(
            f"api {label}", counters, want, fn)
        return res

    questions = ["what happens in the video ?", "and after that ?",
                 "why does it happen ?"]
    chat = api.ChatSession(clip, model, tok, max_new_tokens=CHAT_NEW_TOKENS)
    for turn, q in enumerate(questions, 1):
        reply = call(f"ChatSession turn {turn}", turn > 1,
                     lambda cb: chat.ask(q))
        log(f"[api] ChatSession turn {turn}: {reply[:60]!r}...")
    log(f"[api] ChatSession stats {chat.stats}")
    if chat.stats["cached_turns"] < 2:
        raise RuntimeError(f"api: ChatSession cached {chat.stats}")
    out["chat_stats"] = dict(chat.stats)
    store = api.SessionStore()
    msgs = [{"role": "user", "content": questions[0]}]
    for n, cached in ((1, False), (2, True)):
        reply = call(f"mm_infer_session call {n}", cached,
                     lambda cb: api.mm_infer_session(
                         clip, [dict(m) for m in msgs], model, tok, store,
                         max_new_tokens=CHAT_NEW_TOKENS, stream_cb=cb))
        msgs += [{"role": "assistant", "content": reply},
                 {"role": "user", "content": questions[1]}]
    log(f"[api] SessionStore stats {store.stats}; first token continued "
        f"{out['mm_infer_session call 2']['first_token_s']:.4f} s against "
        f"fresh {out['mm_infer_session call 1']['first_token_s']:.4f} s")
    if store.stats != {"hits": 1, "misses": 1}:
        raise RuntimeError(f"api: SessionStore stats {store.stats}")
    out["store_stats"] = dict(store.stats)
    return out, counts


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


def av_inputs(cfg, B: int, prompt):
    """The "av" phase's inputs: B seeded waveforms of AV_SECONDS made into
    BEATs fbank features on the host by the port's media/audio.py (padded
    to audio.max_frames), the 2.1 slice's prompt with <audio> after its
    <video> tag and its audio-only twin (<audio> in place of <video>), the
    tokens each modal tag stands for and both prompts' buckets (their
    spliced lengths rounded up to a multiple of 128). Returns (fbank,
    prompts {"av", "audio"}, tpm, buckets, host seconds of the fbank)."""
    from videollama2_tpu_torch.constants import (AUDIO_TOKEN_INDEX,
                                                 VIDEO_TOKEN_INDEX)
    from videollama2_tpu_torch.media import audio as audio_lib
    rng = np.random.default_rng(4)
    T = cfg.audio.max_frames
    t0 = time.perf_counter()
    feats = []
    for _ in range(B):
        wav = rng.standard_normal(int(audio_lib.SAMPLE_RATE * AV_SECONDS))
        fb = audio_lib.beats_preprocess((0.3 * wav).clip(-1, 1))
        feats.append(np.pad(fb, ((0, max(0, T - len(fb))), (0, 0)))[:T])
    fbank = np.stack(feats).astype(np.float32)
    host_s = time.perf_counter() - t0
    i = prompt.index(VIDEO_TOKEN_INDEX)
    prompts = {"av": prompt[:i + 1] + [AUDIO_TOKEN_INDEX] + prompt[i + 1:],
               "audio": prompt[:i] + [AUDIO_TOKEN_INDEX] + prompt[i + 1:]}
    tpm = av_tpm(cfg)
    buckets = {m: -(-n // 128) * 128
               for m, n in spliced_length_of(prompts, tpm).items()}
    return fbank, prompts, tpm, buckets, host_s


def av_tpm(cfg) -> dict:
    """The tokens each modal tag of an audio-visual prompt stands for."""
    from videollama2_tpu_torch.constants import (AUDIO_TOKEN_INDEX,
                                                 IMAGE_TOKEN_INDEX,
                                                 VIDEO_TOKEN_INDEX)
    return {IMAGE_TOKEN_INDEX: cfg.tokens_per_video,
            VIDEO_TOKEN_INDEX: cfg.tokens_per_video,
            AUDIO_TOKEN_INDEX: cfg.tokens_per_audio}


def run_av_phase(base, base_cfg, frames, prompt, counters, attn, k1, k2, k3,
                 dk):
    """The "av" phase: VideoLLaMA2.1-AV (`preset("videollama2_qwen2_av")`,
    16 frames) through an Engine over the 2.1 int8 slice's tree (base's
    params, no copy) plus a seeded bf16 audio branch. B = 16 rows of
    frames and AV_SECONDS of audio: two audio-visual generates, then two
    audio-only ones, each with exact launch counts; the BEATs + projector
    encode timed at B = 16; first-token and decode logits of two rows
    (audio-visual and audio-only) through the kernels against the plain
    versions. Returns the numbers and the launch counts of each run."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.models import beats
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.utils.synthetic import synthetic_audio_params

    cfg = cfglib.preset("videollama2_qwen2_av").replace(num_frames=16)
    if dataclasses.replace(cfg, audio=None) != base_cfg:
        raise RuntimeError("av: the AV preset is not the 2.1 slice's model "
                           "with an audio branch")
    B = frames.shape[0]
    fbank, prompts, tpm, buckets, host_s = av_inputs(cfg, B, prompt)
    audio = synthetic_audio_params(cfg, dtype=torch.bfloat16, device="cuda",
                                   seed=1)
    eng = Engine(cfg, dict(base.params, audio=audio), dtype=torch.bfloat16,
                 max_len=buckets["av"] + NEW_TOKENS,
                 buckets=(buckets["audio"], buckets["av"]),
                 decode_chunk=NEW_TOKENS, kv_bits=8, device="cuda")
    out = {"fbank_host_s": host_s, "audio_params_m": sum(
        t.numel() for t in _leaves(audio)) / 1e6}
    log(f"[av] {cfg.tokens_per_audio} audio tokens a row "
        f"({fbank.shape[1]} fbank frames, {B} rows made on the host in "
        f"{host_s:.3f} s), audio branch {out['audio_params_m']:.1f} M "
        f"params bf16; prompts {spliced_length_of(prompts, tpm)}, buckets "
        f"{buckets}, max_len {eng.max_len}")
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    counts = {}
    for mode, fr in (("av", frames), ("audio", None)):
        counts[mode], out[mode] = run_slice(
            mode, eng, cfg, fr, prompts[mode], gcfg, counters,
            phase_launches(counters, cfg, B, True, NEW_TOKENS - 1, True,
                           frames=fr is not None), audio=fbank)

    dev_fbank = torch.from_numpy(fbank).to("cuda", torch.bfloat16)
    with torch.inference_mode():
        tokens = vl2.encode_audio(eng.params, cfg, dev_fbank)
        torch.cuda.synchronize()
        if tokens.shape != (B, cfg.tokens_per_audio, cfg.llm.hidden_size) \
                or not torch.isfinite(tokens).all():
            raise RuntimeError(f"av: audio tokens {tuple(tokens.shape)}")
        out["beats_ms"] = cuda_ms(lambda: beats.forward(
            eng.params["audio"]["encoder"], cfg.audio, dev_fbank))
        out["encode_audio_ms"] = cuda_ms(
            lambda: vl2.encode_audio(eng.params, cfg, dev_fbank))
    del tokens, dev_fbank
    log(f"[av] BEATs at B {B} ([{B},{fbank.shape[1]},128] bf16): "
        f"{out['beats_ms']:.3f} ms; BEATs + projector (encode_audio) "
        f"{out['encode_audio_ms']:.3f} ms (CUDA events, median of "
        f"{TIMING_ITERS})")
    for mode, fr in (("av", frames[:2]), ("audio", None)):
        check_against_plain(eng, cfg, fr, prompts[mode], buckets[mode], attn,
                            k1, k2, fbank=fbank[:2], tpm=tpm, label=mode)
    check_decode_against_plain(eng, cfg, frames[:2], prompts["av"],
                               buckets["av"], k3, dk, 8, fbank=fbank[:2],
                               tpm=tpm, label="av int8")
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def spliced_length_of(prompts, tpm) -> dict:
    """{name: the spliced length of prompts[name]}."""
    from videollama2_tpu_torch.multimodal.splice import spliced_length
    return {m: spliced_length(p, tpm) for m, p in prompts.items()}


def write_wav(path, seconds: float) -> None:
    """A seeded 44.1 kHz stereo int16 .wav (the api phase resamples and
    downmixes it through media/audio.load_wav)."""
    import wave
    rate = 44100
    rng = np.random.default_rng(5)
    data = (rng.standard_normal((int(rate * seconds), 2)) * 6000).clip(
        -32767, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(2)
        w.setsampwidth(2)
        w.setframerate(rate)
        w.writeframes(data.tobytes())


def run_api_av_phase(counters, attn, k1, k2, k3, dk):
    """The public API on the audio-visual model: writes a checkpoint with
    every key of the released VideoLLaMA2.1-AV layout (LLM depth
    API_LLM_LAYERS of 28) and a 44.1 kHz stereo .wav, loads it with
    model_init(load_8bit=True, kv_bits=8) and answers through
    mm_infer(modal="audio") on the .wav, mm_infer(modal="av") on
    {"video": frames, "audio": the .wav}, and two mm_infer_session AV
    calls through one SessionStore (a miss, then a hit whose tokens must
    equal stateless mm_infer's, or differ first at a near-tie), each call
    with exact launch counts; then holds the loaded model's audio-visual
    first-token and decode logits against the plain paths. Returns the
    phase's numbers and the launch counts of each call."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        model_config_to_hf
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference import api

    base = cfglib.preset("videollama2_qwen2_av").replace(num_frames=16)
    cfg = base.replace(llm=dataclasses.replace(base.llm,
                                               num_layers=API_LLM_LAYERS))
    with open(MANIFEST_AV) as f:
        manifest = json.load(f)
    shapes = {k: s for k, s in manifest.items()
              if not re.match(r"model\.layers\.(\d+)\.", k)
              or int(k.split(".")[2]) < API_LLM_LAYERS}
    n_params = sum(math.prod(s) for s in shapes.values())
    out, counts = {}, {}
    with tempfile.TemporaryDirectory() as ckpt:
        t0 = time.perf_counter()
        with open(os.path.join(ckpt, "config.json"), "w") as f:
            json.dump(dict(model_config_to_hf(cfg),
                           mm_audio_tower="BEATs_iter3_plus_AS2M"), f)
        gen = torch.Generator(device="cuda").manual_seed(0)
        weights = os.path.join(ckpt, "model.safetensors")
        write_safetensors(weights, shapes, lambda n, s: api_init(n, s, gen))
        out["checkpoint_gb"] = os.path.getsize(weights) / 1e9
        log(f"[api av] wrote {len(shapes)} of {len(manifest)} released "
            f"VideoLLaMA2.1-AV keys (LLM layers 0-{API_LLM_LAYERS - 1} of "
            f"28), {n_params / 1e9:.3f} B params, "
            f"{out['checkpoint_gb']:.2f} GB bf16 safetensors in "
            f"{time.perf_counter() - t0:.1f} s")
        wav = os.path.join(ckpt, "clip.wav")
        write_wav(wav, AV_SECONDS)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, processor, tok = api.model_init(
            ckpt, load_8bit=True, kv_bits=8, max_len=2048,
            buckets=(640, 1920), tokenizer=ToyTokenizer(cfg.llm.vocab_size))
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        os.remove(weights)
        log(f"[api av] model_init(load_8bit=True, kv_bits=8): "
            f"{out['load_s']:.2f} s, peak device memory "
            f"{out['load_peak_gb']:.2f} GB")
        if dataclasses.asdict(model.config) != dataclasses.asdict(cfg):
            raise RuntimeError(f"api av: loaded config {model.config} != "
                               f"{cfg}")
        eng = model.engine
        audio_leaves = list(_leaves(eng.params["audio"]))
        if "kernel_q8" not in eng.params["llm"]["layers"]["qkv"] \
                or "kernel_q8" not in eng.params["vision"]["layers"]["qkv"] \
                or eng.kv_bits != 8 or set(processor) != {
                    "image", "video", "audio", "av"} \
                or not all(t.dtype == torch.bfloat16 for t in audio_leaves):
            raise RuntimeError("api av: load_8bit did not give int8 packs "
                               "and a bf16 audio branch")

        H = cfg.vision.image_size
        rng = np.random.default_rng(6)
        clips = rng.integers(0, 256, (2, cfg.num_frames, H + H // 2, H),
                             dtype=np.uint8)
        question = "what do you hear and see in the clip ?"
        av_media = {"video": clips[0], "audio": wav}
        tap = LogitTap()

        def call(label, want, fn):
            """fn through counted_call; returns the answer, the greedy ids
            of the tap's picks and the tap's record."""
            answer, out[label], counts[label] = counted_call(
                f"api av {label}", counters, want, fn, tap)
            if not (isinstance(answer, str) and answer):
                raise RuntimeError(f"api av {label}: answer {answer!r}")
            log(f"[api av] {label}: {answer[:60]!r}...")
            return (answer, [[int(l[0].argmax()) for l in tap.picks]],
                    tap.record())

        def fresh(frames, new_tokens):
            return phase_launches(counters, cfg, 1, True, new_tokens - 1,
                                  True, frames=frames)

        def session_call(msgs, store):
            return lambda cb: api.mm_infer_session(
                av_media, [dict(m) for m in msgs], model, tok, store,
                modal="av", max_new_tokens=CHAT_NEW_TOKENS, stream_cb=cb)

        with tap:
            call("mm_infer audio", fresh(False, NEW_TOKENS),
                 lambda cb: api.mm_infer(wav, question, model, tok,
                                         modal="audio",
                                         max_new_tokens=NEW_TOKENS,
                                         stream_cb=cb))
            call("mm_infer av", fresh(True, NEW_TOKENS),
                 lambda cb: api.mm_infer(av_media, question, model, tok,
                                         modal="av",
                                         max_new_tokens=NEW_TOKENS,
                                         stream_cb=cb))
            store = api.SessionStore()
            msgs = [{"role": "user", "content": question}]
            reply, _, _ = call("mm_infer_session call 1",
                               fresh(True, CHAT_NEW_TOKENS),
                               session_call(msgs, store))
            msgs += [{"role": "assistant", "content": reply},
                     {"role": "user", "content": "and why does it sound so ?"}]
            # the hit continues the stored session: no tower or prefill
            _, cont, cont_rec = call(
                "mm_infer_session call 2",
                phase_launches(counters, cfg, 1, False, CHAT_NEW_TOKENS - 1,
                               True),
                session_call(msgs, store))
            _, stateless, stateless_rec = call(
                "mm_infer turn 2", fresh(True, CHAT_NEW_TOKENS),
                lambda cb: api.mm_infer(av_media, [dict(m) for m in msgs],
                                        model, tok, modal="av",
                                        max_new_tokens=CHAT_NEW_TOKENS,
                                        stream_cb=cb))
        if store.stats != {"hits": 1, "misses": 1}:
            raise RuntimeError(f"api av: SessionStore stats {store.stats}")
        out["session_vs_stateless"] = check_tokens(
            "api av mm_infer_session call 2 vs stateless mm_infer",
            stateless, cont, lambda b, p: stateless_rec["picks"][p][b],
            lambda b, p: cont_rec["picks"][p][b])
        if not out["session_vs_stateless"]["ok"]:
            raise RuntimeError("api av: the continued turn differs from "
                               "stateless mm_infer beyond a near-tie")
        log(f"[api av] SessionStore stats {store.stats}; first token "
            f"continued {out['mm_infer_session call 2']['first_token_s']:.4f}"
            f" s against fresh "
            f"{out['mm_infer_session call 1']['first_token_s']:.4f} s")

        # the loaded model's audio-visual logits against the plain paths
        tpm = av_tpm(cfg)
        prompt = api.build_prompt_ids(question, cfg, tok, "av")
        fbank = np.repeat(api._prep_audio(wav, cfg), 2, axis=0)
        bucket = -(-spliced_length_of({"av": prompt}, tpm)["av"] // 128)             * 128
        check_against_plain(eng, cfg, clips, prompt, bucket, attn, k1, k2,
                            fbank=fbank, tpm=tpm, label="api av")
        check_decode_against_plain(eng, cfg, clips, prompt, bucket, k3, dk,
                                   8, fbank=fbank, tpm=tpm,
                                   label="api av int8")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[api av] peak device memory {out['peak_gb']:.2f} GB")
    del model, eng
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def lora_training(label, cfg, bits, batches, counters, want, k2):
    """One run of the "lora" phase's training: VideoLLaMA2-7B-8F's seeded
    bf16 tree (LLM layers as folded int4 packs with bits 4, the QLoRA base;
    head, embedding and tower stay bf16) with adapters injected on the card
    (fp32 masters), two passes of LORA_STEPS steps through Trainer.train
    under lora_enable (run_training: launch counts, equal losses, every b
    and the connector changed, every frozen tensor bit-unchanged), then one
    microbatch's loss and adapter gradients against the plain attention.
    Returns (params, numbers, the split save's numbers for bits 4)."""
    from videollama2_tpu_torch.ops import quant
    from videollama2_tpu_torch.train import lora as lora_lib
    from videollama2_tpu_torch.train.optimizer import (OptimizerConfig,
                                                       flatten)
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    t0 = time.perf_counter()
    params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                              seed=0)
    if bits:
        quant.quantize_in_place(params["llm"]["layers"],
                                quant.LLM_PROJECTIONS, bits)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params["llm"] = lora_lib.inject_lora(
        gen, params["llm"], lora_lib.LoraConfig(r=LORA_R, alpha=LORA_ALPHA),
        cfg.llm)
    torch.cuda.synchronize()
    flat = flatten(params)
    adapters = [t for p, t in flat.items()
                if "lora" in p and p[p.index("lora") + 1] in ("a", "b")]
    b_paths = [p for p in flat if "lora" in p and p[p.index("lora") + 1]
               == "b"]
    n_adapter = sum(t.numel() for t in adapters)
    log(f"[{label}] weights made on the card in "
        f"{time.perf_counter() - t0:.2f} s "
        f"({sum(t.nbytes for t in flat.values()) / 1e9:.2f} GB: LLM layers "
        f"{'int4 packs' if bits else 'bf16'}, adapters r {LORA_R} alpha "
        f"{LORA_ALPHA} on q, k, v, o, gate, up, down: {n_adapter / 1e6:.1f} "
        f"M params, {n_adapter * 4 / 1e9:.2f} GB fp32)")
    opt = OptimizerConfig(learning_rate=LORA_LR, mm_projector_lr=LORA_LR,
                          warmup_ratio=0.03, schedule="cosine",
                          lora_enable=True)
    split = None
    with tempfile.TemporaryDirectory() as out_dir:
        res = run_training(label, cfg, params, batches, counters, want,
                           out_dir, opt, LORA_ACCUM, b_paths)
        saved = os.path.join(out_dir, f"lora-{LORA_STEPS}")
        files = sorted(os.listdir(saved))
        if files != ["adapter_config.json", "adapter_model.bin",
                     "config.json", "non_lora_trainables.bin"]:
            raise RuntimeError(f"{label}: Trainer saved {files}")
        if bits:
            split = check_split_save(cfg, params)
    res["vs_plain"] = check_training_against_plain(
        label, cfg, params, batches[0], k2, counters, adapters)
    res["adapter_params"] = n_adapter
    return params, res, split


def check_split_save(cfg, params) -> dict:
    """(b): export_lora_split of the trained adapters (timed, its bytes),
    read back by the loader's path-(a) reader: every adapter equal to the
    trained fp32 one bit for bit, r and alpha as trained."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        load_lora_adapters
    from videollama2_tpu_torch.checkpoint.projector_io import \
        export_lora_split
    from videollama2_tpu_torch.train.lora import extract_lora
    out = {}
    with tempfile.TemporaryDirectory() as d:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        export_lora_split(d, params["llm"], params["connector"], cfg)
        out["export_s"] = time.perf_counter() - t0
        out["bytes"] = {f: os.path.getsize(os.path.join(d, f))
                        for f in sorted(os.listdir(d))}
        t0 = time.perf_counter()
        got, lcfg = load_lora_adapters(d, cfg.llm)
        out["read_s"] = time.perf_counter() - t0
    want = extract_lora(params["llm"])["layers"]
    if (lcfg.r, lcfg.alpha) != (LORA_R, LORA_ALPHA) \
            or set(got["layers"]) != set(want):
        raise RuntimeError(f"split save: read back {lcfg}, "
                           f"{sorted(got['layers'])}")
    for name, ab in want.items():
        for k in ("a", "b"):
            if not torch.equal(got["layers"][name][k],
                               ab[k].detach().cpu()):
                raise RuntimeError(f"split save: {name}.{k} differs")
    log(f"[lora split save] export_lora_split {out['export_s']:.2f} s, "
        f"{sum(out['bytes'].values()) / 1e9:.3f} GB {out['bytes']}; read "
        f"back through the path-(a) reader in {out['read_s']:.2f} s: all "
        f"{2 * len(want)} adapter tensors bit-equal to the trained fp32 "
        "ones")
    return out


def run_lora_serving(cfg, params, counters) -> dict:
    """(c): the QLoRA-trained tree served unmerged (int4 packs with their
    adapters, bf16 head and tower, int8 KV cache) at B = 16 with bench.py's
    prompt, LORA_NEW_TOKENS greedy tokens, twice: K1 and K2 as any
    prefill, and no decode kernel (the packed decode stands aside for
    adapters); the same tokens both times."""
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.models.llm import _packed_decode
    B = 16
    frames, prompt, bucket = slice_inputs(cfg, B)
    eng = Engine(cfg, params, dtype=torch.bfloat16,
                 max_len=bucket + LORA_NEW_TOKENS, buckets=(bucket,),
                 decode_chunk=LORA_NEW_TOKENS, kv_bits=8, device="cuda")
    if _packed_decode(eng.params["llm"]["layers"]) is not None:
        raise RuntimeError("lora serve: the packed decode took the tree")
    want = phase_launches(counters, cfg, B, True, LORA_NEW_TOKENS - 1,
                          packed=False)
    dev_frames = eng.upload_frames(frames)
    gen = GenerationConfig(max_new_tokens=LORA_NEW_TOKENS)
    runs, out = [], {}
    for run in range(2):
        toks, out[f"run {run + 1}"], _ = counted_call(
            f"lora serve run {run + 1}", counters, want,
            lambda cb: eng.generate([prompt] * B, frames=dev_frames,
                                    gen=gen, eos_token_id=-1, stream_cb=cb))
        runs.append(np.asarray(toks))
    if runs[0].shape != (B, LORA_NEW_TOKENS) \
            or not np.array_equal(runs[0], runs[1]):
        raise RuntimeError("lora serve: bad or unequal tokens")
    out["bucket"] = bucket
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lora serve] {B}x{LORA_NEW_TOKENS} tokens at bucket {bucket}, "
        f"identical in both runs; first row {runs[1][0].tolist()}; peak "
        f"{out['peak_gb']:.1f} GB")
    return out


def run_api_lora(ckpt, counters) -> dict:
    """(d): a LoRA directory over the api phase's checkpoint `ckpt` (its
    LLM layers 0-7 of 32) through model_init(lora_dir, model_base=ckpt,
    load_8bit=True, kv_bits=8). The seeded adapters (r LORA_R on every
    target, b nonzero) are small multiples of powers of two, so a @ b * s
    and its sum with a bf16 kernel are exact in fp32 in any order: the
    loader's packs must equal quantize(base + a @ b * s) made here on the
    card bit for bit. Then mm_infer (launch counts as the api phase's) and
    an Engine over that independent tree must give the same tokens."""
    from videollama2_tpu_torch.checkpoint.convert_hf import read_safetensors
    from videollama2_tpu_torch.checkpoint.projector_io import \
        export_lora_split
    from videollama2_tpu_torch.inference import api
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.ops.quant import quantize_int8
    from videollama2_tpu_torch.train.lora import PEFT_NAME
    from videollama2_tpu_torch.utils.synthetic import \
        synthetic_connector_params
    cfg = api_config()
    L, s = cfg.llm.num_layers, LORA_ALPHA / LORA_R
    sd = read_safetensors(os.path.join(ckpt, "model.safetensors"))
    gen = torch.Generator(device="cuda").manual_seed(4)
    adapters = {}
    for name, peft in PEFT_NAME.items():
        d_out, d_in = sd[f"model.layers.0.{peft}.weight"].shape
        a = torch.randint(-4, 5, (L, d_in, LORA_R), generator=gen,
                          device="cuda").float() / 64
        b = torch.randint(-4, 5, (L, LORA_R, d_out), generator=gen,
                          device="cuda").float() / 4096
        adapters[name] = {"a": a, "b": b,
                          "s": torch.full((L, 1, 1), s, device="cuda")}
    connector = synthetic_connector_params(cfg.connector, torch.bfloat16,
                                           "cuda", seed=3)
    out = {}
    with tempfile.TemporaryDirectory() as lora_dir:
        t0 = time.perf_counter()
        export_lora_split(lora_dir, {"layers": {
            n: {"lora": lo} for n, lo in adapters.items()}}, connector, cfg)
        out["export_s"] = time.perf_counter() - t0
        out["lora_dir_gb"] = sum(os.path.getsize(os.path.join(lora_dir, f))
                                 for f in os.listdir(lora_dir)) / 1e9
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, _, tok = api.model_init(
            lora_dir, model_base=ckpt, load_8bit=True, kv_bits=8,
            max_len=1792, buckets=(BUCKET,),
            tokenizer=ToyTokenizer(cfg.llm.vocab_size))
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lora api] export_lora_split {out['export_s']:.2f} s "
        f"({out['lora_dir_gb']:.3f} GB); model_init(lora_dir, model_base, "
        f"load_8bit=True, kv_bits=8): {out['load_s']:.2f} s (read, merge, "
        f"quantize, move), peak device memory {out['load_peak_gb']:.2f} GB")
    eng = model.engine
    layers = eng.params["llm"]["layers"]
    merged, moved = {}, {}
    for name in ("qkv", "o", "gate", "up", "down"):
        packs, base_packs = [], []
        for n in (("q", "k", "v") if name == "qkv" else (name,)):
            w = torch.stack([sd[f"model.layers.{i}.{PEFT_NAME[n]}.weight"]
                             .to("cuda").T.float() for i in range(L)])
            lo = adapters[n]
            packs.append(quantize_int8(
                w + torch.matmul(lo["a"], lo["b"]) * s, axis=-2))
            base_packs.append(quantize_int8(w, axis=-2))
        # the Engine holds pack scales in its dtype (as the JAX Engine)
        got = layers[name]["kernel_q8"]
        pack = {"q": torch.cat([p["q"] for p in packs], -1),
                "scale": torch.cat([p["scale"] for p in packs], -1).to(
                    got["scale"].dtype)}
        if not (torch.equal(got["q"], pack["q"])
                and torch.equal(got["scale"], pack["scale"])):
            raise RuntimeError(f"lora api: {name}'s int8 pack is not "
                               "quantize(base + a @ b * s)")
        moved[name] = (torch.cat([p["q"] for p in base_packs], -1)
                       != pack["q"]).float().mean().item()
        merged[name] = {"kernel_q8": pack}
    log(f"[lora api] the loaded int8 packs equal quantize(base + a @ b * s) "
        f"made on the card, bit for bit; share of int8 weights the adapters "
        f"moved: {json.dumps(moved)}")
    if min(moved.values()) <= 0:
        raise RuntimeError("lora api: an adapter moved no weight")
    out["moved_share"] = moved

    H = cfg.vision.image_size
    clip = np.random.default_rng(5).integers(
        0, 256, (cfg.num_frames, H + H // 2, H), dtype=np.uint8)
    question = "what happens in the video ?"
    streamed = {}

    def ask(cb):
        def both(b, toks):
            streamed[b] = list(toks)
            cb(b, toks)
        return api.mm_infer(clip, question, model, tok,
                            max_new_tokens=NEW_TOKENS, stream_cb=both)
    answer, out["mm_infer"], counts = counted_call(
        "lora api mm_infer", counters,
        phase_launches(counters, cfg, 1, True, NEW_TOKENS - 1, True), ask)
    tree = dict(eng.params, llm=dict(eng.params["llm"],
                                     layers=dict(layers, **merged)))
    ref = Engine(cfg, tree, dtype=torch.bfloat16, max_len=1792,
                 buckets=(BUCKET,), kv_bits=8, device="cuda")
    want = ref.generate([api.build_prompt_ids(question, cfg, tok, "video")],
                        frames=clip[None],
                        gen=GenerationConfig(max_new_tokens=NEW_TOKENS),
                        eos_token_id=tok.eos_token_id)[0]
    if streamed[0] != want or len(want) != NEW_TOKENS:
        raise RuntimeError(f"lora api: mm_infer {streamed[0]} != the "
                           f"merged tree's Engine {want}")
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[lora api] mm_infer's {NEW_TOKENS} tokens equal the Engine's over "
        f"the independently merged tree; answer {answer[:60]!r}...; peak "
        f"{out['peak_gb']:.2f} GB")
    return out, counts


def smooth_frames(rng, n, h, w) -> np.ndarray:
    """n seeded [h, w, 3] uint8 frames: a gradient that moves a frame, with
    noise (so a PNG row's filters differ and no frame repeats)."""
    y, x = np.mgrid[0:h, 0:w]
    base = (x * 3 + y * 2)[None, ..., None] + np.arange(3) * 40 \
        + 7 * np.arange(n)[:, None, None, None]
    return ((base + rng.integers(0, 8, (n, h, w, 3))) % 256).astype(np.uint8)


def write_frame_dir(path, frames, fmts) -> None:
    """Frame i as <i>.png or <i>.bmp (fmts[i % len(fmts)]), sorted in
    order."""
    from png_writer import encode_bmp, encode_png
    os.makedirs(path)
    for i, f in enumerate(frames):
        fmt = fmts[i % len(fmts)]
        with open(os.path.join(path, f"{i:03d}.{fmt}"), "wb") as out:
            out.write(encode_png(f) if fmt == "png" else encode_bmp(f))


def stream_request(url, payload, timeout=300):
    """POST a generate stream; returns (chunks, s to the first complete
    chunk, s to the end of the stream)."""
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    t0 = time.perf_counter()
    first, buf = None, b""
    with urllib.request.urlopen(req, timeout=timeout) as r:
        while True:
            data = r.read1(65536)
            if not data:
                break
            buf += data
            if first is None and b"\0" in buf:
                first = time.perf_counter() - t0
    return ([json.loads(c) for c in buf.split(b"\0") if c], first,
            time.perf_counter() - t0)


class CallRecorder:
    """The Engine behind the serving plane with each generate call recorded
    (changes nothing): its prompts, how many media it encoded, its
    media_group and image_mode, its tokens, and the logits of every
    select_token call made on its thread. Concurrent requests run their
    generate calls on threads of their own (the worker's request threads,
    the batcher's two collectors), so a call's logits are those its
    thread picked from while it ran."""

    def __init__(self, engine):
        import threading
        self._engine = engine
        self._picks = {}
        self._lock = threading.Lock()
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._engine, name)

    def generate(self, ids, frames=None, **kw):
        import threading
        tid = threading.get_ident()
        self._picks[tid] = []
        try:
            result = self._engine.generate(ids, frames=frames, **kw)
        finally:
            picks = self._picks.pop(tid)
        outs = result[0] if isinstance(result, tuple) else result
        with self._lock:
            self.calls.append({
                "ids": [list(p) for p in ids], "outs": outs, "picks": picks,
                "media": None if frames is None else int(frames.shape[0]),
                "media_group": kw.get("media_group"),
                "image_mode": bool(kw.get("image_mode"))})
        return result

    def __enter__(self):
        import threading
        from videollama2_tpu_torch.inference import sampling
        self._saved = sampling.select_token

        def select_token(generator, logits, *args):
            picks = self._picks.get(threading.get_ident())
            if picks is not None:
                picks.append(logits)
            return self._saved(generator, logits, *args)

        sampling.select_token = select_token
        return self

    def __exit__(self, *exc):
        from videollama2_tpu_torch.inference import sampling
        sampling.select_token = self._saved

    def find(self, ids):
        """(call, row) of the recorded call that held prompt `ids`."""
        for call in self.calls:
            for row, p in enumerate(call["ids"]):
                if p == ids:
                    return call, row
        raise RuntimeError("serve: no recorded call held the prompt")


def tower_passes(cfg, frames: int) -> int:
    """Tower passes of encode_frames over `frames` frames (its chunking:
    VIT_ENCODE_CHUNK, halved until it divides the count)."""
    from videollama2_tpu_torch.models.videollama2 import VIT_ENCODE_CHUNK
    chunk = VIT_ENCODE_CHUNK
    while chunk > 1 and frames % chunk:
        chunk //= 2
    return 1 if frames <= chunk else frames // chunk


def calls_launches(counters, cfg, calls) -> dict:
    """Launch counts of recorded generate calls on the int8 slice: the
    tower over each call's distinct media (one frame a row in image
    mode), one prefill each, and K3-K5 for each decode step."""
    L = cfg.llm.num_layers
    want = dict.fromkeys(counters, 0)
    for c in calls:
        if c["media"] is not None:
            frames = c["media"] * (1 if c["image_mode"] else cfg.num_frames)
            want["encoder_attention"] += vit_layers(cfg) * tower_passes(
                cfg, frames)
        want["flash_attention"] += L
        steps = len(c["outs"][0]) - 1
        want["decode_attention"] += steps * L
        want["matmul_q8_layered"] += 2 * steps * L
        want["ffn_q8_layered"] += steps * L
    return want


def run_serve_phase(eng, cfg, counters, smi) -> tuple:
    """The "serve" phase on the int8 slice's Engine (VideoLLaMA2-7B-16F,
    int8 packs, W8A8 prefill, int8 KV cache) with a word-level toy
    tokenizer: the processors on a 16-frame 480x640 directory (PNG and
    BMP frames) and a 480x640 PNG; a controller and a model worker on
    localhost streaming a video and an image request through the proxy,
    each with exact launch counts and the tokens of a direct
    Engine.generate on the same processed frames; 16 concurrent video
    requests over 4 distinct videos plus 2 text requests on a worker with
    dynamic batching against the same 18 on the plain worker (answers held
    to B = 1 up to near-ties, the tower run once a distinct video of a
    group, requests/s and the batcher's stats); two chat completions of
    the OpenAI-compatible server; the container paths. Returns the
    numbers and the launch counts of each serialized request."""
    from http.server import ThreadingHTTPServer
    import threading
    from videollama2_tpu_torch.inference import api
    from videollama2_tpu_torch.inference.engine import GenerationConfig
    from videollama2_tpu_torch.media import video_reader
    from videollama2_tpu_torch.serve import controller as ctrl_mod
    from videollama2_tpu_torch.serve import model_worker as worker_mod
    from videollama2_tpu_torch.serve import openai_api
    from avi_writer import write_avi

    tok = ToyTokenizer(cfg.llm.vocab_size)
    recorder = CallRecorder(eng)
    model = api.VideoLLaMA2(config=cfg, engine=recorder)
    processors = {w: api._processors(cfg, w) for w in ("rgb", "i420")}
    out, counts, servers = {"device": smi}, {}, []
    batched = None
    S = cfg.vision.image_size
    root = tempfile.TemporaryDirectory()
    rng = np.random.default_rng(5)

    def serve(handler):
        srv = ThreadingHTTPServer(("localhost", 0), handler)
        threading.Thread(target=srv.serve_forever, daemon=True).start()
        servers.append(srv)
        return f"http://localhost:{srv.server_address[1]}"

    try:
        # -- 1. the processors ---------------------------------------------
        clip_dir = os.path.join(root.name, "clip")
        clip = smooth_frames(rng, 16, 480, 640)
        write_frame_dir(clip_dir, clip, ("png", "bmp"))
        image_path = os.path.join(root.name, "image.png")
        from png_writer import encode_png
        image_png = encode_png(smooth_frames(rng, 1, 480, 640)[0])
        with open(image_path, "wb") as f:
            f.write(image_png)
        decoded = video_reader.read_video_frames(clip_dir, 16)
        if not np.array_equal(np.stack(decoded), clip):
            raise RuntimeError("serve: the frame directory did not decode "
                               "to the frames written")
        host = {}
        for wire in ("rgb", "i420"):
            for run in range(2):
                t0 = time.perf_counter()
                video = processors[wire]["video"](clip_dir)
                host[f"video {wire} ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            img = processors[wire]["image"](image_path)
            host[f"image {wire} ms"] = (time.perf_counter() - t0) * 1e3
            shape = ((16, S, S, 3) if wire == "rgb"
                     else (16, S * 3 // 2, S))
            if video.shape != shape or video.dtype != np.uint8 \
                    or img.shape != (1,) + shape[1:]:
                raise RuntimeError(f"serve: processor shapes {video.shape} "
                                   f"{img.shape} on the {wire} wire")
        out["processors_host_ms"] = host
        log(f"[serve] ({smi}) processors on the host, 16 frames 480x640 "
            "(8 PNG, 8 BMP) -> 336: " + ", ".join(
                f"{k} {v:.1f}" for k, v in host.items()))
        video_i420 = processors["i420"]["video"](clip_dir)
        image_i420 = processors["i420"]["image"](image_path)

        # -- 2. controller + worker: two serialized streamed requests -------
        controller = ctrl_mod.Controller("shortest_queue")
        ctrl_url = serve(ctrl_mod.make_handler(controller))
        worker = worker_mod.ModelWorker(
            ctrl_url, "", "serve", model_name="videollama2-7b-16f-int8",
            register=False, preloaded=(model, processors["i420"], tok))
        worker.worker_addr = serve(worker_mod.make_handler(worker))
        worker.register_to_controller()
        with urllib_post(ctrl_url + "/list_models", {}) as r:
            models = json.loads(r.read())["models"]
        if models != ["videollama2-7b-16f-int8"]:
            raise RuntimeError(f"serve: /list_models gave {models}")
        steps = NEW_TOKENS - 1
        want = phase_launches(counters, cfg, 1, True, steps, True)
        b64_image = base64.b64encode(image_png).decode()
        for kind, extra, tensor, modal in (
                ("video", {"video": clip_dir}, video_i420, "video"),
                ("image", {"images": [b64_image]}, image_i420, "image")):
            question = f"what happens in the {kind} ?"
            ids = api.build_prompt_ids(question, cfg, tok, modal)
            frames = tensor[None]
            if modal == "image":
                frames = np.broadcast_to(frames, (1, cfg.num_frames)
                                         + tensor.shape[1:])
            direct = eng.generate([ids], frames=frames,
                                  gen=GenerationConfig(
                                      max_new_tokens=NEW_TOKENS),
                                  eos_token_id=-1,
                                  image_mode=(modal == "image"))[0]
            # through the controller's proxy, then straight to the worker
            # (the proxy reads the stream 4096 bytes at a time, so only the
            # worker's own stream shows when the first chunk is ready)
            for route, url in (("controller", ctrl_url),
                               ("worker", worker.worker_addr)):
                recorder.calls.clear()
                for c in counters.values():
                    c.launches = 0
                chunks, first_s, total_s = stream_request(
                    url + "/worker_generate_stream",
                    dict(extra, model="videollama2-7b-16f-int8",
                         prompt=question, temperature=0.0,
                         max_new_tokens=NEW_TOKENS))
                got = {n: c.launches for n, c in counters.items()}
                log(f"[serve] {kind} request through the {route}: launches "
                    f"{got} (want {want})")
                if got != want:
                    raise RuntimeError(f"serve {kind}: launch counts {got} "
                                       f"!= {want}")
                if chunks[-1]["error_code"] != 0 or len(recorder.calls) != 1:
                    raise RuntimeError(f"serve {kind}: {chunks[-1]}")
                if recorder.calls[0]["outs"][0] != direct or \
                        chunks[-1]["text"] != tok.decode(direct).strip():
                    raise RuntimeError(f"serve {kind}: the worker's tokens "
                                       "differ from a direct "
                                       "Engine.generate")
                counts[f"serve {kind} request ({route})"] = got
                out[f"{kind}_request_{route}"] = {
                    "first_chunk_s": first_s, "request_s": total_s,
                    "chunks": len(chunks)}
                log(f"[serve] ({smi}) {kind} request through the {route}: "
                    f"first chunk {first_s:.3f} s, request {total_s:.3f} s, "
                    f"{len(chunks)} chunks; tokens equal a direct "
                    "Engine.generate")

        # -- 3. dynamic batching against the plain worker ---------------------
        videos = []
        for v in range(SERVE_VIDEOS):
            path = os.path.join(root.name, f"video{v}")
            write_frame_dir(path, smooth_frames(rng, 16, 480, 640), ("bmp",))
            videos.append(path)
        requests = [({"video": videos[i % SERVE_VIDEOS]},
                     f"question {i} : what happens in the video ?", "video")
                    for i in range(SERVE_VIDEO_REQUESTS)]
        requests += [({}, f"question {i} : say something ?", "text")
                     for i in range(SERVE_TEXT_REQUESTS)]
        batched = worker_mod.ModelWorker(
            "", "", "serve", register=False, dynamic_batch=True,
            preloaded=(model, processors["i420"], tok))
        batched_url = serve(worker_mod.make_handler(batched))
        runs = {}
        for label, url in (("plain worker", worker.worker_addr),
                           ("batching worker", batched_url)):
            recorder.calls.clear()
            for c in counters.values():
                c.launches = 0
            results = [None] * len(requests)

            def send(i, url=url, results=results):
                extra, question, _ = requests[i]
                results[i] = stream_request(
                    url + "/worker_generate_stream",
                    dict(extra, prompt=question, temperature=0.0,
                         max_new_tokens=NEW_TOKENS))

            threads = [threading.Thread(target=send, args=(i,))
                       for i in range(len(requests))]
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with recorder:
                for t in threads:
                    t.start()
                for t in threads:
                    t.join(timeout=600)
            wall = time.perf_counter() - t0
            if any(t.is_alive() for t in threads) or any(
                    r is None or r[0][-1]["error_code"] != 0
                    for r in results):
                raise RuntimeError(f"serve {label}: a request failed")
            got = {n: c.launches for n, c in counters.items()}
            want = calls_launches(counters, cfg, recorder.calls)
            log(f"[serve] {label}: {len(recorder.calls)} generate calls, "
                f"launches {got} (want {want})")
            if got != want:
                raise RuntimeError(f"serve {label}: launch counts {got} != "
                                   f"{want}")
            counts[f"serve {label}"] = got
            calls = list(recorder.calls)
            rows = []
            for (extra, question, modal), res in zip(requests, results):
                call, row = recorder.find(api.build_prompt_ids(
                    question, cfg, tok, modal))
                if res[0][-1]["text"] != tok.decode(
                        call["outs"][row]).strip():
                    raise RuntimeError(f"serve {label}: streamed text and "
                                       "tokens differ")
                rows.append((call, row))
            runs[label] = {"rows": rows, "calls": calls}
            out[label] = {
                "requests": len(requests), "wall_s": wall,
                "requests_per_s": len(requests) / wall,
                "first_chunk_s_median": statistics.median(
                    r[1] for r in results),
                "request_s_median": statistics.median(r[2] for r in results),
                "generate_calls": len(calls),
                "batch_sizes": sorted(len(c["ids"]) for c in calls),
                "media_encoded": [c["media"] for c in calls
                                  if c["media"] is not None]}
            if label == "batching worker":
                out[label]["batcher_stats"] = batched.batcher.stats
                # each call encodes each distinct video of its rows once
                for call in calls:
                    videos_in = {i % SERVE_VIDEOS for i in range(
                        SERVE_VIDEO_REQUESTS) if api.build_prompt_ids(
                            requests[i][1], cfg, tok, "video")
                        in call["ids"]}
                    if (call["media"] or 0) != len(videos_in):
                        raise RuntimeError(
                            f"serve: a call of {len(call['ids'])} rows "
                            f"encoded {call['media']} videos for "
                            f"{len(videos_in)} distinct ones")
            log(f"[serve] ({smi}) {label}: {len(requests)} requests "
                f"({SERVE_VIDEO_REQUESTS} video over {SERVE_VIDEOS} videos, "
                f"{SERVE_TEXT_REQUESTS} text) in {wall:.3f} s, "
                f"{out[label]['requests_per_s']:.2f} requests/s, median "
                f"first chunk {out[label]['first_chunk_s_median']:.3f} s, "
                f"median request {out[label]['request_s_median']:.3f} s; "
                f"batch sizes {out[label]['batch_sizes']}, videos encoded a "
                f"call {out[label]['media_encoded']}"
                + (f", batcher stats {batched.batcher.stats}"
                   if label == "batching worker" else ""))
        plain_rows = runs["plain worker"]["rows"]
        batch_rows = runs["batching worker"]["rows"]
        out["batched_vs_b1"] = check_tokens(
            "serve batched vs B 1",
            [c["outs"][r] for c, r in plain_rows],
            [c["outs"][r] for c, r in batch_rows],
            lambda b, p: plain_rows[b][0]["picks"][p][plain_rows[b][1]],
            lambda b, p: batch_rows[b][0]["picks"][p][batch_rows[b][1]])
        if not out["batched_vs_b1"]["ok"]:
            raise RuntimeError("serve: a batched answer differs from B 1 "
                               "beyond a near-tie")
        out["batching_speedup"] = (out["batching worker"]["requests_per_s"]
                                   / out["plain worker"]["requests_per_s"])
        del runs, plain_rows, batch_rows
        recorder.calls.clear()

        # -- 4. the OpenAI-compatible server --------------------------------
        backend = openai_api.OpenAIBackend(
            "serve", "videollama2-7b-16f-int8",
            preloaded=(model, processors["i420"], tok))
        oai_url = serve(openai_api.make_handler(backend))
        data_url = "data:image/png;base64," + b64_image
        for kind, part, tensor, modal in (
                ("image", {"type": "image_url",
                           "image_url": {"url": data_url}},
                 image_i420, "image"),
                ("video", {"type": "video_url",
                           "video_url": {"url": clip_dir}},
                 video_i420, "video")):
            body = {"messages": [{"role": "user", "content": [
                {"type": "text", "text": f"describe the {kind}"}, part]}],
                "max_tokens": NEW_TOKENS}
            recorder.calls.clear()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            with urllib_post(oai_url + "/v1/chat/completions", body,
                             timeout=300) as r:
                reply = json.loads(r.read())
            took = time.perf_counter() - t0
            got = {n: c.launches for n, c in counters.items()}
            want = phase_launches(counters, cfg, 1, True, steps, True)
            if got != want:
                raise RuntimeError(f"serve openai {kind}: launch counts "
                                   f"{got} != {want}")
            text = reply["choices"][0]["message"]["content"]
            call = recorder.calls[0]
            if text != tok.decode(call["outs"][0]).strip() or \
                    call["ids"][0] != api.build_prompt_ids(
                        f"describe the {kind}", cfg, tok, modal):
                raise RuntimeError(f"serve openai {kind}: {reply}")
            counts[f"serve openai {kind}"] = got
            out[f"openai_{kind}_s"] = took
            log(f"[serve] ({smi}) OpenAI chat completion with a "
                f"{'data-URL PNG' if kind == 'image' else 'video path'}: "
                f"{took:.3f} s, launches {got}")

        # -- 5. container paths ---------------------------------------------
        avi = os.path.join(root.name, "clip.avi")
        avi_frames = smooth_frames(rng, 8, 48, 64)
        write_avi(avi, avi_frames, None, fps=4)
        available = video_reader.decoder_available()
        out["container_decoder"] = available
        log(f"[serve] the container decoder (media/csrc/video_decoder.cc, "
            f"libavcodec) {'builds' if available else 'does not build'} "
            "on this host")
        if available:
            vr = video_reader.VideoReader(avi)
            got_frames = vr.get_batch(range(len(avi_frames)))
            vr.close()
            if not np.array_equal(got_frames, avi_frames):
                raise RuntimeError("serve: the AVI's frames differ")
            log("[serve] the AVI's decoded frames equal the frames written")
        else:
            try:
                processors["rgb"]["video"](avi)
            except RuntimeError as e:
                if "libavcodec" not in str(e):
                    raise
                log(f"[serve] processor['video'] on an AVI raises: {e}")
            else:
                raise RuntimeError("serve: a container decoded without "
                                   "the decoder")
            chunks, _, took = stream_request(
                worker.worker_addr + "/worker_generate_stream",
                {"prompt": "what happens ?", "video": avi}, timeout=60)
            if len(chunks) != 1 or chunks[0]["error_code"] != 1:
                raise RuntimeError(f"serve: container request gave {chunks}")
            log(f"[serve] the worker answers a container request in "
                f"{took:.3f} s with error_code 1")
    finally:
        for srv in servers:
            srv.shutdown()
            srv.server_close()
        if batched is not None:
            batched.batcher.close()
        root.cleanup()
    return out, counts


def urllib_post(url, payload, timeout=60):
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


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
    from videollama2_tpu_torch.train.optimizer import (OptimizerConfig,
                                                       flatten)
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
    stages, slice_counts, spec_stages = {}, {}, {}
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
        if slice_name in SPEC_SLICES:
            # the "speculative + sessions" phase on this slice's weights
            spec_stages[slice_name], counts = run_speculation(
                slice_name, eng, cfg, frames, prompt, bucket, counters,
                **SPEC_SLICES[slice_name])
            slice_counts.update({f"{slice_name} {n}": c
                                 for n, c in counts.items()})
        if slice_name == "int8 slice":
            # the "serve" phase: media decoding and the serving plane
            t0 = time.perf_counter()
            serve_stage, counts = run_serve_phase(eng, cfg, counters, smi)
            serve_stage["phase_s"] = time.perf_counter() - t0
            slice_counts.update(counts)
            log(json.dumps({"serve": serve_stage}))
        stages[slice_name]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[{slice_name}] peak device memory "
            f"{stages[slice_name]['peak_gb']:.1f} GB")
        if slice_name == "2.1 int8 slice":
            # the "av" phase: VideoLLaMA2.1-AV on this slice's weights
            torch.cuda.reset_peak_memory_stats()
            av_stage, av_counts = run_av_phase(eng, cfg, frames, prompt,
                                               counters, attn, k1, k2, k3,
                                               dk)
            av_stage["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
            slice_counts.update(av_counts)
            video_first = stages[slice_name]["encode_prefill_first_token_s"]
            log("[av] first token (encode + prefill + head, B 16): av "
                f"{av_stage['av']['encode_prefill_first_token_s']:.3f} s, "
                "audio-only "
                f"{av_stage['audio']['encode_prefill_first_token_s']:.3f} s"
                f", 2.1 int8 video-only {video_first:.3f} s; decode "
                f"{av_stage['av']['decode_ms_per_token']:.2f} / "
                f"{av_stage['audio']['decode_ms_per_token']:.2f} ms/token; "
                f"peak device memory {av_stage['peak_gb']:.1f} GB")
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    log(json.dumps({"stages": stages}))
    log(json.dumps({"speculative": spec_stages}))

    # -- the public API on a released-layout checkpoint ----------------------
    # (the checkpoint stays for the "lora" phase's model_base)
    api_dir = tempfile.TemporaryDirectory()
    api_stage, api_counts = run_api_phase(api_dir.name, counters, attn, k1,
                                          k2, k3, dk)
    slice_counts.update({f"api {n}": c for n, c in api_counts.items()})
    log(json.dumps({"api": api_stage}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api_av_stage, api_av_counts = run_api_av_phase(counters, attn, k1, k2,
                                                   k3, dk)
    slice_counts.update({f"api av {n}": c for n, c in api_av_counts.items()})
    log(json.dumps({"av": av_stage, "api av": api_av_stage}))
    torch.cuda.reset_peak_memory_stats()

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
        train = run_training(
            "training slice", cfg, params, batches, counters, want, out_dir,
            OptimizerConfig(learning_rate=1e-3, warmup_ratio=0.0,
                            weight_decay=0.0, tune_mm_mlp_adapter=True),
            GRAD_ACCUM)
    train["vs_plain"] = check_training_against_plain(
        "training", cfg, params, batches[0], k2, counters,
        list(flatten(params["connector"]).values()))
    log(json.dumps({"training": train}))
    del params, batches
    gc.collect()
    torch.cuda.empty_cache()

    # -- the "lora" phase: LoRA and QLoRA finetuning at full width -----------
    rng = np.random.default_rng(2)
    batches = [synthetic_train_batch(cfg, rng, LORA_ACCUM * LORA_MB, TRAIN_S,
                                     TRAIN_MIN_VALID)
               for _ in range(LORA_STEPS)]
    micro = LORA_ACCUM * LORA_STEPS
    per_mb_lora = {"encoder_attention": vit_layers(cfg)
                   * (LORA_MB * cfg.num_frames // 128 or 1),
                   "flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                   "flash_attention_bwd_dkv": L}
    want_lora = dict.fromkeys(counters, 0)
    want_lora.update({n: c * micro for n, c in per_mb_lora.items()})
    log(f"[lora] {LORA_STEPS} steps of {LORA_ACCUM} x {LORA_MB} videos, "
        f"seq {TRAIN_S}; launches a microbatch wanted: {per_mb_lora} (x "
        f"{micro} microbatches a run)")
    lora = {}
    for label, bits in (("lora", None), ("qlora", 4)):
        torch.cuda.reset_peak_memory_stats()
        params, lora[label], split = lora_training(
            label, cfg, bits, batches, counters, want_lora, k2)
        if bits:
            lora["split_save"] = split
            torch.cuda.reset_peak_memory_stats()
            lora["serve"] = run_lora_serving(cfg, params, counters)
            slice_counts["lora serve"] = {n: c.launches
                                          for n, c in counters.items()}
        del params
        gc.collect()
        torch.cuda.empty_cache()
    del batches
    torch.cuda.reset_peak_memory_stats()
    lora["api"], slice_counts["lora api mm_infer"] = run_api_lora(
        api_dir.name, counters)
    api_dir.cleanup()
    log(json.dumps({"lora": lora}))
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
                "launches": want[name], "launches_lora_run": want_lora[name],
                **train_kernels[key], **extra}

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
