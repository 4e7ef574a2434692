#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (videollama2_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main path gives it, then drives the
full-width VideoLLaMA2-7B-16F video-QA path (CLIP-L/336 + STC + Mistral-7B,
bf16, seeded random weights) through Engine.generate and checks that the
run went through both kernels.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Prints the card's name and power limit, each phase's numbers, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed phase raises and the exit code
is non-zero; without a CUDA device it exits non-zero before printing
anything on stdout.
"""

import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

K1_TOL = 2e-2   # bf16 output rounding + bf16 P in the PV product
K2_TOL = 2e-2   # (outputs are averages of N(0, 1) values, |o| <= ~3)
TIMING_ITERS = 10
NEW_TOKENS = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = TIMING_ITERS) -> float:
    """Median over `iters` launches of fn's device time (CUDA events)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def rand_bf16(gen, shape):
    return torch.randn(shape, generator=gen, device="cuda").bfloat16()


def check_kernel(name, kernel, plain, cases, tol):
    """cases: (label, args, kwargs) with bf16 CUDA q/k/v. Compares the
    kernel with the plain version in fp32 on the same inputs and times the
    kernel and the plain version (on the bf16 inputs) at each shape."""
    worst = 0.0
    times = []
    for label, (q, k, v), kw in cases:
        got = kernel(q, k, v, **kw).float()
        ref = plain(q.float(), k.float(), v.float(), **kw)
        torch.cuda.synchronize()
        if not torch.isfinite(got).all():
            raise RuntimeError(f"{name} {label}: non-finite output")
        err = (got - ref).abs().max().item()
        del got, ref
        ms = cuda_ms(lambda: kernel(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), iters=3)
        log(f"[{name}] {label}: max_abs_err {err:.3e} (tol {tol:.0e}), "
            f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
        if not err <= tol:
            raise RuntimeError(f"{name} {label}: max_abs_err {err} > {tol}")
        worst = max(worst, err)
        times.append((ms, plain_ms))
        torch.cuda.empty_cache()
    return worst, times


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; "
                         "this run needs an NVIDIA GPU")
    from videollama2_tpu.constants import VIDEO_TOKEN_INDEX
    from videollama2_tpu.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.ops import _build
    from videollama2_tpu_torch.ops import attention as attn
    from videollama2_tpu_torch.ops import encoder_attention as k1
    from videollama2_tpu_torch.ops import flash_attention as k2
    from videollama2_tpu_torch.utils.synthetic import synthetic_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")

    # -- build -----------------------------------------------------------
    cached = _build.library_path().exists()
    t0 = time.perf_counter()
    _build.library()
    log(f"[build] nvcc sm_90a build of csrc/*.cu "
        f"{'(found built already) ' if cached else ''}and load: "
        f"{time.perf_counter() - t0:.1f} s")

    # -- K1 against plain at tower shapes ----------------------------------
    gen = torch.Generator(device="cuda").manual_seed(0)
    clip = tuple(rand_bf16(gen, (64, 577, 16, 64)) for _ in range(3))
    ragged = torch.randint(300, 578, (64,), generator=gen, device="cuda",
                           dtype=torch.int32)
    siglip = tuple(rand_bf16(gen, (16, 729, 16, 72)) for _ in range(3))
    k1_err, k1_times = check_kernel(
        "encoder_attention", k1.encoder_attention, k1.encoder_attention_plain,
        [("[64,577,16,64]", clip, {}),
         ("[64,577,16,64] ragged valid_len", clip, {"valid_len": ragged}),
         ("[16,729,16,72]", siglip, {})], K1_TOL)
    del clip, siglip

    # -- K2 against plain at prefill shapes --------------------------------
    q = rand_bf16(gen, (4, 1664, 32, 128))
    k = rand_bf16(gen, (4, 1664, 8, 128))
    v = rand_bf16(gen, (4, 1664, 8, 128))
    valid = torch.tensor([1574, 1200, 1664, 900], dtype=torch.int32,
                         device="cuda")
    k2_err, k2_times = check_kernel(
        "flash_attention", k2.flash_attention, k2.flash_attention_plain,
        [("q[4,1664,32,128] kv[4,1664,8,128] causal", (q, k, v),
          {"valid_len": valid, "causal": True})], K2_TOL)
    del q, k, v
    torch.cuda.empty_cache()

    # -- the slice at full width --------------------------------------------
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=16)
    t0 = time.perf_counter()
    params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                              seed=0)
    torch.cuda.synchronize()
    log(f"[slice] bf16 weights made on the card in "
        f"{time.perf_counter() - t0:.1f} s "
        f"({sum(t.numel() for t in _leaves(params)) / 1e9:.2f} B params)")
    eng = Engine(cfg, params, dtype=torch.bfloat16, max_len=1696,
                 buckets=(1664,), decode_chunk=32, kv_bits=16)
    del params
    B, T, H = 16, cfg.num_frames, cfg.vision.image_size
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, (B, T, H + H // 2, H), dtype=np.uint8)
    prompt = ([1] + [int(x) for x in rng.integers(10, 1000, 40)]
              + [VIDEO_TOKEN_INDEX]
              + [int(x) for x in rng.integers(10, 1000, 12)])
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    n_layers_vit = cfg.vision.select_layer % (cfg.vision.num_layers + 1)
    want_k1 = n_layers_vit * (B * T // 128)
    want_k2 = cfg.llm.num_layers

    runs = []
    stage = {}
    for run in range(2):
        k1.encoder_attention.launches = 0
        k2.flash_attention.launches = 0
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
        launches = (k1.encoder_attention.launches,
                    k2.flash_attention.launches)
        log(f"[slice] run {run + 1}: launches K1 {launches[0]} "
            f"(want {want_k1}), K2 {launches[1]} (want {want_k2})")
        if launches != (want_k1, want_k2):
            raise RuntimeError(f"kernel launch counts {launches} != "
                               f"{(want_k1, want_k2)}")
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
        log(f"[slice] run {run + 1}: upload {t_upload * 1e3:.1f} ms "
            f"({frames.nbytes / 1e6:.0f} MB), encode+prefill+first token "
            f"{stage['encode_prefill_first_token_s']:.3f} s, decode "
            f"{stage['decode_ms_per_token']:.2f} ms/token, generate "
            f"{stage['generate_s']:.3f} s")
    if not np.array_equal(runs[0], runs[1]):
        raise RuntimeError("the two runs gave different tokens")
    counts = {"encoder_attention": launches[0], "flash_attention": launches[1]}
    log(f"[slice] {B}x{NEW_TOKENS} tokens, identical in both runs; "
        f"first row: {runs[1][0][:8].tolist()}...")

    # -- the slice's first-token logits against the plain attention path ---
    check_against_plain(eng, cfg, frames[:2], prompt, attn, k1, k2)

    kernels = [
        {"name": "encoder_attention", "route": "cuda",
         "source": "videollama2_tpu_torch/csrc/encoder_attention.cu",
         "replaces": "videollama2_tpu/ops/encoder_attention.py:230",
         "launches": counts["encoder_attention"], "max_abs_err": k1_err,
         "ms": k1_times[0][0], "plain_ms": k1_times[0][1]},
        {"name": "flash_attention", "route": "cuda",
         "source": "videollama2_tpu_torch/csrc/flash_attention.cu",
         "replaces": "videollama2_tpu/ops/flash_attention.py:179",
         "launches": counts["flash_attention"], "max_abs_err": k2_err,
         "ms": k2_times[0][0], "plain_ms": k2_times[0][1]},
    ]
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


def _leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _leaves(v)
        else:
            yield v


def check_against_plain(eng, cfg, frames, prompt, attn, k1, k2) -> None:
    """First-token logits of two videos through the kernels and through
    the plain attention path (attend swapped for attend_plain), both at
    full width in bf16. The two differ only by rounding inside attention
    (the order of the fp32 sums, exp), which 23 + 32 bf16 layers amplify;
    the bounds are relative to the logits' std (~1.3 here): a wrong mask or
    a wrong head mapping moves logits by about a std.
    """
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.multimodal import splice as splice_lib

    B = frames.shape[0]
    plan = splice_lib.plan_batch([prompt] * B, cfg.tokens_per_video, 1664)

    def first_logits():
        dev = eng.device
        cache = llm_lib.init_cache(cfg.llm, B, 1664, torch.bfloat16,
                                   device=dev)
        with torch.inference_mode():
            last, _ = vl2.prefill_multimodal(
                eng.params, cfg, torch.from_numpy(frames).to(dev),
                torch.from_numpy(plan.text_ids).to(dev).long(),
                torch.from_numpy(plan.is_visual).to(dev),
                torch.from_numpy(plan.vis_index).to(dev),
                torch.from_numpy(plan.positions).to(dev),
                torch.from_numpy(plan.valid_len).to(dev), cache)
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
    if not (torch.isfinite(fast).all() and torch.isfinite(plain).all()):
        raise RuntimeError("non-finite first-token logits")
    diff = (fast - plain).abs()
    std = plain.std().item()
    agree = (fast.argmax(-1) == plain.argmax(-1)).float().mean().item()
    log(f"[slice] first-token logits, kernels vs plain attention: max abs "
        f"diff {diff.max().item():.4f} (bound 0.4 std), mean abs diff "
        f"{diff.mean().item():.4f} (bound 0.05 std), logit std {std:.4f}, "
        f"argmax agreement {agree:.2f}")
    if not (diff.max().item() <= 0.4 * std
            and diff.mean().item() <= 0.05 * std):
        raise RuntimeError("kernel path logits differ from the plain path "
                           "beyond the bounds")


if __name__ == "__main__":
    main()
