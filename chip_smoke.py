#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (videollama2_tpu_torch) on one NVIDIA
H100: builds the CUDA kernels from csrc/, holds each against its plain
PyTorch version at the shapes the main paths give it (and K10, the
head-pair tower attention, against K1 as well; its own path, the
`pack_pairs=True` entry of scripts/profile_torch_vit_attn.py, is driven
once with every counter at 0), then drives full-width video-QA models
(seeded random weights) through Engine.generate twice in each of eight
slices. VideoLLaMA2-7B-16F (CLIP-L/336 + STC + Mistral-7B): bf16 (bf16
weights and KV cache), int8 serving (int8 LLM and tower packs, W8A8
prefill, int8 KV cache, decode on the layered int8 kernels) and int4
serving, `load_4bit` (folded int4 LLM layers, int8 head and tower, W4A8
prefill, int8 KV cache, decode on the layered int4 kernels).
VideoLLaMA2.1-7B-16F (SigLIP-SO400M/384 + STCv35 + Qwen2-7B, 28 query
heads on 4 kv heads): bf16, bench.py's BENCH_MODEL=qwen2 serving tree
(int8 layers, head, tower and embedding, int8 KV cache) and its
BENCH_BITS=4 tree (folded int4 layers, decode on the layered int4
kernels). The Llama-2
preset (VideoLLaMA2 over Llama-2-7B: 32 kv heads, one a query head, F
11008) in the int8 serving tree. VideoLLaMA2-8x7B (CLIP + STC +
Mixtral-8x7B, 8 experts, top-2, at its 8 frames, the LLM cut to 8 of 32
layers) in bf16, the "mixtral slice", which also holds the MoE FFN's
capacity-gather dispatch against the Engine's dense one on one layer at
full width. It checks that each run went through its kernels, the exact
launch counts, and the first-token (bf16) and decode (int8, int4) logits
against the plain versions. The "mixtral api" phase loads a checkpoint
in the released 8x7B key layout (LLM cut to 2 layers) through model_init,
answers through mm_infer and checks that load_8bit / load_4bit refuse it
(MoE runs on floating expert kernels only). On the int8 and 2.1 bf16
slices' weights the "speculative + sessions" phase runs greedy prompt-lookup speculation (k = 4; B = 1 and
B = 16) against plain greedy and a session's two continued turns
against fresh generates, each call with exact launch counts and every
token difference held to a near-tie. On the int8 slice's Engine the
"serve" phase runs the media layer and the serving plane: the
processors on a 16-frame 480x640 directory (PNG and BMP frames, written
here) and a 480x640 PNG; the still-image formats (every file of
tests/fixtures/torch_images/ held to its golden digest of PIL's pixels,
WebP and TIFF among them; host decode times of progressive and baseline
JPEG, Adam7 and plain PNG, lossy and lossless WebP and LZW, Deflate and
uncompressed TIFF; a 16-frame directory of progressive JPEG, Adam7 PNG,
lossless WebP and LZW TIFF frames through the processors); a controller
and a model worker on localhost streaming a video, a PNG image, a
progressive JPEG image and a lossy WebP image request (exact launch
counts, the tokens of a direct Engine.generate);
16 concurrent video requests over 4 videos plus 2 text ones on a
dynamic-batching worker against the plain worker (requests/s; answers
held to B = 1 up to near-ties; each distinct video of a batch encoded
once); four chat completions of the OpenAI-compatible server (a PNG,
a progressive JPEG and a WebP data URL, a video path); and the container
paths (the decoder built
from media/csrc where libavcodec is, else a named error and an
error_code 1 answer). The "api" phase loads a checkpoint
in the released 7B-16F layout (LLM cut to 8 layers) through model_init
and answers through mm_infer, mm_infer_batch, a 3-turn ChatSession and
mm_infer_session (a word-level toy tokenizer keeps every call's decode
length, and so its launch counts, fixed); its checkpoint also holds
tests/tokenizer_writer.py's full-vocabulary Mistral tokenizer files, which
the port's reader (multimodal/hf_tokenizer.py) must tokenize as the
committed golden ids of the `tokenizers` library do, and a second
model_init with no tokenizer reads them and answers one clip (launch
counts derived from where the real EOS fell). The "av" phase runs VideoLLaMA2.1-AV (the 2.1 slice's
model with the BEATs audio tower and its projector) on the 2.1 int8
slice's weights plus a seeded bf16 audio branch: 16 audio-visual prompts
(16 frames and 10.24 s of audio each, fbank made on the host) twice, 16
audio-only ones twice, the BEATs encode timed, and first-token and decode
logits held against the plain versions; its api calls load a checkpoint
in the released VideoLLaMA2.1-AV layout (LLM cut to 8 layers) and answer
through mm_infer (audio on a .wav, and av) and mm_infer_session, then
the same golden check and tokenizer-less model_init on its Qwen2
tokenizer files. The
"eval" phase runs the evaluation harness on the api phase's checkpoint in
bf16: the MVBench inference script as `python -m` in a child process over a GIF
task and a JPEG frame-directory task it writes (then the merge and the
scorer's command line), the "launch" phase's eval scripts (below), the
Video-MME inference script in this process (JSON
question file, SRT subtitles, mm_infer_batch), run_batched over grouped
videos, each record and answer held to a direct B 1 mm_infer's, and
quant_accuracy.measure's six variants on the checkpoint's LLM (K3-K7 on
the packed ones), printing its table as numbers of seeded random
weights. Last,
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
Then the "parallel" phase (parallel/: the mesh, the rule table, the
sharded step, Trainer and Engine) starts a one-rank NCCL group in this
process and runs a stage-2 Trainer step (Mistral-7B, 8 of 32 LLM layers,
2 videos of 8 frames at seq 2048) and a greedy generate (2 videos of 16
frames) without a mesh and on the world-1 mesh, held bit-equal (loss,
every trained tensor and fp32 master, tokens, first-token logits) with
exact K1 / K2 / K8 / K9 counts, then K1, K2 with its LSE, K8 and K9 at
the shapes a rank gets under tensor 2 and 4 (Mistral-7B and Qwen2-7B)
and Ulysses seq 2 against their plain versions; with two cards or more
it also runs an fsdp 2 step and a tensor 2 generate on two NCCL ranks
against the world-1 results (scripts/profile_torch_parallel.py runs that
part alone, on 2 and 4 cards). Then the "projectors" phase swaps
VideoLLaMA2-7B's connector (CLIP whole, 8 of Mistral-7B's 32 layers,
bf16) for five of the other projector types (linear, mlp2x_gelu,
stp_connector, spatial_pool, spatial_conv; identity cannot splice the
tower's 1024 wide features into the 4096 wide LLM): a B 16 generate each
with exact K1 / K2 counts, first-token logits against the plain
attention, a B 4 generate against each video's B 1 (differences held to
near-ties), the connector's ms beside STC's and two stage-1 steps; then
a generate under utils/profiling.device_trace whose trace must hold K1's
and K2's kernels and the annotate ranges, and a stage-2 step under
remat=True and one under remat="dots", whose losses and exact bit sums
of every trained tensor and fp32 master must be equal.
The "drivers" phase runs the serving path's timing drivers
(scripts/bench_session_torch.py, bench_speculative_torch.py,
profile_torch_components.py and profile_torch_kernels.py) through their
functions at full width, at DRIVER_SPEC_TOKENS tokens a speculative run
and one timed iteration, every Engine call and stage with exact launch
counts and every speculative run held to plain greedy by check_tokens.
The "train entry" phase runs first, right after the build and the
writing of the api phases' checkpoints, so that this process holds no
more than its CUDA context while it runs: the port's training entry
point in child processes, as the reference's recipes launch it (their
microbatches: 8 a device for pretrain.sh, 4 for finetune.sh, at
accumulation 2), over those checkpoints (as plain LLM and tower
directories) and a corpus of JPEG, PNG and GIF media it writes, on the
LLM directory's own tokenizer files: stage 1, the same flags as a plain
`python -m` stopped by SIGTERM and resumed (its losses and restored state
held to the uninterrupted run's), stage 2 and VideoLLaMA2.1 stage 1 (on
a --tokenizer factory, two epochs of one step with a save every step),
under --bf16 (bf16 compute, fp32 masters of the trained tensors), each
with exact launch counts, every trained tensor moved and every frozen one
bit-unchanged; the tokenization's share of the host time of stage 2's
dataset items is measured. The "launch" phase drives the port's launch
scripts (scripts/torch/) as a user runs them, `bash` from the repository
root with this interpreter as `python` and `torchrun`: in the train entry
phase, stage 1's uninterrupted run is vllava/pretrain.sh under torchrun
(one rank), stage 2 is vllava/finetune.sh over its newest adapter, and
custom/finetune_lora.sh and finetune_qlora.sh take a step each (their
4 x 4) over the api checkpoint beside the plain SIGTERM and resumed runs
(scripts/profile_torch_launch.py times each script alone); in the eval
phase, eval/eval_video_mcqa_mvbench.sh runs
at CHUNKS 2 (both chunks on this card) and 1, whose merged records must
be equal, and eval/eval_video_mcqa_videomme.sh runs over the committed
parquet fixture (tests/fixtures/videomme/, decoded by the port's reader
and held to its golden digest of pandas' rows) with two of its videos
given GIF media, whose records must equal those of the same questions
read from their JSON form in this process. A sitecustomize module on the
scripts' PYTHONPATH (LAUNCH_SITECUSTOMIZE) hands each torchrun worker
and inference chunk to launch_hook, which records its exact kernel
launches (and a worker's TrainRecorder report); `[launch]` lines print
each script's seconds, the script's start to its first step, the steps
and the reader's milliseconds.

Usage (from the repository root, on a machine with a CUDA GPU):

    python3 chip_smoke.py

Prints the card's name and power limit, each phase's numbers, a
{"kernels": [...]} JSON line, and as its last line
{"ok": true, "device": {...}}. Any failed phase raises and the exit code
is non-zero; without a CUDA device it exits non-zero before printing
anything on stdout.
"""

import base64
import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import re
import shutil
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
# the ids `tokenizers` gives on tests/tokenizer_writer.py's full-vocabulary
# files (tests/test_torch_tokenizer.py keeps them current)
TOKENIZER_GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests", "fixtures", "tokenizer_golden.json")
TOKENIZER_FILES = ("tokenizer.json", "tokenizer_config.json",
                   "special_tokens_map.json")
TOKENIZER_TIMING_ITERS = 20
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
# the "mixtral slice": VideoLLaMA2-8x7B (CLIP + STC + Mixtral-8x7B, E 8,
# top-2) at its released 8 frames, full width with the LLM cut to
# MIXTRAL_LAYERS of 32 layers (all 32 are ~93 GB in bf16); bench.py's
# prompt splices to 898 tokens with its 845 visual tokens: bucket 1024.
# The "mixtral api" phase loads a checkpoint in the released 8x7B key
# layout with the LLM cut to MIXTRAL_API_LAYERS layers.
MIXTRAL_FRAMES = 8
MIXTRAL_LAYERS = 8
MIXTRAL_API_LAYERS = 2
# the gather dispatch against the dense one on the tokens whose pairs were
# all kept, of max|dense|: each expert's bf16 output, its bf16 routing
# weight and the bf16 sum of a token's two pairs round in another order
# (dense sums the weighted outputs in fp32 and rounds once), and the
# expert products run at other GEMM shapes
MOE_REL_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def script_device(script: str) -> str:
    """The device of a port driver script that reads PLATFORM
    (scripts/bench_*_torch.py, profile_torch_components.py and
    profile_torch_kernels.py): "cpu" under PLATFORM=cpu, which also
    selects their tiny config, else "cuda". Without a CUDA device and
    without PLATFORM=cpu, SystemExit naming the missing device: a driver
    never falls back to the CPU on its own."""
    if os.environ.get("PLATFORM") == "cpu":
        return "cpu"
    if not torch.cuda.is_available():
        raise SystemExit(f"{script}: no CUDA device (torch.cuda."
                         "is_available() is false); PLATFORM=cpu runs the "
                         "tiny config on the CPU")
    return "cuda"


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


_SPIN_MS_PER_CYCLE = []


def spin_timed_ms(fn, host_ms: float):
    """(device ms, covered) of one call of fn from CUDA events behind a
    spin kernel that lasts 1.5 x host_ms + 1 ms (host_ms: fn's time on the
    host clock, which bounds the time to enqueue it; the spin's cycles a
    ms measured once). When every launch of fn is enqueued before the spin
    ends (covered: the host's enqueue time is below the spin's device
    time), the events hold fn's kernels back to back, without the host's
    gaps between launches; uncovered, they hold some of those gaps."""
    if not _SPIN_MS_PER_CYCLE:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize()
        a.record()
        torch.cuda._sleep(SPIN_CYCLES)
        b.record()
        b.synchronize()
        _SPIN_MS_PER_CYCLE.append(a.elapsed_time(b) / SPIN_CYCLES)
    cycles = int((1.5 * host_ms + 1.0) / _SPIN_MS_PER_CYCLE[0])
    spin, start, end = (torch.cuda.Event(enable_timing=True)
                        for _ in range(3))
    torch.cuda.synchronize()
    spin.record()
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    fn()
    enqueue_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    return start.elapsed_time(end), enqueue_ms < spin.elapsed_time(start)


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
                               [1405, 1000, 1408, 700]),
                              # Llama-2: a kv head a query head
                              (4, BUCKET, 32, 32, [1574, 1200, 1664, 900])):
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


def _plan_args(cfg, frames, prompt, dev, bucket, B=None, tpm=None,
               prompts=None):
    """The prefill's inputs for B copies of prompt (B: frames' rows by
    default), or for the rows of `prompts`: frames on the device (None
    stays None) and the splice plan (tpm: the tokens a modal tag stands
    for, cfg.tokens_per_video by default)."""
    from videollama2_tpu_torch.multimodal import splice as splice_lib
    plan = splice_lib.plan_batch(
        prompts or [prompt] * (B or frames.shape[0]),
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


@contextlib.contextmanager
def moe_routing(llm_lib, routes: list, replay: bool):
    """MoE routing shared by two passes of the same inputs (a no-op for a
    dense model). Without replay, each _moe_router call's expert indices
    are appended to `routes`; with replay, each call takes the recorded
    indices of the same call of the first pass, with this pass's own
    probabilities at them, renormalized, so both passes route every token
    alike. A top-2 of 8 random routers flips on the rounding of a
    near-tie, and a flipped route changes its token's FFN output
    wholesale, far beyond compare_logits' bounds, which would hide what
    the kernels add. Yields [flipped routes, routes]: the (token, call)
    pairs whose own top-k set differed from the recorded one."""
    router, calls, flips = llm_lib._moe_router, iter(routes), [0, 0]

    def wrapped(x, lp, cfg):
        topw, topi = router(x, lp, cfg)
        if not replay:
            routes.append(topi)
            return topw, topi
        pinned = next(calls)
        flips[0] += int((topi.sort(-1).values != pinned.sort(-1).values)
                        .any(-1).sum().item())
        flips[1] += pinned[..., 0].numel()
        probs = torch.softmax(torch.matmul(
            x.float(), lp["router"]["kernel"].float()), -1)
        w = probs.gather(-1, pinned)
        return w / w.sum(-1, keepdim=True), pinned
    llm_lib._moe_router = wrapped
    try:
        yield flips
    finally:
        llm_lib._moe_router = router


def check_against_plain(eng, cfg, frames, prompt, bucket, attn, k1,
                        k2, fbank=None, tpm=None, label="bf16") -> None:
    """First-token logits of two videos (with fbank, two audio-visual or,
    frames None, audio-only prompts) through the kernels and through the
    plain attention path (attend swapped for attend_plain), both at full
    width in bf16. The two differ only by rounding inside attention (the
    order of the fp32 sums, exp), which the tower's and the LLM's bf16
    layers amplify. An MoE model's second pass routes every token as the
    first did (moe_routing). Int8 packs take their dequantize branch
    here: under W8A8 that rounding also flips activations' int8 steps from
    layer to layer, which these bounds are not set for (the AV model's W8A8
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
    routes = []
    with moe_routing(llm_lib, routes, replay=False):
        fast = first_logits()
    if (k1.encoder_attention.launches, k2.flash_attention.launches) == before:
        raise RuntimeError("kernel path did not launch the kernels")
    kernel_attend = attn.attend
    attn.attend = lambda q, k, v, valid_len=None, causal=True, window=None, \
        scale=None: attn.attend_plain(q, k, v, valid_len, causal, window,
                                      scale)
    try:
        with moe_routing(llm_lib, routes, replay=True) as flips:
            plain = first_logits()
    finally:
        attn.attend = kernel_attend
    torch.cuda.synchronize()
    if cfg.llm.is_moe:
        log(f"[{label}] the plain path's own top-{cfg.llm.num_experts_per_tok}"
            f" differs from the kernel path's for {flips[0]} of "
            f"{flips[1]} (token, layer) routes; both paths take the kernel "
            f"path's")
    compare_logits(f"{label} first-token logits", fast, plain)


def decode_kernels(k3, dk, bits) -> tuple:
    """(module, wrapper, plain version) names of K3 and the int8 (bits 8)
    K4/K5 or the int4 (bits 4) K6/K7."""
    return ((k3, "decode_attention_layered", "decode_attention_plain"),) \
        + tuple((dk, f"{k}_q{bits}_layered", f"{k}_q{bits}_layered_plain")
                for k in ("matmul", "ffn"))


def decode_launches(k3, dk, bits, run) -> tuple:
    """run()'s result and the launches it added to decode_kernels'
    wrappers: [K3, matmul, FFN]."""
    kernels = [getattr(m, n) for m, n, _ in decode_kernels(k3, dk, bits)]
    before = [k.launches for k in kernels]
    out = run()
    return out, [k.launches - b for k, b in zip(kernels, before)]


@contextlib.contextmanager
def plain_decode_kernels(k3, dk, bits):
    """decode_kernels' wrappers swapped for their plain versions."""
    names = decode_kernels(k3, dk, bits)
    saved = [getattr(m, n) for m, n, _ in names]
    for m, n, plain in names:
        setattr(m, n, getattr(m, plain))
    try:
        yield
    finally:
        for (m, n, _), fn in zip(names, saved):
            setattr(m, n, fn)


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

    fast, added = decode_launches(k3, dk, bits, lambda: decode_logits(cache))
    want = [DECODE_CHECK_STEPS * L, 2 * DECODE_CHECK_STEPS * L,
            DECODE_CHECK_STEPS * L]
    if added != want:
        raise RuntimeError(f"int{bits} decode launches {added} != {want}")
    with plain_decode_kernels(k3, dk, bits):
        plain = decode_logits(snapshot)
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


def check_training_attention(gen, k2, B=TRAIN_B, S=TRAIN_S, H=32, K=8,
                             min_valid=TRAIN_MIN_VALID, tag="") -> dict:
    """K2 with its LSE, K8 and K9 at the training slice's shape (q
    [8, 2048, 32, 128], k/v [8, 2048, 8, 128] bf16, causal, valid_len
    spread over 1400-2048; the "parallel" phase passes a rank's shapes)
    against their plain versions on the fp32 values (the same o and lse
    feed both backward versions), with CUDA-event times, bounds and the
    torch SDPA forward and backward as yardsticks."""
    F = torch.nn.functional
    q = rand_bf16(gen, (B, S, H, 128))
    k, v = rand_bf16(gen, (B, S, K, 128)), rand_bf16(gen, (B, S, K, 128))
    do = rand_bf16(gen, (B, S, H, 128))
    valid = torch.tensor(np.linspace(min_valid, S, B).round(),
                         dtype=torch.int32, device="cuda")
    label = f"{tag}q[{B},{S},{H},128] kv[{B},{S},{K},128] causal, " \
        f"valid_len {valid.tolist()}"
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
                     "library_ms": library_ms, "case": label}

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


@contextlib.contextmanager
def state_saves(record: dict, write: bool):
    """Within: each train_state.save_train_state call appends its step to
    record["save_steps"]; with `write` it writes the state and appends its
    seconds to record["saves"], without it writes nothing (a whole train
    state at full width is ~12 GB, and the machine allows ~45 GiB of disk
    writes a run). The one way this script keeps the Trainer's saves of the
    train state off the disk."""
    from videollama2_tpu_torch.checkpoint import train_state
    save = train_state.save_train_state
    record.setdefault("save_steps", [])
    record.setdefault("saves", [])

    def save_or_record(directory, state, *a, **k):
        record["save_steps"].append(int(state.step))
        if not write:
            return None
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = save(directory, state, *a, **k)
        record["saves"].append(time.perf_counter() - t0)
        return out
    train_state.save_train_state = save_or_record
    try:
        yield record
    finally:
        train_state.save_train_state = save


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
        with state_saves({}, write=False):
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


def write_api_checkpoint(ckpt) -> dict:
    """The api phase's checkpoint in the released 7B-16F layout (LLM depth
    API_LLM_LAYERS, everything else as released), seeded bf16 values made
    on the card, into the directory `ckpt`; returns its size and the
    seconds taken."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        model_config_to_hf

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
    out["write_s"] = time.perf_counter() - t0
    log(f"[api] wrote {len(shapes)} of {len(manifest)} released keys "
        f"(LLM layers 0-{API_LLM_LAYERS - 1} of 32), "
        f"{n_params / 1e9:.3f} B params, {out['checkpoint_gb']:.2f} GB "
        f"bf16 safetensors in {out['write_s']:.1f} s")
    out["tokenizer_write_s"] = write_tokenizer(ckpt, "mistral")
    log(f"[api] wrote the Mistral tokenizer files (32,000 entries, "
        f"tests/tokenizer_writer.py) in {out['tokenizer_write_s']:.2f} s")
    return out


def write_tokenizer(ckpt, family) -> float:
    """tests/tokenizer_writer.py's full-vocabulary files of `family`
    ("mistral", its older serialization, or "qwen2") into the directory
    `ckpt`; returns the seconds taken."""
    import tokenizer_writer
    t0 = time.perf_counter()
    if family == "mistral":
        tokenizer_writer.write_mistral(ckpt)
    else:
        tokenizer_writer.write_qwen2(ckpt)
    return time.perf_counter() - t0


def check_tokenizer_golden(family, path) -> dict:
    """The port's reader (multimodal/hf_tokenizer.py) on the tokenizer
    files in `path` against the committed golden ids of `family`: the ids
    of each golden text with and without the special tokens, the multimodal
    chunk ids, build_prompt_ids of the golden prompts (the chat-templated
    video, audio-visual and text prompts) and decode(encode(text)) ==
    text. Returns the load seconds and the host microseconds an encoded
    prompt takes, cold (the reader's per-word cache empty) and warm."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference import api
    from videollama2_tpu_torch.multimodal import hf_tokenizer
    from videollama2_tpu_torch.multimodal.tokenizer import \
        tokenizer_multimodal_token
    with open(TOKENIZER_GOLDEN, encoding="utf-8") as f:
        golden = json.load(f)["families"][family]
    t0 = time.perf_counter()
    tok = hf_tokenizer.load(path)
    load_s = time.perf_counter() - t0
    cfg = cfglib.tiny_model(golden["model_type"])

    def prompts():
        return [api.build_prompt_ids(p["instruct"], cfg, tok, p["modal"])
                for p in golden["prompts"]]
    t0 = time.perf_counter()  # the first call compiles the chat template
    got_prompts = prompts()
    cold_us = (time.perf_counter() - t0) / len(golden["prompts"]) * 1e6
    t0 = time.perf_counter()
    for _ in range(TOKENIZER_TIMING_ITERS):
        prompts()
    warm_us = ((time.perf_counter() - t0) / TOKENIZER_TIMING_ITERS
               / len(golden["prompts"]) * 1e6)
    texts = golden["texts"]
    checks = {
        "len": (len(tok), golden["len"]),
        "ids": ([tok(t).input_ids for t in texts], golden["ids"]),
        "ids_plain": ([tok(t, add_special_tokens=False).input_ids
                       for t in texts], golden["ids_plain"]),
        "chunks": ([tokenizer_multimodal_token("<video>\nhi there", tok,
                                               "<video>")], golden["chunks"]),
        "prompts": (got_prompts, [p["ids"] for p in golden["prompts"]]),
        "decode(encode(text))": (
            [tok.decode(tok(t, add_special_tokens=False).input_ids)
             for t in texts], texts)}
    bad = [k for k, (got, want) in checks.items() if got != want]
    if bad:
        raise RuntimeError(f"[tokenizer] {family}: the reader differs from "
                           f"the golden ids of `tokenizers` in {bad}")
    out = {"load_s": load_s, "encode_us_cold": cold_us,
           "encode_us_warm": warm_us,
           "prompt_ids": [len(p) for p in got_prompts],
           "golden_texts": len(texts)}
    log(f"[tokenizer] {family}: the reader's ids equal the golden ids of "
        f"`tokenizers` ({len(texts)} texts with and without special "
        f"tokens, {len(got_prompts)} chat-templated prompts of "
        f"{out['prompt_ids']} ids, decode(encode(text)) == text); load "
        f"{load_s:.3f} s, {cold_us:.0f} us an encoded prompt on the first "
        f"call (template compiled, word cache empty), {warm_us:.0f} us "
        f"warm (host)")
    return out


def decode_steps_run(tokens, eos, max_new_tokens, chunk, budget) -> int:
    """The decode steps an Engine.generate of one prompt ran for `tokens`
    (its output, EOS included): none when the prefill's token is EOS, else
    whole decode chunks up to the one holding EOS, capped by
    max_new_tokens and the cache rows after the bucket, `budget`
    (inference/engine.py _decode_tail)."""
    total = min(max_new_tokens - 1, budget)
    if not tokens or tokens[0] == eos:
        return 0
    if eos in tokens:
        return min(-(-tokens.index(eos) // chunk) * chunk, total)
    return total


def run_e2e_script(ckpt, counters) -> tuple:
    """scripts/e2e_smoke_torch.py on the api checkpoint, in this process
    (bf16, the card; bucket 1792 holds the 1,521 video tokens and the
    system prompt, 128 cache rows after it): model_init with no tokenizer,
    the processors on a GIF and a PNG it writes, mm_infer (video, image,
    text, the I420 wire) and mm_infer_batch, each answer the decode of its
    tokens. Its tower and
    prefill must launch K1 and K2 and no packed kernel run (bf16 weights,
    bf16 cache). Returns the seconds and the launch counts."""
    import importlib.util
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", "e2e_smoke_torch.py")
    spec = importlib.util.spec_from_file_location("e2e_smoke_torch", path)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    gc.collect()
    torch.cuda.empty_cache()
    for c in counters.values():
        c.launches = 0
    t0 = time.perf_counter()
    script.main(["--model-path", ckpt, "--max-len", "1920", "--bucket",
                 "1792"])
    torch.cuda.synchronize()
    out = {"s": time.perf_counter() - t0}
    counts = {n: c.launches for n, c in counters.items()}
    on_path = {"encoder_attention", "flash_attention"}
    if not all(counts[n] for n in on_path) or any(
            v for n, v in counts.items() if n not in on_path):
        raise RuntimeError(f"[e2e] launches {counts}: K1 and K2 only")
    log(f"[e2e] scripts/e2e_smoke_torch.py on the api checkpoint (bf16, "
        f"its own tokenizer): {out['s']:.1f} s, launches {counts}")
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def run_own_tokenizer_call(label, ckpt, family, cfg, counters, clip,
                           **init) -> tuple:
    """The reader against the golden ids on the checkpoint's own tokenizer
    files, then model_init(ckpt, **init) with no tokenizer (it reads those
    files; the bucket fits the prompt the reader makes, with 128 cache
    rows after it) and one mm_infer of the I420 `clip`, with exact launch
    counts derived from the tokens it returned (decode_steps_run: the
    seeded model may meet the real EOS id). Its answer must be the decode
    of its tokens. Returns the numbers and the launch counts."""
    from videollama2_tpu_torch.inference import api
    from videollama2_tpu_torch.multimodal import hf_tokenizer
    out = {"golden": check_tokenizer_golden(family, ckpt)}
    question = "What is happening in this video?"
    prompt = api.build_prompt_ids(question, cfg, hf_tokenizer.load(ckpt),
                                  "video")
    bucket = -(-spliced_length_of({"video": prompt},
                                  cfg.tokens_per_video)["video"] // 128) * 128
    budget = 128
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, _, tok = api.model_init(ckpt, buckets=(bucket,),
                                   max_len=bucket + budget, **init)
    torch.cuda.synchronize()
    out["load_s"] = time.perf_counter() - t0
    if not isinstance(tok, hf_tokenizer.HFTokenizer):
        raise RuntimeError(f"[{label}] model_init gave {type(tok)}")
    tokens = []
    for c in counters.values():
        c.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answer = api.mm_infer(clip, question, model, tok,
                          max_new_tokens=NEW_TOKENS,
                          stream_cb=lambda b, t: tokens.__setitem__(
                              slice(None), list(t)))
    torch.cuda.synchronize()
    out["call_s"] = time.perf_counter() - t0
    counts = {n: c.launches for n, c in counters.items()}
    steps = decode_steps_run(tokens, tok.eos_token_id, NEW_TOKENS,
                             model.engine.decode_chunk, budget)
    want = phase_launches(counters, cfg, 1, True, steps, True)
    log(f"[{label}] mm_infer on the checkpoint's own tokenizer: "
        f"{len(prompt)} prompt ids, bucket {bucket}, "
        f"{len(tokens)} tokens (EOS {tok.eos_token_id} "
        f"{'met' if tok.eos_token_id in tokens else 'not met'}), "
        f"{steps} decode steps, launches {counts} (want {want})")
    if counts != want:
        raise RuntimeError(f"[{label}] own tokenizer: kernel launch counts "
                           f"{counts} != {want}")
    if answer != tok.decode(tokens, skip_special_tokens=True).strip():
        raise RuntimeError(f"[{label}] own tokenizer: the answer "
                           f"{answer!r} is not the decode of its tokens")
    out.update(tokens=len(tokens), decode_steps=steps, bucket=bucket,
               prompt_ids=len(prompt), eos_met=tok.eos_token_id in tokens)
    log(f"[{label}] model_init with no tokenizer (the directory's "
        f"{family} files): {out['load_s']:.2f} s; mm_infer "
        f"{out['call_s']:.3f} s; answer {answer[:60]!r}")
    del model
    gc.collect()
    torch.cuda.empty_cache()
    return out, counts


def run_api_phase(ckpt, written, counters, attn, k1, k2, k3, dk):
    """The public API on the released-layout checkpoint that
    write_api_checkpoint wrote into `ckpt` (`written`: its numbers; the
    "lora" phase's model_base later): loads it with
    model_init(load_8bit=True, kv_bits=8), answers one 16-frame I420 clip
    through mm_infer and API_BATCH questions about one shared clip through
    mm_infer_batch (twice: the answers must agree) and chats through
    ChatSession and mm_infer_session (run_chat), each call with exact
    launch counts of every kernel, then holds the first-token and decode
    logits of the loaded model against the plain paths.
    Returns the phase's numbers and the launch counts of each call."""
    from videollama2_tpu_torch.inference import api

    cfg = api_config()
    out = dict(written)
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
    del model, eng
    # the checkpoint's own tokenizer (tests/tokenizer_writer.py's Mistral
    # files, written with it), and the other Mistral serialization's files
    # against the golden ids
    with tempfile.TemporaryDirectory() as newer:
        import tokenizer_writer
        tokenizer_writer.write_mistral(newer, legacy=False)
        out["tokenizer_metaspace"] = check_tokenizer_golden(
            "mistral_metaspace", newer)
    out["own_tokenizer"], counts["mm_infer own tokenizer"] = \
        run_own_tokenizer_call(
            "api", ckpt, "mistral_legacy", cfg, counters, clips[0],
            load_8bit=True, kv_bits=8)
    out["e2e"], counts["e2e_smoke_torch"] = run_e2e_script(ckpt, counters)
    return out, counts


def mixtral_config(layers: int):
    """VideoLLaMA2-8x7B at MIXTRAL_FRAMES frames, the LLM cut to `layers`
    of 32."""
    from videollama2_tpu_torch.core import config as cfglib
    base = cfglib.preset("videollama2_mixtral").replace(
        num_frames=MIXTRAL_FRAMES)
    return base.replace(llm=dataclasses.replace(base.llm, num_layers=layers))


def compare_moe_dispatch(eng, frames, prompt, bucket) -> dict:
    """Layer 0's MoE FFN at full width on its input of the Engine's
    prefill of every row (captured from one prefill), through the dense
    dispatch (the Engine's) and the capacity gather: the pairs the gather
    drops, the tokens all of whose pairs it kept held to the dense output
    within MOE_REL_TOL of max|dense|, and each dispatch's device ms (CUDA
    events)."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.ops.layers import layer_params
    cfg = eng.cfg
    B = frames.shape[0]
    args = _plan_args(cfg, frames, prompt, eng.device, bucket)
    captured, moe = [], llm_lib._ffn_moe

    def first_input(x, lp, c, *plan):
        if not captured:
            captured.append(x.clone())
        return moe(x, lp, c, *plan)
    llm_lib._ffn_moe = first_input
    try:
        cache = llm_lib.init_cache(cfg.llm, B, bucket, torch.bfloat16,
                                   device=eng.device)
        with torch.inference_mode():
            _prefill(eng, cfg, args, cache)
    finally:
        llm_lib._ffn_moe = moe
    del cache
    x = captured[0]
    lp = layer_params(eng.params["llm"]["layers"], 0)
    dense_cfg, gather_cfg = (dataclasses.replace(cfg.llm, moe_dispatch=m)
                             for m in ("dense", "gather"))
    N, k = x.shape[0] * x.shape[1], cfg.llm.num_experts_per_tok
    with torch.inference_mode():
        y_dense = llm_lib._ffn_moe(x, lp, dense_cfg).float().reshape(N, -1)
        y_gather = llm_lib._ffn_moe(x, lp, gather_cfg).float().reshape(N, -1)
        _, topi = llm_lib._moe_router(x.reshape(N, -1), lp, cfg.llm)
        _, keep, C = llm_lib._capacity_slots(topi.reshape(-1), N, gather_cfg)
        kept = keep.reshape(N, k).all(-1)
        load = torch.bincount(topi.reshape(-1), minlength=cfg.llm.num_experts)
        err = (y_gather - y_dense)[kept].abs().max().item()
        scale = y_dense[kept].abs().max().item()
        out = {"tokens": N, "capacity": C,
               "dropped_pairs": int((~keep).sum().item()),
               "tokens_with_a_dropped_pair": int((~kept).sum().item()),
               "expert_load": load.tolist(), "max_abs_err_kept": err,
               "max_abs_dense": scale,
               "dense_ms": cuda_ms(lambda: llm_lib._ffn_moe(x, lp, dense_cfg),
                                   iters=5),
               "gather_ms": cuda_ms(
                   lambda: llm_lib._ffn_moe(x, lp, gather_cfg), iters=5)}
    log(f"[mixtral slice] layer 0's MoE FFN on the prefill's {N} tokens "
        f"(x[{B},{bucket},{x.shape[-1]}]): expert loads {out['expert_load']}"
        f", capacity {C}, {out['dropped_pairs']} pairs dropped by the "
        f"gather ({out['tokens_with_a_dropped_pair']} tokens); gather vs "
        f"dense on the other tokens max abs diff {err:.3e} (bound "
        f"{MOE_REL_TOL * scale:.3e}); dense {out['dense_ms']:.3f} ms, "
        f"gather {out['gather_ms']:.3f} ms (CUDA events)")
    if not err <= MOE_REL_TOL * scale:
        raise RuntimeError(f"mixtral slice: gather vs dense {err} > "
                           f"{MOE_REL_TOL * scale}")
    return out


def run_mixtral_slice(counters, attn, k1, k2) -> tuple:
    """The "mixtral slice": VideoLLaMA2-8x7B (mixtral_config(
    MIXTRAL_LAYERS)) with seeded bf16 weights and a bf16 cache, 16 videos
    at bench.py's prompt, two generate runs of NEW_TOKENS greedy tokens
    (K1 and K2 only: the bf16 decode is plain attention and the MoE
    products are plain PyTorch, as JAX's are einsums; dense dispatch, the
    Engine's), first-token logits against the plain attention, and the
    dense and gather dispatches compared on one layer (compare_moe_dispatch).
    Returns the launch counts and the stage numbers."""
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    cfg = mixtral_config(MIXTRAL_LAYERS)
    B = 16
    frames, prompt, bucket = slice_inputs(cfg, B)
    want = dict.fromkeys(counters, 0)
    want.update(encoder_attention=vit_layers(cfg)
                * (B * cfg.num_frames // 128 or 1),
                flash_attention=MIXTRAL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = synthetic_params(cfg, dtype=torch.bfloat16, device="cuda",
                              seed=0)
    torch.cuda.synchronize()
    log(f"[mixtral slice] videollama2_mixtral at {cfg.num_frames} frames, "
        f"LLM {MIXTRAL_LAYERS} of 32 layers (E {cfg.llm.num_experts}, top-"
        f"{cfg.llm.num_experts_per_tok}, F {cfg.llm.intermediate_size}): "
        f"{cfg.tokens_per_video} visual tokens a video, prompt "
        f"{len(prompt) - 1 + cfg.tokens_per_video} tokens, bucket {bucket}; "
        f"weights made on the card in {time.perf_counter() - t0:.1f} s "
        f"({sum(t.nbytes for t in _leaves(params)) / 1e9:.2f} GB)")
    eng = Engine(cfg, params, dtype=torch.bfloat16,
                 max_len=bucket + NEW_TOKENS, buckets=(bucket,),
                 decode_chunk=NEW_TOKENS, kv_bits=16, device="cuda")
    del params
    if eng.cfg.llm.moe_dispatch != "dense":
        raise RuntimeError("mixtral slice: the Engine did not take the "
                           "dense dispatch")
    counts, stage = run_slice("mixtral slice", eng, cfg, frames, prompt,
                              GenerationConfig(max_new_tokens=NEW_TOKENS),
                              counters, want)
    check_against_plain(eng, eng.cfg, frames[:2], prompt, bucket, attn, k1,
                        k2, label="mixtral")
    stage["moe_ffn"] = compare_moe_dispatch(eng, frames, prompt, bucket)
    stage["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    log(f"[mixtral slice] first token "
        f"{stage['encode_prefill_first_token_s']:.3f} s, decode "
        f"{stage['decode_ms_per_token']:.2f} ms/token, peak "
        f"device memory {stage['peak_gb']:.1f} GB")
    return counts, stage


def write_mixtral_api_checkpoint(ckpt) -> dict:
    """A checkpoint in the released VideoLLaMA2-8x7B key layout: the 7B-16F
    manifest's keys (Mixtral's attention, embedding, head, tower and
    projector have their shapes) with each layer's mlp keys replaced by
    block_sparse_moe.gate.weight [E, D] and experts.{e}.w1/w3 [F, D], w2
    [D, F], the LLM cut to MIXTRAL_API_LAYERS layers, config.json with
    num_local_experts; seeded bf16 values made on the card. Returns its
    size and the seconds taken."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        model_config_to_hf
    cfg = mixtral_config(MIXTRAL_API_LAYERS)
    E, D, F_ = (cfg.llm.num_experts, cfg.llm.hidden_size,
                cfg.llm.intermediate_size)
    with open(MANIFEST) as f:
        manifest = json.load(f)
    shapes = {}
    for key, shape in manifest.items():
        m = re.match(r"model\.layers\.(\d+)\.(.*)", key)
        if m is None:
            shapes[key] = shape
        elif int(m.group(1)) < MIXTRAL_API_LAYERS:
            if not m.group(2).startswith("mlp."):
                shapes[key] = shape
            elif m.group(2) == "mlp.gate_proj.weight":
                moe = f"model.layers.{m.group(1)}.block_sparse_moe."
                shapes[moe + "gate.weight"] = [E, D]
                for e in range(E):
                    shapes.update({moe + f"experts.{e}.w1.weight": [F_, D],
                                   moe + f"experts.{e}.w2.weight": [D, F_],
                                   moe + f"experts.{e}.w3.weight": [F_, D]})
    hf = model_config_to_hf(cfg)
    if hf.get("num_local_experts") != E:
        raise RuntimeError(f"mixtral api: config.json {hf}")
    t0 = time.perf_counter()
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(hf, f)
    gen = torch.Generator(device="cuda").manual_seed(0)
    write_safetensors(os.path.join(ckpt, "model.safetensors"), shapes,
                      lambda n, s: api_init(n, s, gen))
    out = {"checkpoint_gb": os.path.getsize(
        os.path.join(ckpt, "model.safetensors")) / 1e9,
        "write_s": time.perf_counter() - t0,
        "params_b": sum(math.prod(s) for s in shapes.values()) / 1e9}
    log(f"[mixtral api] wrote {len(shapes)} keys in the released 8x7B "
        f"layout (LLM layers 0-{MIXTRAL_API_LAYERS - 1} of 32, {E} experts "
        f"a layer), {out['params_b']:.3f} B params, "
        f"{out['checkpoint_gb']:.2f} GB bf16 safetensors in "
        f"{out['write_s']:.1f} s")
    return out


def run_mixtral_api_phase(counters, attn, k1, k2) -> tuple:
    """The "mixtral api" phase: write_mixtral_api_checkpoint into a
    temporary directory, model_init (bf16) on it, one 8-frame I420 clip
    answered through mm_infer (the mistral/mixtral <<SYS>> prompt) with
    exact launch counts, first-token logits of two clips against the plain
    attention, and model_init(load_8bit=True) and (load_4bit=True) on it
    raising NotImplementedError naming MoE. Returns the phase's numbers
    and the mm_infer call's launch counts."""
    from videollama2_tpu_torch.inference import api
    cfg = mixtral_config(MIXTRAL_API_LAYERS)
    tok = ToyTokenizer(cfg.llm.vocab_size)
    question = "what happens in the video ?"
    prompt = api.build_prompt_ids(question, cfg, tok, "video")
    bucket = -(-(len(prompt) - 1 + cfg.tokens_per_video) // 128) * 128
    with tempfile.TemporaryDirectory() as ckpt:
        out = write_mixtral_api_checkpoint(ckpt)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        model, _, tok = api.model_init(
            ckpt, max_len=bucket + NEW_TOKENS, buckets=(bucket,),
            tokenizer=tok)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        out["load_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        log(f"[mixtral api] model_init (bf16): {out['load_s']:.2f} s, peak "
            f"device memory {out['load_peak_gb']:.2f} GB; prompt "
            f"{len(prompt) - 1 + cfg.tokens_per_video} tokens, bucket "
            f"{bucket}")
        if dataclasses.asdict(model.config) != dataclasses.asdict(cfg):
            raise RuntimeError(f"mixtral api: loaded config {model.config} "
                               f"!= {cfg}")
        eng = model.engine
        if eng.cfg.llm.moe_dispatch != "dense" or eng.kv_bits != 16:
            raise RuntimeError("mixtral api: not the bf16 dense-dispatch "
                               "Engine")
        H = cfg.vision.image_size
        clips = np.random.default_rng(3).integers(
            0, 256, (2, cfg.num_frames, H + H // 2, H), dtype=np.uint8)
        want = phase_launches(counters, cfg, 1, True, NEW_TOKENS - 1, False)
        answer, out["mm_infer"], counts = counted_call(
            "mixtral api mm_infer", counters, want,
            lambda cb: api.mm_infer(clips[0], question, model, tok,
                                    max_new_tokens=NEW_TOKENS, stream_cb=cb))
        if not (isinstance(answer, str) and answer):
            raise RuntimeError(f"mixtral api: answer {answer!r}")
        log(f"[mixtral api] mm_infer answer: {answer[:60]!r}...")
        check_against_plain(eng, eng.cfg, clips, prompt, bucket, attn, k1,
                            k2, label="mixtral api")
        out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        del model, eng
        gc.collect()
        torch.cuda.empty_cache()
        for flag in ("load_8bit", "load_4bit"):
            try:
                api.model_init(ckpt, tokenizer=tok, **{flag: True})
            except NotImplementedError as e:
                if "MoE" not in str(e):
                    raise
                log(f"[mixtral api] model_init({flag}=True) refused: {e}")
            else:
                raise RuntimeError(f"mixtral api: model_init({flag}=True) "
                                   "loaded an MoE checkpoint")
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


def verify_logits(eng, cfg, frames, prompt, bucket, record, firsts,
                  prompts=None) -> dict:
    """The verify path's logits behind token firsts[b] of row b in two
    arithmetics: "weight_only" (w8a8 False, the weight-only int8 or int4
    arithmetic of the decode kernels) and "w8a8_reference" (w8a8 True with
    every packed dense through w8a8_reference, an int4 pack's nibbles
    unpacked to its int8 plane first). The prompt is prefilled once into
    a fresh cache for frames' B rows (or, with frames None, the text-only
    `prompts`, one a row, as the Engine's text mode prefills them); each
    mode replays, on its own copy of that cache, the verify passes of
    `record` (a LogitTap record of a speculative run) with their
    embeddings and per-row frontiers, and takes token p from the pass and
    slot that logits_at takes it from in the record. Lockstep passes from other frontiers
    would write the cache from other passes, which at full width alone
    moves a logit by about 0.4 std. Returns {mode: {row: logits}}."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.ops import layers
    from videollama2_tpu_torch.ops.quant import unpack_int4
    args = _plan_args(cfg, frames, prompt, eng.device, bucket,
                      prompts=prompts)
    params = eng.params["llm"]
    prefilled = llm_lib.init_cache(cfg.llm, args[1].shape[0], eng.max_len,
                                   eng.dtype, kv_bits=eng.kv_bits,
                                   device=eng.device)
    out = {}
    with torch.inference_mode():
        if frames is None:
            llm_lib.prefill(params, cfg.llm, llm_lib.embed_tokens(
                params, args[1], eng.dtype), args[4], args[5], prefilled,
                w8a8=True)
        else:
            vl2.prefill_multimodal(eng.params, cfg, *args, prefilled,
                                   w8a8=True)
        for mode in ("weight_only", "w8a8_reference"):
            cache = dataclasses.replace(prefilled, **{
                f.name: getattr(prefilled, f.name).clone()
                for f in dataclasses.fields(prefilled)
                if getattr(prefilled, f.name) is not None})
            saved = layers.dense_w8a8, layers.dense_w4a8
            if mode == "w8a8_reference":
                layers.dense_w8a8 = w8a8_reference
                layers.dense_w4a8 = lambda x, pack: w8a8_reference(
                    x, {"q": unpack_int4(pack["q4"]), "scale": pack["scale"]})
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
                layers.dense_w8a8, layers.dense_w4a8 = saved
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


def api_av_config():
    """The api AV calls' model: VideoLLaMA2.1-AV-16F with the LLM cut to
    API_LLM_LAYERS of 28 layers."""
    from videollama2_tpu_torch.core import config as cfglib
    base = cfglib.preset("videollama2_qwen2_av").replace(num_frames=16)
    return base.replace(llm=dataclasses.replace(base.llm,
                                               num_layers=API_LLM_LAYERS))


def write_api_av_checkpoint(ckpt) -> dict:
    """A checkpoint with every key of the released VideoLLaMA2.1-AV layout
    (LLM depth API_LLM_LAYERS of 28), seeded bf16 values made on the card,
    into the directory `ckpt`; returns its size and the seconds taken."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        model_config_to_hf

    cfg = api_av_config()
    with open(MANIFEST_AV) as f:
        manifest = json.load(f)
    shapes = {k: s for k, s in manifest.items()
              if not re.match(r"model\.layers\.(\d+)\.", k)
              or int(k.split(".")[2]) < API_LLM_LAYERS}
    n_params = sum(math.prod(s) for s in shapes.values())
    out = {}
    t0 = time.perf_counter()
    with open(os.path.join(ckpt, "config.json"), "w") as f:
        json.dump(dict(model_config_to_hf(cfg),
                       mm_audio_tower="BEATs_iter3_plus_AS2M"), f)
    gen = torch.Generator(device="cuda").manual_seed(0)
    weights = os.path.join(ckpt, "model.safetensors")
    write_safetensors(weights, shapes, lambda n, s: api_init(n, s, gen))
    out["checkpoint_gb"] = os.path.getsize(weights) / 1e9
    out["write_s"] = time.perf_counter() - t0
    log(f"[api av] wrote {len(shapes)} of {len(manifest)} released "
        f"VideoLLaMA2.1-AV keys (LLM layers 0-{API_LLM_LAYERS - 1} of "
        f"28), {n_params / 1e9:.3f} B params, "
        f"{out['checkpoint_gb']:.2f} GB bf16 safetensors in "
        f"{out['write_s']:.1f} s")
    out["tokenizer_write_s"] = write_tokenizer(ckpt, "qwen2")
    log(f"[api av] wrote the Qwen2 tokenizer files (151,643 BPE entries "
        f"and 3 added tokens, tests/tokenizer_writer.py) in "
        f"{out['tokenizer_write_s']:.2f} s")
    return out


def run_api_av_phase(ckpt_dir, written, counters, attn, k1, k2, k3, dk):
    """The public API on the audio-visual model: on the checkpoint that
    write_api_av_checkpoint wrote into `ckpt_dir` (`written`: its
    numbers), writes a 44.1 kHz stereo .wav, loads the checkpoint with
    model_init(load_8bit=True, kv_bits=8) and answers through
    mm_infer(modal="audio") on the .wav, mm_infer(modal="av") on
    {"video": frames, "audio": the .wav}, and two mm_infer_session AV
    calls through one SessionStore (a miss, then a hit whose tokens must
    equal stateless mm_infer's, or differ first at a near-tie), each call
    with exact launch counts; then holds the loaded model's audio-visual
    first-token and decode logits against the plain paths. Returns the
    phase's numbers and the launch counts of each call."""
    from videollama2_tpu_torch.inference import api

    cfg = api_av_config()
    out, counts = dict(written), {}
    with contextlib.nullcontext(ckpt_dir) as ckpt:
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
    out["own_tokenizer"], counts["mm_infer own tokenizer"] = \
        run_own_tokenizer_call(
            "api av", ckpt_dir, "qwen2", cfg, counters, clips[0],
            load_8bit=True, kv_bits=8)
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


def calls_launches(counters, cfg, calls, packed=True) -> dict:
    """Launch counts of recorded generate calls: the tower over each
    call's distinct media (one frame a row in image mode), one prefill
    each, and, on the int8 slice's packs, K3-K5 for each decode step
    (bf16 weights decode on the plain attention: no decode kernel)."""
    L = cfg.llm.num_layers
    want = dict.fromkeys(counters, 0)
    for c in calls:
        if c["media"] is not None:
            frames = c["media"] * (1 if c["image_mode"] else cfg.num_frames)
            want["encoder_attention"] += vit_layers(cfg) * tower_passes(
                cfg, frames)
        want["flash_attention"] += L
        if not packed:
            continue
        steps = len(c["outs"][0]) - 1
        want["decode_attention"] += steps * L
        want["matmul_q8_layered"] += 2 * steps * L
        want["ffn_q8_layered"] += steps * L
    return want


IMAGE_FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures", "torch_images")


def check_image_fixtures() -> tuple:
    """Decode every file of tests/fixtures/torch_images/ with the port's
    reader (its C++ helpers as g++ built them on this host) and hold the
    pixels' shape and SHA-256 to golden.json, PIL's pixels on the CPU
    host. Returns name -> bytes and name -> pixels."""
    import hashlib
    from videollama2_tpu_torch.media import image_io
    with open(os.path.join(IMAGE_FIXTURES, "golden.json")) as f:
        golden = json.load(f)
    files, pixels = {}, {}
    for name, want in sorted(golden.items()):
        with open(os.path.join(IMAGE_FIXTURES, name), "rb") as f:
            data = f.read()
        rgb = image_io.read_image(data)
        got = {"shape": list(rgb.shape), "sha256": hashlib.sha256(
            np.ascontiguousarray(rgb).tobytes()).hexdigest()}
        if got != want:
            raise RuntimeError(f"images: {name} decodes to {got}, its "
                               f"golden digest is {want}")
        files[name], pixels[name] = data, rgb
    log(f"[images] {len(golden)} fixtures ({', '.join(sorted(golden))}) "
        "decode to their golden digests (PIL's pixels)")
    return files, pixels


def run_still_images(rng, processors, root, smi) -> tuple:
    """The still-image formats on the host: the fixtures against their
    golden digests; the host ms (median of 5) to decode a 480x640 and a
    1920x1080 progressive JPEG against baseline files of the same pixels,
    an Adam7 PNG against a plain one, the lossy 1920x1080 and lossless
    480x640 WebP fixtures, and 480x640 TIFFs (LZW with predictor 2,
    Deflate, uncompressed); a 16-frame 480x640 directory of progressive
    JPEG, Adam7 PNG, lossless WebP and LZW TIFF frames through the
    processors. Returns the numbers, the fixtures' bytes and their
    pixels."""
    from jpeg_writer import PROGRESSIVE, encode_jpeg
    from png_writer import encode_png
    from tiff_writer import encode_tiff
    from videollama2_tpu_torch.media import image_io, video_reader

    files, pixels = check_image_fixtures()
    photo = pixels["progressive_480x640.jpg"]
    big = smooth_frames(rng, 1, 1080, 1920)[0]
    still = smooth_frames(rng, 1, 480, 640)[0]
    samples = {
        "progressive JPEG 480x640 (PIL's script)":
            files["progressive_480x640.jpg"],
        "baseline JPEG 480x640": encode_jpeg(photo, 85, "4:2:0"),
        "progressive JPEG 1920x1080 (libjpeg's script)": encode_jpeg(
            big, 85, "4:2:0", script=PROGRESSIVE),
        "baseline JPEG 1920x1080": encode_jpeg(big, 85, "4:2:0"),
        "Adam7 PNG 480x640": encode_png(still, interlace=True),
        "PNG 480x640": encode_png(still),
        "lossy WebP 1920x1080": files["lossy_1920x1080.webp"],
        "lossless WebP 480x640": files["lossless_480x640.webp"],
        "LZW TIFF 480x640 (predictor 2)": encode_tiff(
            still, photometric=2, compression=5, predictor=2,
            rows_per_strip=16),
        "Deflate TIFF 480x640": encode_tiff(still, photometric=2,
                                            compression=8,
                                            rows_per_strip=16),
        "TIFF 480x640": encode_tiff(still, photometric=2),
    }
    decode_ms = {}
    for label, data in samples.items():
        runs = []
        for _ in range(5):
            t0 = time.perf_counter()
            image_io.read_image(data)
            runs.append((time.perf_counter() - t0) * 1e3)
        decode_ms[label] = statistics.median(runs)
    log(f"[images] ({smi}) host ms to decode (median of 5): " + ", ".join(
        f"{k} {v:.1f}" for k, v in decode_ms.items()))
    # frames 4k progressive JPEG, 4k + 1 Adam7 PNG, 4k + 2 the lossless
    # WebP fixture, 4k + 3 LZW TIFF (predictor 2)
    clip = smooth_frames(rng, 16, 480, 640)
    clip[2::4] = pixels["lossless_480x640.webp"]
    clip_dir = os.path.join(root, "stills_clip")
    os.makedirs(clip_dir)
    for i, frame in enumerate(clip):
        with open(os.path.join(clip_dir, f"{i:03d}.img"), "wb") as f:
            f.write((encode_jpeg(frame, 85, "4:2:0", script=PROGRESSIVE),
                     encode_png(frame, interlace=True),
                     files["lossless_480x640.webp"],
                     encode_tiff(frame, photometric=2, compression=5,
                                 predictor=2, rows_per_strip=16))[i % 4])
    decoded = np.stack(video_reader.read_video_frames(clip_dir, 16))
    err = np.abs(decoded[::4].astype(int) - clip[::4]).mean()
    lossless = [i for i in range(16) if i % 4]
    if not np.array_equal(decoded[lossless], clip[lossless]) or err > 12:
        raise RuntimeError("images: the progressive JPEG / Adam7 PNG / WebP "
                           "/ TIFF directory did not decode to its frames "
                           f"(JPEG mean error {err:.2f})")
    S = processors["rgb"]["image"](photo).shape[1]
    frame_dir_ms = {}
    for wire in ("rgb", "i420"):
        for _ in range(2):
            t0 = time.perf_counter()
            video = processors[wire]["video"](clip_dir)
            frame_dir_ms[f"video {wire} ms"] = (time.perf_counter()
                                                - t0) * 1e3
        shape = (16, S, S, 3) if wire == "rgb" else (16, S * 3 // 2, S)
        if video.shape != shape or video.dtype != np.uint8:
            raise RuntimeError(f"images: processor shape {video.shape} on "
                               f"the {wire} wire")
    log(f"[images] ({smi}) processors on a 16-frame 480x640 directory (4 "
        "progressive JPEG, 4 Adam7 PNG, 4 lossless WebP, 4 LZW TIFF; JPEG "
        f"frames within {err:.2f} levels of their source, the others "
        "equal): " + ", ".join(
            f"{k} {v:.1f}" for k, v in frame_dir_ms.items()))
    return ({"decode_ms": decode_ms, "frame_dir_host_ms": frame_dir_ms},
            files, pixels)


def run_serve_phase(eng, cfg, counters, smi) -> tuple:
    """The "serve" phase on the int8 slice's Engine (VideoLLaMA2-7B-16F,
    int8 packs, W8A8 prefill, int8 KV cache) with a word-level toy
    tokenizer: the processors on a 16-frame 480x640 directory (PNG and
    BMP frames) and a 480x640 PNG; the still-image formats
    (run_still_images); a controller and a model worker on localhost
    streaming a video, a PNG image, a progressive JPEG image and a lossy
    WebP image request through the proxy, each with exact launch counts
    and the tokens of a direct Engine.generate on the same processed frames
    (the JPEG's and the WebP's digest-checked pixels); 16 concurrent video
    requests over 4 distinct videos plus 2 text requests on a worker with
    dynamic batching against the same 18 on the plain worker (answers held
    to B = 1 up to near-ties, the tower run once a distinct video of a
    group, requests/s and the batcher's stats); four chat completions of
    the OpenAI-compatible server (the progressive JPEG and the WebP data
    URLs' held to a direct generate too); the container paths. Returns the
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
        out["still_images"], fixture_files, fixture_pixels = \
            run_still_images(rng, processors, root.name, smi)
        prog = "progressive_480x640.jpg"
        b64_prog = base64.b64encode(fixture_files[prog]).decode()
        # the digest-checked pixels, as the worker processes them
        prog_i420 = processors["i420"]["image"](fixture_pixels[prog])
        webp = "lossy_1920x1080.webp"
        b64_webp = base64.b64encode(fixture_files[webp]).decode()
        webp_i420 = processors["i420"]["image"](fixture_pixels[webp])

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
                ("image", {"images": [b64_image]}, image_i420, "image"),
                ("progressive JPEG image", {"images": [b64_prog]},
                 prog_i420, "image"),
                ("WebP image", {"images": [b64_webp]}, webp_i420,
                 "image")):
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
        prog_url = "data:image/jpeg;base64," + b64_prog
        webp_url = "data:image/webp;base64," + b64_webp
        sent = {"image": "data-URL PNG", "video": "video path",
                "progressive JPEG image": "data-URL progressive JPEG",
                "WebP image": "data-URL lossy 1920x1080 WebP"}
        checked = ("progressive JPEG image", "WebP image")
        for kind, part, tensor, modal in (
                ("image", {"type": "image_url",
                           "image_url": {"url": data_url}},
                 image_i420, "image"),
                ("video", {"type": "video_url",
                           "video_url": {"url": clip_dir}},
                 video_i420, "video"),
                ("progressive JPEG image", {
                    "type": "image_url", "image_url": {"url": prog_url}},
                 prog_i420, "image"),
                ("WebP image", {
                    "type": "image_url", "image_url": {"url": webp_url}},
                 webp_i420, "image")):
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
            if kind in checked:
                direct = eng.generate(
                    [call["ids"][0]], frames=np.broadcast_to(
                        tensor[None], (1, cfg.num_frames) + tensor.shape[1:]),
                    gen=GenerationConfig(max_new_tokens=NEW_TOKENS),
                    eos_token_id=-1, image_mode=True)[0]
                if call["outs"][0] != direct:
                    raise RuntimeError(f"serve openai {kind}: the tokens "
                                       "differ from a direct "
                                       "Engine.generate")
            counts[f"serve openai {kind}"] = got
            out[f"openai_{kind}_s"] = took
            log(f"[serve] ({smi}) OpenAI chat completion with a "
                f"{sent[kind]}: {took:.3f} s, launches {got}"
                + ("; tokens equal a direct Engine.generate"
                   if kind in checked else ""))

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


# -- the "train entry" phase: train/train.py as the recipes launch it ---------

TE_STEPS = 4            # stage 1: SIGTERM during step 2
# 2.1 stage 1: two epochs of one step (PRE_ONE_STEP), a save every step
TE_QWEN2_STEPS = 2
# the recipes' microbatches at accumulation 2: pretrain.sh 8 a device
# (stage 1 and 2.1), finetune.sh and the custom scripts 4
TE_MB, TE_ACCUM = 8, 2
TE_FT_MB, TE_FT_ACCUM = 4, 2
TE_PRE_SAMPLES = TE_STEPS * TE_MB * TE_ACCUM   # one epoch of TE_STEPS
# stage 2: 22 media samples and 2 text-only ones; grouped by modality, an
# epoch is the full batches of each: 2 steps of TE_FT_MB x TE_FT_ACCUM
TE_SFT_MEDIA, TE_SFT_TEXT = 22, 2
# LoRA, QLoRA: one step of the custom scripts' 4 x 4 over custom.json,
# each beside a plain stage-1 run (41.5 GB) on the card
CUSTOM_MB, CUSTOM_ACCUM = 4, 4
CUSTOM_SAMPLES = CUSTOM_MB * CUSTOM_ACCUM
PRE_ANNOTATIONS = os.path.join("annotations", "valley_llavaimage.json")
PRE_ONE_STEP = os.path.join("annotations", "pretrain_one_step.json")
SFT_ANNOTATIONS = os.path.join("annotations",
                               "videochatgpt_llavaimage_tune.json")
TE_LOSS_RTOL = 1e-6     # resumed vs uninterrupted losses (bit-equal seen)
TE_TIMEOUT = 600
TE_WORDS = ("the a cat dog man woman car ball runs jumps walks sits opens "
            "holds red blue small large slowly quickly near behind on in "
            "kitchen street park table door window hand head camera scene "
            "then while after video shows person object moves turns").split()

# a child process: runs videollama2_tpu_torch.train.train as `python -m`
# does (runpy, the module as __main__, the flags in sys.argv) under
# TrainRecorder and writes its report
TE_RUNNER = r"""
import runpy, sys
import chip_smoke as cs
report_path, write_state = sys.argv[1], sys.argv[2] == "save"
sys.argv = ["videollama2_tpu_torch.train.train"] + sys.argv[3:]
rec = cs.TrainRecorder(write_state)
runpy.run_module("videollama2_tpu_torch.train.train", run_name="__main__",
                 alter_sys=True)
rec.write(report_path)
"""


class TrainRecorder:
    """Instruments train/train.py in this process before it runs (a
    TE_RUNNER child, or a launch script's torchrun worker through
    LAUNCH_SITECUSTOMIZE) and writes a JSON report: every kernel's
    launches, each step's device time (and its forward, backward and
    optimizer parts), loss and tokens, the state's bit checksums when it is
    first stepped (after a restore), after each step and at the end, the
    trainable paths, the steps the train state was saved at (written only
    with write_state: state_saves), the save and restore times, the peak
    device memory and the host clock at the first step. The matmuls run
    without TF32 and cuDNN deterministically, so that runs in different
    processes are bit-comparable."""

    def __init__(self, write_state: bool):
        from videollama2_tpu_torch.checkpoint import train_state
        from videollama2_tpu_torch.train import optimizer as opt_lib
        from videollama2_tpu_torch.train import step as step_lib
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        self.counters = kernel_counters()
        rep = self.rep = {"steps": [], "after_step": {}, "restores": []}
        held = self.held = {}
        parts = {}

        def timed_part(fn, key):
            def run(*a, **k):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*a, **k)
                torch.cuda.synchronize()
                parts[key] = parts.get(key, 0.0) + time.perf_counter() - t0
                return out
            return run
        step_lib.loss_fn = timed_part(step_lib.loss_fn, "forward_s")
        opt_lib.GroupedAdamW.step = timed_part(opt_lib.GroupedAdamW.step,
                                               "optimizer_s")
        make = step_lib.make_train_step

        def make_timed(cfg, tx, trainable, grad_accum=1, **mesh):
            inner = make(cfg, tx, trainable, grad_accum=grad_accum, **mesh)
            rep["trained"] = sorted("/".join(p) for p, t in trainable.items()
                                    if t)

            def step(state, batch):
                if "first" not in rep:
                    rep["first"] = state_checksums(state)
                    rep["first_step_at_s"] = time.perf_counter() \
                        - self.t_start
                    rep["first_step_wall"] = time.time()
                parts.clear()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                state, metrics = inner(state, batch)
                torch.cuda.synchronize()
                s = time.perf_counter() - t0
                rep["steps"].append({
                    "step": state.step, "s": s,
                    "loss": float(metrics["loss"]),
                    "num_tokens": int(metrics["num_tokens"]),
                    "valid_tokens": int(batch.valid_len.sum()),
                    "forward_s": parts["forward_s"],
                    "optimizer_s": parts["optimizer_s"],
                    "backward_s": s - parts["forward_s"]
                    - parts["optimizer_s"]})
                rep["after_step"][str(state.step)] = state_checksums(state)
                held["state"] = state
                return state, metrics
            return step
        step_lib.make_train_step = make_timed
        restore = train_state.restore_train_state

        def timed_restore(*a, **k):
            t0 = time.perf_counter()
            out = restore(*a, **k)
            torch.cuda.synchronize()
            rep["restores"].append(time.perf_counter() - t0)
            return out
        train_state.restore_train_state = timed_restore
        for fn in self.counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        self._saves = state_saves(rep, write_state)
        self._saves.__enter__()
        self.t_start = time.perf_counter()

    def write(self, path: str) -> None:
        rep = self.rep
        self._saves.__exit__(None, None, None)
        rep["wall_s"] = time.perf_counter() - self.t_start
        rep["launches"] = {n: fn.launches for n, fn in self.counters.items()}
        rep["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        if "state" in self.held:
            rep["final"] = state_checksums(self.held["state"])
        rep["device"] = torch.cuda.get_device_name(0)
        with open(path, "w") as f:
            json.dump(rep, f)


def kernel_counters() -> dict:
    """Every kernel wrapper by its counter's name (main's `counters`)."""
    from videollama2_tpu_torch.ops import decode_attention as k3
    from videollama2_tpu_torch.ops import decode_matmul as dk
    from videollama2_tpu_torch.ops import encoder_attention as k1
    from videollama2_tpu_torch.ops import flash_attention as k2
    from videollama2_tpu_torch.ops import quant_matmul as qm
    return {"encoder_attention": k1.encoder_attention,
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


def state_checksums(state) -> dict:
    """Bit checksums of a TrainState's params, fp32 masters and Adam
    moments by path."""
    from videollama2_tpu_torch.train.optimizer import flatten
    out = {}
    for kind, tree in (("params", flatten(state.params)),
                       ("master", state.opt_state["master"]),
                       ("mu", state.opt_state["mu"]),
                       ("nu", state.opt_state["nu"])):
        paths = list(tree)
        for p, c in zip(paths, _checksums([tree[p] for p in paths])):
            out[f"{kind}:{'/'.join(p)}"] = c
    return out


def toy_tokenizer(model_path):
    """The --tokenizer factory of the 2.1 stage-1 run: ToyTokenizer at the
    vocabulary of the model directory's config.json."""
    with open(os.path.join(model_path, "config.json")) as f:
        return ToyTokenizer(json.load(f)["vocab_size"])


def _caption(rng, n) -> str:
    return " ".join(TE_WORDS[i] for i in rng.integers(0, len(TE_WORDS), n))


def write_train_corpus(root) -> dict:
    """The phase's corpus in the reference's annotation format, written with
    the test writers: 16-frame 480x640 frame directories of JPEG (4:2:0)
    and of PNG files, 16-frame 240x320 GIF videos, 480x640 JPEG (4:2:0 and
    4:4:4) and PNG images; under the names the launch scripts read,
    annotations/valley_llavaimage.json (pretrain: TE_PRE_SAMPLES samples
    of one human/gpt round, a caption of 24-60 words),
    annotations/videochatgpt_llavaimage_tune.json (one to three rounds,
    plus two text-only samples) and custom.json (its first CUSTOM_SAMPLES
    samples, the LoRA and QLoRA scripts'); PRE_ONE_STEP holds the first
    TE_MB x TE_ACCUM pretrain samples (the 2.1 run's). Returns the media
    counts and the seconds taken."""
    from gif_writer import encode_rgb_gif
    from jpeg_writer import encode_jpeg
    from png_writer import encode_png
    t0 = time.perf_counter()
    rng = np.random.default_rng(3)
    media = []
    for i, fmt in enumerate(("jpg", "jpg", "png", "png")):
        d = os.path.join(root, "media", f"v{i}")
        os.makedirs(d)
        for t, px in enumerate(smooth_frames(rng, 16, 480, 640)):
            with open(os.path.join(d, f"{t:03d}.{fmt}"), "wb") as f:
                f.write(encode_jpeg(px, 85, "4:2:0") if fmt == "jpg"
                        else encode_png(px))
        media.append(("video", f"media/v{i}"))
    for i in range(3):
        with open(os.path.join(root, "media", f"g{i}.gif"), "wb") as f:
            f.write(encode_rgb_gif(smooth_frames(rng, 16, 240, 320)))
        media.append(("video", f"media/g{i}.gif"))
    for i, (ext, data) in enumerate((
            ("jpg", lambda px: encode_jpeg(px, 90, "4:2:0")),
            ("jpg", lambda px: encode_jpeg(px, 75, "4:4:4")),
            ("png", encode_png), ("png", encode_png))):
        with open(os.path.join(root, "media", f"i{i}.{ext}"), "wb") as f:
            f.write(data(smooth_frames(rng, 1, 480, 640)[0]))
        media.append(("image", f"media/i{i}.{ext}"))

    def sample(kind, path, rounds):
        conv = []
        for r in range(rounds):
            q = (f"<{kind}>\n" if kind and r == 0 else "") + \
                _caption(rng, int(rng.integers(6, 14))) + " ?"
            conv += [{"from": "human", "value": q},
                     {"from": "gpt",
                      "value": _caption(rng, int(rng.integers(24, 60)))}]
        out = {"conversations": conv}
        if kind:
            out[kind] = path
        return out
    pre = [sample(*media[i % len(media)], 1) for i in range(TE_PRE_SAMPLES)]
    sft = [sample(*media[i % len(media)], 1 + i % 3)
           for i in range(TE_SFT_MEDIA)]
    sft += [sample(None, None, 1 + i) for i in range(TE_SFT_TEXT)]
    os.makedirs(os.path.join(root, "annotations"))
    for name, annos in ((PRE_ANNOTATIONS, pre), (SFT_ANNOTATIONS, sft),
                        (PRE_ONE_STEP, pre[:TE_MB * TE_ACCUM]),
                        ("custom.json", sft[:CUSTOM_SAMPLES])):
        with open(os.path.join(root, name), "w") as f:
            json.dump(annos, f)
    return {"videos": 7, "images": 4, "pre_samples": len(pre),
            "sft_samples": len(sft), "write_s": time.perf_counter() - t0}


def _hf_llm_config(cfg, layers: int) -> dict:
    """A plain MistralForCausalLM / Qwen2ForCausalLM config.json of the
    preset's LLM at `layers` layers."""
    from videollama2_tpu_torch.checkpoint.convert_hf import \
        model_config_to_hf
    hf = {k: v for k, v in model_config_to_hf(cfg).items()
          if not k.startswith(("mm_", "tiny")) and k != "num_frames"}
    kind = cfg.llm.model_type
    hf.update(model_type=kind, num_hidden_layers=layers, architectures=[
        {"mistral": "MistralForCausalLM", "qwen2": "Qwen2ForCausalLM"}[kind]])
    return hf


def _hf_tower_config(vision) -> dict:
    return {"model_type": f"{vision.variant}_vision_model",
            "hidden_size": vision.hidden_size,
            "intermediate_size": vision.intermediate_size,
            "num_hidden_layers": vision.num_layers,
            "num_attention_heads": vision.num_heads,
            "image_size": vision.image_size,
            "patch_size": vision.patch_size,
            "hidden_act": vision.hidden_act,
            "layer_norm_eps": vision.layer_norm_eps}


def write_plain_dirs(root, cfg, ckpt) -> tuple:
    """From a released-layout checkpoint directory `ckpt` (the api phase's,
    LLM cut to API_LLM_LAYERS layers): a plain LLM directory (a plain
    Mistral / Qwen2 config.json beside the checkpoint's weights file, hard
    linked: the loader reads the LLM's keys, model.* and lm_head.weight,
    and leaves the rest) and the tower's HF directory (its config.json and
    the checkpoint's tower tensors as vision_model.*, written)."""
    from videollama2_tpu_torch.checkpoint.convert_hf import read_safetensors
    prefix = "model.vision_tower.vision_tower."
    llm_dir, tower_dir = (os.path.join(root, "llm"),
                          os.path.join(root, "tower"))
    os.makedirs(llm_dir)
    os.makedirs(tower_dir)
    weights = os.path.join(ckpt, "model.safetensors")
    try:
        os.link(weights, os.path.join(llm_dir, "model.safetensors"))
    except OSError:
        os.symlink(weights, os.path.join(llm_dir, "model.safetensors"))
    with open(os.path.join(llm_dir, "config.json"), "w") as f:
        json.dump(_hf_llm_config(cfg, API_LLM_LAYERS), f)
    for name in TOKENIZER_FILES:  # the checkpoint's tokenizer
        shutil.copy(os.path.join(ckpt, name), os.path.join(llm_dir, name))
    src = read_safetensors(weights)
    with open(os.path.join(tower_dir, "config.json"), "w") as f:
        json.dump(_hf_tower_config(cfg.vision), f)
    write_safetensors(os.path.join(tower_dir, "model.safetensors"),
                      {k[len(prefix):]: tuple(t.shape)
                       for k, t in src.items() if k.startswith(prefix)},
                      lambda k, s: src[prefix + k])
    return llm_dir, tower_dir


def run_entry(label, flags, report, sigterm_after=None,
              write_state=False) -> tuple:
    """One training process: TE_RUNNER with the flags, its output streamed
    and kept; with sigterm_after, SIGTERM is sent as soon as a line starts
    with it (the next step is then running); without write_state the train
    state's saves are recorded, not written. Returns (report dict, output
    lines); raises if the process fails."""
    import signal
    env = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF="expandable_segments:True")
    root = os.path.dirname(os.path.abspath(__file__))
    env["PYTHONPATH"] = os.pathsep.join(
        [root, os.path.join(root, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-c", TE_RUNNER, report,
         "save" if write_state else "record"] + flags, cwd=root,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        bufsize=1)
    lines, sent = [], False
    try:
        for line in proc.stdout:
            lines.append(line.rstrip("\n"))
            if sigterm_after and not sent and line.startswith(sigterm_after):
                proc.send_signal(signal.SIGTERM)
                sent = True
        rc = proc.wait(timeout=TE_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"[train entry] {label}: exit code {rc}\n"
                           + "\n".join(lines[-40:]))
    if sigterm_after and not sent:
        raise RuntimeError(f"[train entry] {label}: no line began with "
                           f"{sigterm_after!r}")
    with open(report) as f:
        rep = json.load(f)
    rep["process_s"] = wall
    return rep, lines


def _train_log(out_dir) -> list:
    with open(os.path.join(out_dir, "train_log.jsonl")) as f:
        return [json.loads(line) for line in f]


# -- the "launch" phase's plumbing: scripts/torch/ as a user runs them --------

# Put first on the scripts' PYTHONPATH: every python process they start
# runs the interpreter's own sitecustomize, if any, then, when it runs the
# port's training entry point (torchrun's workers) or an inference driver
# (the eval chunks), hands it to chip_smoke.launch_hook, which records its kernel launches (and, in a
# training worker, TrainRecorder's report) into CHIP_SMOKE_LAUNCH_DIR.
LAUNCH_SITECUSTOMIZE = r"""
import os
import sys


def _chain():
    import importlib.machinery
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    rest = [p for p in sys.path if os.path.abspath(p or os.curdir) != here]
    spec = importlib.machinery.PathFinder.find_spec("sitecustomize", rest)
    if spec is not None and spec.origin != os.path.abspath(__file__):
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)


_chain()
# `python -m M`: sys.argv[0] is "-m" until runpy finds M (a script run
# with -m among its own arguments, as torchrun's agent, is not one)
_argv = getattr(sys, "orig_argv", [])
_mod = (_argv[_argv.index("-m") + 1]
        if sys.argv[:1] == ["-m"] and "-m" in _argv[:-1] else "")
if os.environ.get("CHIP_SMOKE_LAUNCH_DIR") and (
        _mod == "videollama2_tpu_torch.train.train"
        or _mod.startswith("videollama2_tpu_torch.eval.inference_")):
    import chip_smoke
    chip_smoke.launch_hook(_mod)
"""
LAUNCH_TIMEOUT = 600


def launch_hook(module: str) -> None:
    """In a process a launch script started on a module of the port: its
    report, written at exit to CHIP_SMOKE_LAUNCH_DIR/<module>.<pid>.json.
    A training worker runs under TrainRecorder (the train state's saves
    recorded, not written); any other module records its kernel launches,
    argv and card."""
    import atexit
    path = os.path.join(os.environ["CHIP_SMOKE_LAUNCH_DIR"],
                        f"{module}.{os.getpid()}.json")
    if module == "videollama2_tpu_torch.train.train":
        atexit.register(TrainRecorder(write_state=False).write, path)
        return
    counters = kernel_counters()
    start = time.time()

    def write():
        with open(path, "w") as f:
            json.dump({"module": module, "argv": sys.argv, "start": start,
                       "end": time.time(), "cuda_visible_devices":
                       os.environ.get("CUDA_VISIBLE_DEVICES"),
                       "launches": {n: fn.launches
                                    for n, fn in counters.items()}}, f)
    atexit.register(write)


class Launcher:
    """Runs scripts/torch/<rel> with bash from the repository root, with
    this interpreter as `python` and `torchrun` (their first entries on
    PATH), LAUNCH_SITECUSTOMIZE on PYTHONPATH and the variables given. A
    run returns its wall seconds, host clock at start, output lines and
    the reports of the processes it started (each run its own report
    directory, so that runs may overlap: start() them, then finish())."""

    def __init__(self, root: str):
        self.repo = os.path.dirname(os.path.abspath(__file__))
        self.root = root
        self.hook = os.path.join(root, "launch_hook")
        os.makedirs(os.path.join(self.hook, "bin"))
        with open(os.path.join(self.hook, "sitecustomize.py"), "w") as f:
            f.write(LAUNCH_SITECUSTOMIZE)
        for name, text in (
                ("python", f'#!/bin/sh\nexec "{sys.executable}" "$@"\n'),
                ("torchrun", f"#!{sys.executable}\nimport sys\n"
                 "from torch.distributed.run import main\n"
                 "sys.exit(main())\n")):
            path = os.path.join(self.hook, "bin", name)
            with open(path, "w") as f:
                f.write(text)
            os.chmod(path, 0o755)
        self.runs = 0

    def start(self, label: str, rel: str, **env) -> dict:
        import socket
        self.runs += 1
        reports = os.path.join(self.root, f"launch_reports_{self.runs}")
        os.makedirs(reports)
        with socket.socket() as sock:       # a free port for torchrun
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        full = dict(os.environ, PYTORCH_CUDA_ALLOC_CONF=
                    "expandable_segments:True", ARG_MASTER_PORT=str(port),
                    CHIP_SMOKE_LAUNCH_DIR=reports,
                    PATH=os.pathsep.join([os.path.join(self.hook, "bin"),
                                          os.environ.get("PATH", "")]),
                    PYTHONPATH=os.pathsep.join(
                        [self.hook, self.repo, os.path.join(self.repo,
                                                            "tests")]
                        + ([os.environ["PYTHONPATH"]]
                           if os.environ.get("PYTHONPATH") else [])),
                    **{k: str(v) for k, v in env.items()})
        log_path = os.path.join(reports, "output.txt")
        out = open(log_path, "w")
        proc = subprocess.Popen(
            ["bash", os.path.join(self.repo, "scripts", "torch", rel)],
            cwd=self.repo, env=full, stdout=out, stderr=subprocess.STDOUT)
        out.close()
        return {"label": label, "rel": rel, "proc": proc, "reports": reports,
                "log": log_path, "start": time.time(),
                "t0": time.perf_counter()}

    def finish(self, run: dict) -> dict:
        proc = run["proc"]
        try:
            rc = proc.wait(timeout=LAUNCH_TIMEOUT)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        wall = time.perf_counter() - run["t0"]
        with open(run["log"]) as f:
            lines = f.read().splitlines()
        if rc != 0:
            raise RuntimeError(f"[launch] {run['label']}: bash scripts/torch/"
                               f"{run['rel']} exit code {rc}\n"
                               + "\n".join(lines[-60:]))
        reports = []
        for name in sorted(os.listdir(run["reports"])):
            if name.endswith(".json"):
                with open(os.path.join(run["reports"], name)) as f:
                    reports.append(json.load(f))
        log(f"[launch] {run['label']}: bash scripts/torch/{run['rel']} "
            f"{wall:.1f} s wall, {len(reports)} port process(es)")
        return {"wall_s": wall, "start": run["start"], "lines": lines,
                "reports": reports}

    def run(self, label: str, rel: str, **env) -> dict:
        return self.finish(self.start(label, rel, **env))

    def finish_all(self, runs: list) -> list:
        """finish() each started run; if one fails, the others are killed
        before its error propagates."""
        try:
            return [self.finish(run) for run in runs]
        finally:
            for run in runs:
                if run["proc"].poll() is None:
                    run["proc"].kill()
                    run["proc"].wait()


def launch_train(label, run, want, out_dir, may_stay=()) -> tuple:
    """A training script's finished run (Launcher): one torchrun worker,
    checked as a train entry run (check_entry_run), with its wall seconds,
    the seconds from the script's start to its first step, and its `step
    N:` lines. Returns (the run's numbers, the worker's report)."""
    if len(run["reports"]) != 1:
        raise RuntimeError(f"[launch] {label}: {len(run['reports'])} worker "
                           "reports, not one (torchrun --nproc_per_node 1)")
    rep = run["reports"][0]
    rep["process_s"] = run["wall_s"]
    res = check_entry_run(label, rep, _train_log(out_dir), want, may_stay)
    nproc = [ln for ln in run["lines"] if ln.startswith("WORLD_SIZE")]
    res.update(script_s=run["wall_s"], start_to_first_step_s=rep[
        "first_step_wall"] - run["start"], world=nproc,
        step_lines=[ln for ln in run["lines"] if ln.startswith("step ")])
    log(f"[launch] {label}: {nproc}; script {run['wall_s']:.1f} s, script "
        f"start to first step under torchrun "
        f"{res['start_to_first_step_s']:.1f} s, steps "
        f"{[round(st['s'], 3) for st in res['steps']]} s, losses "
        f"{[round(st['loss'], 6) for st in res['steps']]}")
    return res, rep


def check_entry_run(label, rep, train_log, want, may_stay=()) -> dict:
    """Launch counts, finite losses, every trained tensor moved (its fp32
    master, where it has one) but those whose path ends with one of
    may_stay, every frozen tensor bit-unchanged; returns the run's
    numbers."""
    if rep["launches"] != want:
        raise RuntimeError(f"[train entry] {label}: launch counts "
                           f"{rep['launches']} != {want}")
    losses = [s["loss"] for s in rep["steps"]]
    if not all(np.isfinite(losses)):
        raise RuntimeError(f"[train entry] {label}: non-finite loss {losses}")
    trained = {f"params:{p}" for p in rep["trained"]}
    params = [k for k in rep["first"] if k.startswith("params:")]
    frozen = [k for k in params if k not in trained]
    changed = [k for k in frozen if rep["first"][k] != rep["final"][k]]
    if changed:
        raise RuntimeError(f"[train entry] {label}: frozen tensors changed: "
                           f"{changed[:5]}")
    values = [f"master:{p}" if f"master:{p}" in rep["first"]
              else f"params:{p}" for p in rep["trained"]]
    still = [k for k in values if rep["first"][k] == rep["final"][k]
             and not k.endswith(tuple(may_stay))]
    if still:
        raise RuntimeError(f"[train entry] {label}: {len(still)} of "
                           f"{len(values)} trained tensors did not move: "
                           f"{still[:5]}")
    moved = {g: sum(k.split(":")[1].startswith(f"{g}/")
                    and rep["first"][k] != rep["final"][k] for k in values)
             for g in ("connector", "llm")}
    masters = sum(k.startswith("master:") for k in values)
    # the host's batch time of each logged step (a preempted step saves
    # and returns before its log line, as in JAX)
    host = {line["step"]: line["data_s"] for line in train_log}
    steps = []
    for st in rep["steps"]:
        steps.append({"step": st["step"], "s": st["s"],
                      "host_batch_s": host.get(st["step"]),
                      "valid_tokens_per_s": st["valid_tokens"] / st["s"],
                      "loss": st["loss"], "valid_tokens": st["valid_tokens"]})
        built = ("not logged" if st["step"] not in host
                 else f"{host[st['step']]:.3f} s")
        steps[-1].update({k: st[k] for k in ("forward_s", "backward_s",
                                             "optimizer_s")})
        log(f"[train entry] {label} step {st['step']}: {st['s']:.3f} s on "
            f"the card (forward {st['forward_s']:.3f}, backward "
            f"{st['backward_s']:.3f}, optimizer {st['optimizer_s']:.3f}), "
            f"batch built on the host in {built}, "
            f"{steps[-1]['valid_tokens_per_s']:.0f} valid tokens/s, loss "
            f"{st['loss']:.6f}")
    out = {"steps": steps, "peak_gb": rep["peak_gb"],
           "state_saves_at": rep["save_steps"],
           "save_s": rep["saves"], "restore_s": rep["restores"],
           "process_s": rep["process_s"], "launches": rep["launches"],
           "first_step_at_s": rep["first_step_at_s"],
           "trained_tensors_moved": moved, "fp32_masters": masters,
           "trained_tensors": len(trained), "frozen_tensors": len(frozen)}
    log(f"[train entry] {label}: {len(steps)} steps, peak device memory "
        f"{rep['peak_gb']:.1f} GB, train-state saves {rep['saves']} s, "
        f"restores {rep['restores']} s, process {rep['process_s']:.1f} s "
        f"(first step at {rep['first_step_at_s']:.1f} s); all "
        f"{len(trained)} trained tensors moved {moved} ({masters} fp32 "
        f"masters), {len(frozen)} frozen unchanged; launches "
        f"{rep['launches']}")
    return out


def entry_launches(counters, cfg, steps, accum, mb) -> dict:
    """Each kernel's launches in `steps` steps of `accum` microbatches of
    `mb` samples: the training slice's per-microbatch counts."""
    L = cfg.llm.num_layers
    want = dict.fromkeys(counters, 0)
    micro = steps * accum
    want.update(encoder_attention=vit_layers(cfg)
                * (mb * cfg.num_frames // 128 or 1) * micro,
                flash_attention=2 * L * micro,
                flash_attention_bwd_dq=L * micro,
                flash_attention_bwd_dkv=L * micro)
    return want


def run_train_entry_phase(api_ckpt, api_av_ckpt, counters) -> tuple:
    """The "train entry" phase, and the "launch" phase's training scripts:
    train/train.py in child processes, at full width with the LLM cut to
    API_LLM_LAYERS layers, on the api phases' seeded bf16 checkpoints
    (released 7B-16F and 2.1-AV layouts) as plain LLM and tower
    directories, and a corpus written here under the names the scripts
    read, while this process holds only its CUDA context (main runs the
    phase first). Stage 1 runs TE_STEPS steps uninterrupted through
    scripts/torch/vllava/pretrain.sh (torchrun, one rank), then as a plain
    `python -m` with the same flags with SIGTERM sent during step 2 (it
    saves at step 2 and exits 0) and resumed in a new process to TE_STEPS:
    the restored state is bit-equal to the one saved, and the steps'
    losses equal the script run's. Stage 2 runs through
    scripts/torch/vllava/finetune.sh, which reads stage 1's newest
    adapter-{step}/, groups by modality length and trains the LLM; LoRA
    and QLoRA take a step each through scripts/torch/custom/
    finetune_{lora,qlora}.sh over the api checkpoint (their 4 x 4 over
    custom.json), beside the SIGTERM and the resumed run; VideoLLaMA2.1
    runs stage 1 as a plain `python -m` on a --tokenizer factory, two
    epochs of one step with a save every step. Every run holds its trained
    tensors as fp32 masters (--bf16; LoRA adapters are fp32 themselves),
    all of which must move (a LoRA a only after its b has). A whole train
    state at this size is ~12 GB and the machine allows ~45 GiB of disk
    writes a run, so only the SIGTERM run writes its state; the other runs
    record the steps at which the Trainer saves it (state_saves) and write
    their adapter-{step}/ or lora-{step}/. Returns the phase's numbers and
    launch counts."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.media import _native

    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[train entry] this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB "
        f"of device memory ({torch.cuda.memory_allocated() / 1e9:.2f} GB "
        "allocated) while its children train")
    for src in ("jpeg_decode.cc", "gif_lzw.cc", "png_unfilter.cc",
                "resample.cc"):
        _native.load(src)
    out = {}
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    out["corpus"] = write_train_corpus(os.path.join(root, "corpus"))
    corpus = os.path.join(root, "corpus")
    t0 = time.perf_counter()
    mcfg = api_config().replace(num_frames=8)
    base = cfglib.preset("videollama2_qwen2").replace(num_frames=8)
    qcfg = base.replace(llm=dataclasses.replace(base.llm,
                                               num_layers=API_LLM_LAYERS))
    m_llm, m_tower = write_plain_dirs(os.path.join(root, "mistral"), mcfg,
                                      api_ckpt)
    q_llm, q_tower = write_plain_dirs(os.path.join(root, "qwen2"), qcfg,
                                      api_av_ckpt)
    out["dirs_s"] = time.perf_counter() - t0
    log(f"[train entry] corpus: {out['corpus']}; plain Mistral and Qwen2 "
        f"directories ({API_LLM_LAYERS} layers) and the CLIP and SigLIP "
        f"tower directories written in {out['dirs_s']:.1f} s")
    counts = run_entry_runs(out, root, corpus, (mcfg, m_llm, m_tower),
                            (qcfg, q_llm, q_tower), counters, api_ckpt)
    tmp.cleanup()
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[train entry] phase {out['phase_s']:.1f} s")
    return out, counts


def tokenization_share(corpus, llm_dir, cfg) -> dict:
    """Host seconds of stage 2's corpus on the LLM directory's own
    tokenizer, each on a fresh reader (its word cache empty, as in a
    child's first epoch): the dataset's items whole (media decode and
    resize, then tokenization) against the tokenization alone (the same
    conversations through data.preprocess)."""
    import copy
    from videollama2_tpu_torch.multimodal import hf_tokenizer
    from videollama2_tpu_torch.train import data as data_lib
    path = [os.path.join(corpus, SFT_ANNOTATIONS)]
    args = data_lib.DataArguments(data_path=path, data_folder=corpus,
                                  num_frames=cfg.num_frames)
    ds = data_lib.SupervisedDataset(path, hf_tokenizer.load(llm_dir), args,
                                    cfg)
    tok = hf_tokenizer.load(llm_dir)
    t0 = time.perf_counter()
    for sample in ds.list_data_dict:
        sources = [copy.deepcopy(sample["conversations"])]
        tag = next((f"<{k}>" for k in ("video", "image") if k in sample),
                   None)
        if tag:
            sources = data_lib.preprocess_multimodal(sources, tag)
        data_lib.preprocess(sources, tok, tag)
    tok_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for i in range(len(ds)):
        ds[i]
    item_s = time.perf_counter() - t0
    out = {"samples": len(ds), "items_s": item_s, "tokenize_s": tok_s,
           "share": tok_s / item_s}
    log(f"[train entry] stage 2's corpus on its own tokenizer (host): "
        f"{len(ds)} items in {item_s:.3f} s, their tokenization alone "
        f"{tok_s:.4f} s, a {out['share']:.2%} share")
    return out


def run_entry_runs(out, root, corpus, mistral, qwen2, counters,
                   api_ckpt) -> dict:
    """The phase's runs (see run_train_entry_phase) over the corpus and the
    (config, LLM directory, tower directory) of each model; fills `out`
    with their numbers and returns their launch counts."""
    from videollama2_tpu_torch.checkpoint.projector_io import \
        load_projector_only
    from videollama2_tpu_torch.models import connector as conn_lib
    from videollama2_tpu_torch.train.optimizer import flatten
    mcfg, m_llm, m_tower = mistral
    qcfg, q_llm, q_tower = qwen2
    counts = {}
    launcher = Launcher(root)
    outputs = os.path.join(root, "outputs")
    launch = out.setdefault("launch", {})

    def flags(llm, tower, out_dir, model_type="videollama2_mistral",
              projector="stc_connector", data=PRE_ANNOTATIONS, epochs=1,
              save_steps=500, tokenizer=None):
        # scripts/torch/vllava/pretrain.sh's flags at TE_MB x TE_ACCUM on
        # one card (without a tokenizer factory, the LLM directory's own
        # tokenizer files, written by tests/tokenizer_writer.py and copied
        # from the api checkpoints)
        return [
            "--model_type", model_type, "--model_path", llm,
            "--vision_tower", tower, "--mm_projector_type", projector,
            "--mm_vision_select_layer", "-2", "--tune_mm_mlp_adapter",
            "true", "--data_path", os.path.join(corpus, data),
            "--data_folder", corpus, "--num_frames", "8",
            "--model_max_length", str(TRAIN_S), "--output_dir", out_dir,
            "--num_train_epochs", str(epochs),
            "--per_device_train_batch_size", str(TE_MB),
            "--gradient_accumulation_steps", str(TE_ACCUM),
            "--learning_rate", "1e-3", "--weight_decay", "0.",
            "--warmup_ratio", "0.03", "--lr_scheduler_type", "cosine",
            "--save_steps", str(save_steps), "--logging_steps", "1",
            "--bf16", "true", "--mesh_fsdp", "-1", "--mesh_tensor", "1"] + (
                ["--tokenizer", tokenizer] if tokenizer else [])

    def report(name):
        return os.path.join(root, f"{name}.json")

    # stage 1, uninterrupted: scripts/torch/vllava/pretrain.sh under torchrun
    a_dir = os.path.join(outputs, "vllava_pretrain", "pretrain")
    want = entry_launches(counters, mcfg, TE_STEPS, TE_ACCUM, TE_MB)
    log(f"[train entry] stage 1 launches wanted a run of {TE_STEPS} steps: "
        f"{want}")
    script_env = dict(MODEL_PATH=m_llm, VISION_TOWER=m_tower,
                      DATA_DIR=corpus, OUTP_DIR=outputs)
    label = "stage 1 (pretrain.sh)"
    out["stage1"], rep_a = launch_train(label, launcher.run(
        label, "vllava/pretrain.sh", **script_env, ARG_NPROC_PER_NODE=1,
        GLOBAL_BATCH_SIZE=TE_PRE_SAMPLES // TE_STEPS,
        LOCAL_BATCH_SIZE=TE_MB), want, a_dir)
    launch["pretrain.sh"] = out["stage1"]
    if rep_a["save_steps"] != [TE_STEPS] \
            or not os.path.isdir(os.path.join(a_dir, f"adapter-{TE_STEPS}")):
        raise RuntimeError("[train entry] stage 1 saved its state at "
                           f"{rep_a['save_steps']}, not at {TE_STEPS} "
                           f"only, or wrote no adapter-{TE_STEPS}/")
    counts["stage 1 (pretrain.sh)"] = rep_a["launches"]
    # the saved projector reads back through load_projector_only as the
    # trained connector's fp32 masters
    like = {}
    for path, shape in _flat_shapes(conn_lib.param_shapes(mcfg.connector)):
        node = like
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = torch.zeros(shape, dtype=torch.float32)
    back = flatten(load_projector_only(
        os.path.join(a_dir, f"adapter-{TE_STEPS}"), like))
    saved = dict(zip(("/".join(p) for p in back),
                     _checksums(list(back.values()))))
    final_conn = {k[len("master:connector/"):]: v
                  for k, v in rep_a["final"].items()
                  if k.startswith("master:connector/")}
    if saved != final_conn:
        raise RuntimeError("[train entry] adapter-4 does not read back as "
                           "the trained connector's fp32 masters")

    # stage 1 again with pretrain.sh's flags as a plain `python -m`:
    # SIGTERM during step 2, then resumed in a new process; beside each, a
    # step of scripts/torch/custom/finetune_lora.sh, then finetune_qlora.sh,
    # over the api checkpoint (a whole VideoLLaMA2-7B-16F directory, LLM cut
    # to API_LLM_LAYERS), checked below
    custom = {}

    def custom_start(rel):
        return launcher.start(
            os.path.basename(rel), rel, MODEL_PATH=api_ckpt,
            DATA_DIR=corpus, OUTP_DIR=outputs, ARG_NPROC_PER_NODE=1)
    b_dir = os.path.join(root, "stage1_preempted")
    started = custom_start("custom/finetune_lora.sh")
    try:
        rep_b, lines_b = run_entry(
            "stage 1 preempted", flags(m_llm, m_tower, b_dir), report("b"),
            sigterm_after="step 1:", write_state=True)
    finally:
        custom["custom/finetune_lora.sh"], = launcher.finish_all([started])
    if not any(ln.startswith("preemption signal received") for ln in lines_b) \
            or sorted(os.listdir(os.path.join(b_dir, "checkpoints"))) != ["2"]:
        raise RuntimeError("[train entry] the SIGTERM run did not save at "
                           f"step 2: {lines_b[-10:]}")
    out["stage1_preempted"] = check_entry_run(
        "stage 1 preempted", rep_b, _train_log(b_dir),
        entry_launches(counters, mcfg, 2, TE_ACCUM, TE_MB))
    out["stage1_preempted"]["concurrent_with"] = "finetune_lora.sh"
    counts["stage 1 preempted"] = rep_b["launches"]
    started = custom_start("custom/finetune_qlora.sh")
    try:
        rep_c, lines_c = run_entry("stage 1 resumed",
                                   flags(m_llm, m_tower, b_dir), report("c"))
    finally:
        custom["custom/finetune_qlora.sh"], = launcher.finish_all([started])
    if not any(ln.startswith("Resuming from checkpoint step 2")
               for ln in lines_c):
        raise RuntimeError("[train entry] the resumed run did not resume "
                           "from step 2")
    if rep_c["first"] != rep_b["after_step"]["2"]:
        bad = [k for k, v in rep_b["after_step"]["2"].items()
               if rep_c["first"].get(k) != v]
        raise RuntimeError("[train entry] the restored state differs from "
                           f"the saved one: {bad[:5]}")
    out["stage1_resumed"] = check_entry_run(
        "stage 1 resumed", rep_c, _train_log(b_dir),
        entry_launches(counters, mcfg, TE_STEPS - 2, TE_ACCUM, TE_MB))
    out["stage1_resumed"]["concurrent_with"] = "finetune_qlora.sh"
    counts["stage 1 resumed"] = rep_c["launches"]
    if rep_b["save_steps"] != [2] or rep_c["save_steps"] != [TE_STEPS]:
        raise RuntimeError("[train entry] state saves at "
                           f"{rep_b['save_steps']} and {rep_c['save_steps']}")
    # the plain runs' steps against pretrain.sh's under torchrun (a
    # one-rank NCCL group: the world-1 mesh)
    want_l = [s["loss"] for s in rep_a["steps"][2:]]
    got_l = [s["loss"] for s in rep_c["steps"]]
    np.testing.assert_allclose(got_l, want_l, rtol=TE_LOSS_RTOL, atol=0)
    first_l = [s["loss"] for s in rep_b["steps"]]
    np.testing.assert_allclose(first_l, [s["loss"] for s in
                                         rep_a["steps"][:2]],
                               rtol=TE_LOSS_RTOL, atol=0)
    same_final = rep_c["final"] == rep_a["final"]
    out["resume"] = {"losses": got_l, "uninterrupted": want_l,
                     "bit_equal_losses": got_l == want_l,
                     "restored_bit_equal": True,
                     "final_bit_equal": same_final}
    log(f"[train entry] resumed at step 2: restored params and moments "
        f"bit-equal to the saved ones; steps 3-4 losses {got_l} vs the "
        f"uninterrupted run's (pretrain.sh under torchrun) {want_l} "
        f"(bit-equal: {got_l == want_l}; tolerance rtol {TE_LOSS_RTOL}); "
        f"final state bit-equal to the uninterrupted run's: {same_final}")
    shutil_rm(b_dir)

    # stage 2 over stage 1's newest adapter: scripts/torch/vllava/
    # finetune.sh under torchrun
    d_dir = os.path.join(outputs, "vllava_finetune", "finetune")
    ft_steps = TE_SFT_MEDIA // (TE_FT_MB * TE_FT_ACCUM)
    want2 = entry_launches(counters, mcfg, ft_steps, TE_FT_ACCUM, TE_FT_MB)
    label = "stage 2 (finetune.sh)"
    out["stage2"], rep_d = launch_train(label, launcher.run(
        label, "vllava/finetune.sh", **script_env, ARG_NPROC_PER_NODE=1,
        GLOBAL_BATCH_SIZE=TE_FT_MB * TE_FT_ACCUM,
        LOCAL_BATCH_SIZE=TE_FT_MB), want2, d_dir)
    launch["finetune.sh"] = out["stage2"]
    first_conn = {k[len("master:connector/"):]: v
                  for k, v in rep_d["first"].items()
                  if k.startswith("master:connector/")}
    if first_conn != final_conn:
        raise RuntimeError("[train entry] stage 2 did not start from stage "
                           "1's adapter")
    out["stage2"]["tokenization"] = tokenization_share(corpus, m_llm, mcfg)
    counts["stage 2 (finetune.sh)"] = rep_d["launches"]
    shutil_rm(a_dir)
    shutil_rm(d_dir)

    # the LoRA and QLoRA script runs, each a step beside a plain stage-1 run
    want_c = entry_launches(counters, mcfg, 1, CUSTOM_ACCUM, CUSTOM_MB)
    for (rel, run), name, beside in zip(
            custom.items(), ("custom_lora", "custom_qlora"),
            ("stage 1 preempted", "stage 1 resumed")):
        o_dir = os.path.join(outputs, name)
        res, rep = launch_train(os.path.basename(rel), run, want_c, o_dir,
                                may_stay=("lora/a",))
        res["concurrent_with"] = beside
        # the adapters' b and the connector train; each a waits on b
        # (zero at the start): LoRA's first step leaves it unchanged
        b_paths = [k for k in rep["trained"] if k.endswith("lora/b")
                   or "/lora/b/" in k]
        if not b_paths or res["trained_tensors_moved"]["connector"] == 0 \
                or not os.path.isdir(os.path.join(o_dir, "lora-1")):
            raise RuntimeError(f"[launch] {rel}: adapters b {b_paths}, "
                               f"moved {res['trained_tensors_moved']}, "
                               f"lora-1/ {os.listdir(o_dir)}")
        launch[os.path.basename(rel)] = res
        counts[os.path.basename(rel)] = rep["launches"]
        shutil_rm(o_dir)

    # VideoLLaMA2.1: stage 1, two epochs of one step with a save every
    # step (the Trainer's save_steps trigger and an epoch boundary), on a
    # --tokenizer factory
    e_dir = os.path.join(root, "qwen2")
    wantq = entry_launches(counters, qcfg, TE_QWEN2_STEPS, TE_ACCUM, TE_MB)
    rep_e, _ = run_entry(
        "2.1 stage 1", flags(q_llm, q_tower, e_dir, "videollama2_qwen2",
                             "stc_connector_v35", data=PRE_ONE_STEP,
                             epochs=TE_QWEN2_STEPS, save_steps=1,
                             tokenizer="chip_smoke:toy_tokenizer"),
        report("e"))
    out["qwen2_stage1"] = check_entry_run("2.1 stage 1", rep_e,
                                          _train_log(e_dir), wantq)
    saves = list(range(1, TE_QWEN2_STEPS + 1))
    if rep_e["save_steps"] != saves or not all(
            os.path.isdir(os.path.join(e_dir, f"adapter-{n}")) for n in saves):
        raise RuntimeError("[train entry] 2.1 stage 1 saved its state at "
                           f"{rep_e['save_steps']}, not at {saves}, or "
                           f"wrote no adapter-{{1, 2}}/: {os.listdir(e_dir)}")
    counts["2.1 stage 1"] = rep_e["launches"]
    shutil_rm(e_dir)
    return counts


# -- the "eval" phase: the evaluation harness on the api checkpoint ----------

EVAL_FRAMES = (16, 240, 320)  # each written GIF and JPEG directory
EVAL_GIFS = 4
EVAL_FRAME_DIRS = 2
EVAL_QUESTIONS = 2            # Video-MME questions a video (2 x Q prompts)
EVAL_BATCH_QUESTIONS = 3      # run_batched: EVAL_GIFS videos x 3 questions
EVAL_BATCH_PROMPTS = 8
EVAL_BATCH_TOKENS = 16
EVAL_QA = dict(prompts=4, steps=16, bucket=128)   # quant_accuracy.measure
EVAL_TIMEOUT = 300


class LetterTokenizer(ToyTokenizer):
    """ToyTokenizer whose reply begins with an option letter: the first
    kept id i decodes to "ABD"[i % 3] (the rest to w<id> words), so each
    answer's letter follows from the model's first token and is never C,
    the inference scripts' fallback ("C" on a failed MVBench call, an empty Video-MME
    output read as C): a record holding C came from a fallback."""

    def decode(self, ids, skip_special_tokens=True):
        kept = [i for i in ids if not (skip_special_tokens and i < 3)]
        words = [f"w{i}" for i in kept]
        if words:
            words[0] = "ABD"[kept[0] % 3]
        return " ".join(words)


def letter_tokenizer(model_path):
    """The eval inference scripts' --tokenizer factory: LetterTokenizer at the
    vocabulary of the model directory's config.json."""
    with open(os.path.join(model_path, "config.json")) as f:
        return LetterTokenizer(json.load(f)["vocab_size"])


def write_eval_media(root) -> dict:
    """The phase's benchmark trees, written with the test writers: EVAL_GIFS
    16-frame 240x320 GIFs and EVAL_FRAME_DIRS directories of 16 baseline
    JPEG frames (the GPU host has no libavcodec); MVBench's layout with two
    of its tasks, "Action Sequence" (video, start/end bounds) over the first
    two GIFs and "Episodic Reasoning" (frame directories) over the JPEG
    directories, four candidates each; a pre-grouped Video-MME question
    file over the last two GIFs (EVAL_QUESTIONS questions each, the
    published fields) with an SRT file each."""
    from gif_writer import encode_rgb_gif
    from jpeg_writer import encode_jpeg
    t0 = time.perf_counter()
    rng = np.random.default_rng(4)
    T, H, W = EVAL_FRAMES
    gifs = [encode_rgb_gif(smooth_frames(rng, T, H, W))
            for _ in range(EVAL_GIFS)]
    out = {"root": root, "gifs": []}
    mvb = os.path.join(root, "mvbench")
    out["mvbench_json"] = os.path.join(mvb, "json")
    out["mvbench_video"] = os.path.join(mvb, "video")
    os.makedirs(out["mvbench_json"])
    star = os.path.join(out["mvbench_video"], "star", "Charades_v1_480")
    tvqa = os.path.join(out["mvbench_video"], "tvqa", "frames_fps3_hq")
    os.makedirs(star)
    for i, data in enumerate(gifs):
        path = os.path.join(root, f"e{i}.gif")
        with open(path, "wb") as f:
            f.write(data)
        out["gifs"].append(path)
    action, episodic = [], []
    for i in range(2):
        with open(os.path.join(star, f"clip{i}.gif"), "wb") as f:
            f.write(gifs[i])
        action.append({"video": f"clip{i}.gif",
                       "question": f"What did the person do first {i} ?",
                       "candidates": ["Opened the door.", "Sat down.",
                                      "Jumped.", "Waved."],
                       "answer": "Sat down.", "start": 0.0, "end": 0.5})
        d = os.path.join(tvqa, f"scene{i}")
        os.makedirs(d)
        for t, px in enumerate(smooth_frames(rng, T, H, W)):
            with open(os.path.join(d, f"{t:05d}.jpg"), "wb") as f:
                f.write(encode_jpeg(px, 90, "4:2:0"))
        episodic.append({"video": f"scene{i}",
                         "question": f"Why does the man leave {i} ?",
                         "candidates": ["He is late.", "He is angry.",
                                        "He hears a knock.", "He is cold."],
                         "answer": "He is late.", "start": 1.0, "end": 4.5})
    for name, annos in (("action_sequence.json", action),
                        ("episodic_reasoning.json", episodic)):
        with open(os.path.join(out["mvbench_json"], name), "w") as f:
            json.dump(annos, f)
    vmme = os.path.join(root, "videomme")
    out["videomme_video"] = os.path.join(vmme, "video")
    out["videomme_subtitle"] = os.path.join(vmme, "subtitle")
    os.makedirs(out["videomme_video"])
    os.makedirs(out["videomme_subtitle"])
    records = []
    for v, data in enumerate(gifs[2:]):
        ytid = f"evalvid{v:04d}"
        with open(os.path.join(out["videomme_video"], f"{ytid}.gif"),
                  "wb") as f:
            f.write(data)
        with open(os.path.join(out["videomme_subtitle"], f"{ytid}.srt"),
                  "w") as f:
            f.write(f"1\n00:00:00,000 --> 00:00:00,300\nA man walks in {v}."
                    f"\n\n2\n00:00:00,300 --> 00:00:01,000\nHe sits down."
                    "\n")
        records.append({
            "video_id": str(v + 1), "youtube_id": ytid,
            "url": f"https://www.youtube.com/watch?v={ytid}",
            "duration": "short", "domain": "Life Record",
            "sub_category": "Daily Life",
            "questions": [{
                "question_id": f"{v + 1:03d}-{q + 1}",
                "task_type": "Action Recognition",
                "question": f"What does the man do ({v}, {q}) ?",
                "choices": ["A. He walks.", "B. He sits.", "C. He runs.",
                            "D. He sleeps."],
                "answer": "B"} for q in range(EVAL_QUESTIONS)]})
    out["videomme_questions"] = os.path.join(vmme, "questions.json")
    with open(out["videomme_questions"], "w") as f:
        json.dump(records, f)
    out["write_s"] = time.perf_counter() - t0
    return out


LAUNCH_FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "tests", "fixtures", "videomme",
                              "test-00000-of-00001.parquet")
LAUNCH_FIXTURE_GOLDEN = LAUNCH_FIXTURE.replace(".parquet", ".golden.json")
LAUNCH_VIDEOMME_VIDEOS = 2    # of the fixture's, given GIF media
READER_ITERS = 5


def parquet_rows_digest(columns: dict) -> str:
    """SHA-256 of a table's rows as canonical JSON (tests/
    test_torch_parquet.py's rows_digest: the golden digest is pandas')."""
    import hashlib
    names = list(columns)
    rows = [dict(zip(names, vals)) for vals in zip(*columns.values())]
    return hashlib.sha256(json.dumps(
        rows, ensure_ascii=False, separators=(",", ":")).encode()).hexdigest()


def check_parquet_fixture() -> dict:
    """The committed Video-MME-shaped fixture through the port's reader
    (eval/parquet.py) against its golden digest of pandas' rows; the read's
    host milliseconds, median of READER_ITERS."""
    from videollama2_tpu_torch.eval import parquet
    with open(LAUNCH_FIXTURE_GOLDEN) as f:
        golden = json.load(f)
    times = []
    for _ in range(READER_ITERS):
        t0 = time.perf_counter()
        cols = parquet.read_columns(LAUNCH_FIXTURE)
        times.append(time.perf_counter() - t0)
    got = {"rows": len(cols["question_id"]),
           "rows_sha256": parquet_rows_digest(cols)}
    if any(golden[k] != v for k, v in got.items()):
        raise RuntimeError(f"[launch] parquet fixture decodes to {got}, its "
                           f"golden digest is {golden}")
    out = dict(got, bytes=os.path.getsize(LAUNCH_FIXTURE),
               read_ms=statistics.median(times) * 1e3,
               read_ms_all=[t * 1e3 for t in times])
    log(f"[launch] parquet fixture ({out['bytes']} bytes, {got['rows']} "
        f"rows, {golden['row_groups']} row groups) equals its golden digest "
        f"(pandas' rows); read in {out['read_ms']:.1f} ms on the host "
        f"(median of {READER_ITERS})")
    return out


def run_videomme_json_form(vm, ckpt, root, picked, videos, vroot, counters,
                           counts, want, out) -> str:
    """The Video-MME driver in this process over the pre-grouped JSON form
    of the fixture's `picked` videos, with exact launches; returns its
    answer file."""
    json_form = os.path.join(root, "launch_videomme.json")
    with open(json_form, "w") as f:
        json.dump(picked, f)
    answer = os.path.join(root, "launch_videomme_json", "1_0.json")
    for c in counters.values():
        c.launches = 0
    saved = sys.argv
    sys.argv = ["inference_video_mcqa_videomme", "--model-path", ckpt,
                "--video-folder", videos, "--subtitle-folder",
                os.path.join(vroot, "videomme", "subtitles"),
                "--question-file", json_form, "--answer-file", answer]
    t0 = time.perf_counter()
    try:
        vm.main()
    finally:
        sys.argv = saved
    torch.cuda.synchronize()
    out["videomme_json_in_process_s"] = time.perf_counter() - t0
    counts["launch videomme json form"] = {n: c.launches
                                           for n, c in counters.items()}
    if counts["launch videomme json form"] != want:
        raise RuntimeError(f"[launch] videomme json form: launches "
                           f"{counts['launch videomme json form']}")
    gc.collect()
    torch.cuda.empty_cache()
    return answer


def run_launch_eval(ckpt, media, root, counters, counts, want_b1,
                    together=True) -> tuple:
    """The "launch" phase's eval scripts on the api checkpoint (its own
    tokenizer files), over write_eval_media's trees: scripts/torch/eval/
    eval_video_mcqa_mvbench.sh at CHUNKS 2 (both chunks on this card) and
    CHUNKS 1, whose merged records must be equal; eval_video_mcqa_
    videomme.sh over the committed parquet fixture, LAUNCH_VIDEOMME_VIDEOS
    of its videos given GIF media under their YouTube ids (the rest are
    missing), whose records must equal those of the same questions read
    from their pre-grouped JSON form by the driver in this process. With
    `together` the three scripts run at once on this card, the JSON form
    meanwhile; else each runs alone, in turn, then the JSON form. Every
    inference process's launches are exact (want_b1 a video). Returns (the
    numbers, the CHUNKS 1 MVBench records)."""
    from videollama2_tpu_torch.eval import inference_video_mcqa_videomme as vm
    out = {"fixture": check_parquet_fixture()}
    launcher = Launcher(os.path.join(root, "launch"))
    name = os.path.basename(ckpt.rstrip(os.sep))
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    cards = (visible.split(",") if visible is not None else
             [str(i) for i in range(torch.cuda.device_count())])

    def per_video(n):
        return {k: v * n for k, v in want_b1.items()}

    def check_chunks(label, run, module, chunks, answers, ext):
        infer = [r for r in run["reports"] if r["module"] == module]
        if len(infer) != chunks:
            raise RuntimeError(f"[launch] {label}: {len(infer)} inference "
                               f"processes, not {chunks}")
        for r in infer:
            argv = r["argv"]
            idx = int(argv[argv.index("--chunk-idx") + 1])
            with open(os.path.join(answers, f"{chunks}_{idx}.{ext}")) as f:
                n = sum(1 for line in f if '"missing": true' not in line)
            counts[f"launch {label} chunk {idx}"] = r["launches"]
            if r["launches"] != per_video(n) \
                    or argv[argv.index("--device") + 1] != "cuda" \
                    or r["cuda_visible_devices"] != cards[idx % len(cards)]:
                raise RuntimeError(
                    f"[launch] {label} chunk {idx}: launches "
                    f"{r['launches']} (want {per_video(n)} for {n} videos), "
                    f"argv {argv}, card {r['cuda_visible_devices']}")
        return infer

    # MVBench at CHUNKS 2 (both chunks on this card) and 1, and Video-MME
    # over the fixture (LAUNCH_VIDEOMME_VIDEOS of its videos given GIF
    # media)
    records = vm.load_parquet(LAUNCH_FIXTURE)
    step = len(records) // LAUNCH_VIDEOMME_VIDEOS
    picked = records[::step][:LAUNCH_VIDEOMME_VIDEOS]
    vroot = os.path.join(root, "launch_videomme")
    videos = os.path.join(vroot, "videomme", "videos")
    os.makedirs(videos)
    os.makedirs(os.path.join(vroot, "videomme", "subtitles"))
    shutil.copy(LAUNCH_FIXTURE, os.path.join(vroot, "videomme",
                                             os.path.basename(LAUNCH_FIXTURE)))
    for rec, gif in zip(picked, media["gifs"][2:]):
        shutil.copy(gif, os.path.join(videos, rec["url"].split(
            "watch?v=")[-1] + ".gif"))
    module = "videollama2_tpu_torch.eval.inference_video_mcqa_mvbench"
    vm_out = os.path.join(root, "launch_videomme_out")
    labels = ("mvbench CHUNKS=2", "mvbench CHUNKS=1", "videomme")
    specs = [
        ("eval/eval_video_mcqa_mvbench.sh", dict(
            CKPT=ckpt, EVAL_DATA_DIR=root, CHUNKS=2,
            OUTPUT_DIR=os.path.join(root, "launch_mvbench_2"))),
        ("eval/eval_video_mcqa_mvbench.sh", dict(
            CKPT=ckpt, EVAL_DATA_DIR=root, CHUNKS=1,
            OUTPUT_DIR=os.path.join(root, "launch_mvbench_1"),
            CUDA_VISIBLE_DEVICES=cards[0])),
        ("eval/eval_video_mcqa_videomme.sh", dict(
            CKPT=ckpt, EVAL_DATA_DIR=vroot, OUTPUT_DIR=vm_out))]

    def json_form():
        # the present videos' JSON form through the driver here
        return run_videomme_json_form(
            vm, ckpt, root, picked, videos, vroot, counters, counts,
            per_video(len(picked)), out)
    if together:
        started = [launcher.start(label, rel, **env)
                   for label, (rel, env) in zip(labels, specs)]
        try:
            answer = json_form()
        finally:
            runs = dict(zip(labels, launcher.finish_all(started)))
    else:
        runs = {label: launcher.run(label, rel, **env)
                for label, (rel, env) in zip(labels, specs)}
        answer = json_form()
    beside = {label: [k for k in labels if k != label] if together else []
              for label in labels}
    merged = {}
    for chunks in (2, 1):
        label = f"mvbench CHUNKS={chunks}"
        run = runs[label]
        answers = os.path.join(root, f"launch_mvbench_{chunks}", "mvbench",
                               "answers", name)
        check_chunks(label, run, module, chunks, answers, "jsonl")
        with open(os.path.join(answers, "merge.json")) as f:
            merged[chunks] = json.load(f)
        if not any(ln.startswith(os.path.join(answers, "merge.json") + ":")
                   for ln in run["lines"]):
            raise RuntimeError(f"[launch] {label}: no score line "
                               f"{run['lines'][-5:]}")
        out[label] = {"script_s": run["wall_s"], "records": len(
            merged[chunks]), "chunk_cards": [r["cuda_visible_devices"] for r
                                             in run["reports"]]}
    for label in labels[:2]:
        out[label]["concurrent_with"] = beside[label]
    if merged[2] != merged[1]:
        raise RuntimeError(f"[launch] mvbench: CHUNKS=2 merged {merged[2]} "
                           f"!= CHUNKS=1 {merged[1]}")
    where = ("beside each other and the Video-MME script" if together
             else "each alone")
    log(f"[launch] mvbench: CHUNKS=2 (both chunks on card {cards[0]}) "
        f"{out['mvbench CHUNKS=2']['script_s']:.1f} s and CHUNKS=1 "
        f"{out['mvbench CHUNKS=1']['script_s']:.1f} s, {where}; merged "
        f"records equal record for record: "
        f"{[r['pred'] for r in merged[1]]}")

    # Video-MME: the script's records, then their JSON form in this process
    run = runs["videomme"]
    answers = os.path.join(vm_out, "videomme", "answers", name)
    check_chunks("videomme", run, "videollama2_tpu_torch.eval."
                 "inference_video_mcqa_videomme", len(cards), answers, "json")
    script = {}
    for sub, fname in ((False, "merge.json"), (True, "merge_sub.json")):
        with open(os.path.join(answers, fname)) as f:
            script[sub] = json.load(f)
        present = [r for r in script[sub] if not r["missing"]]
        if len(script[sub]) != len(records) or [
                r["video_id"] for r in present] != [
                r["video_id"] for r in picked] or any(
                q.get("response") not in tuple("ABCD")
                for r in present for q in r["questions"]):
            raise RuntimeError(f"[launch] videomme {fname}: "
                               f"{len(script[sub])} records, present "
                               f"{present}")
    out["videomme"] = {"script_s": run["wall_s"], "records": len(records),
                       "videos_with_media": len(picked),
                       "concurrent_with": beside["videomme"]}
    for sub, path in ((False, answer),
                      (True, answer.replace(".json", "_sub.json"))):
        with open(path) as f:
            direct = [json.loads(line) for line in f]
        present = [r for r in script[sub] if not r["missing"]]
        if direct != present:
            raise RuntimeError(f"[launch] videomme: the script's records "
                               f"{present} != the JSON form's {direct}")
    letters = [[q["response"] for q in r["questions"]]
               for r in script[False] if not r["missing"]]
    log(f"[launch] videomme: eval_video_mcqa_videomme.sh over the parquet "
        f"fixture {run['wall_s']:.1f} s "
        f"{'beside the MVBench scripts' if together else 'alone'} "
        f"({len(records)} videos, "
        f"{len(picked)} with media); their records (answers {letters}, "
        f"and with subtitles) equal the JSON form's through the driver in "
        f"this process ({out['videomme_json_in_process_s']:.1f} s)")
    return out, merged[1]


def eval_child_start(args) -> subprocess.Popen:
    """`python -m` a module in a child process from the repository root
    (the tests/ writers and chip_smoke on its path, for the tokenizer
    factory)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [repo, os.path.join(repo, "tests")]
        + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return subprocess.Popen([sys.executable, "-m"] + args, cwd=repo, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def eval_child_finish(label, proc) -> list:
    """The started child's output lines, raising unless it exits 0."""
    try:
        stdout, stderr = proc.communicate(timeout=EVAL_TIMEOUT)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if proc.returncode != 0:
        raise RuntimeError(f"[eval] {label}: exit code {proc.returncode}\n"
                           + "\n".join((stdout + stderr).splitlines()[-40:]))
    return stdout.splitlines()


def eval_child(label, args) -> list:
    return eval_child_finish(label, eval_child_start(args))


def quant_launches(counters, cfg, variant, prompts, steps) -> dict:
    """Launch counts of a quant_accuracy.measure call over one variant:
    the reference's prefills (one a prompt) and the variant's (teacher-
    forced and free-running: two a prompt) on K2, and each of the
    variant's decode steps on the layered kernels where its weights are
    packed (K3 over its cache, K4/K5 for int8, K6/K7 for int4; floating
    weights decode on the plain attention)."""
    L = cfg.num_layers
    want = dict.fromkeys(counters, 0)
    want["flash_attention"] = 3 * prompts * L
    if variant.weight_bits:
        n = 2 * prompts * (steps - 1) * L
        b = variant.weight_bits
        want.update({"decode_attention": n, f"matmul_q{b}_layered": 2 * n,
                     f"ffn_q{b}_layered": n})
    return want


def check_quant_against_plain(llm, cfg, prompt, k3, dk) -> dict:
    """quant_accuracy's packed variants held against their plain versions
    at the harness's own shapes (B 1, the variant's bf16 or int8 cache,
    EVAL_QA's bucket and steps): one prompt's decode, teacher-forced on
    the bf16 reference's greedy tokens as measure() forces it, runs once
    through K3 and K4/K5 (int8) or K6/K7 (int4) and once with those three
    swapped for their plain versions, under compare_logits' bounds.
    Returns each variant's KL(ref || q) on both paths, so the harness's
    drift is the quantization's and not a kernel's."""
    from videollama2_tpu_torch.eval import quant_accuracy as qa

    L = cfg.num_layers
    run = dict(cfg=cfg, prompt=prompt, steps=EVAL_QA["steps"],
               bucket=EVAL_QA["bucket"], max_len=256, dtype=torch.bfloat16,
               device="cuda")
    ref = qa.QuantVariant("reference")
    ref_logits, ref_tokens = qa._decode_logits(
        qa._prep_params(llm, ref, torch.bfloat16, "cuda"), variant=ref,
        forced=None, **run)
    out = {}
    for variant in qa.DEFAULT_VARIANTS:
        b = variant.weight_bits
        if not b:
            continue
        params = qa._prep_params(llm, variant, torch.bfloat16, "cuda")
        (fast, _), added = decode_launches(
            k3, dk, b, lambda: qa._decode_logits(
                params, variant=variant, forced=ref_tokens, **run))
        n = (EVAL_QA["steps"] - 1) * L
        if added != [n, 2 * n, n]:
            raise RuntimeError(f"[eval] quant_accuracy {variant.name}: "
                               f"launches {added} != {[n, 2 * n, n]}")
        with plain_decode_kernels(k3, dk, b):
            plain, _ = qa._decode_logits(params, variant=variant,
                                         forced=ref_tokens, **run)
        del params
        # row 0 is the prefill's, the same on both paths
        compare_logits(f"eval quant_accuracy {variant.name} decode, "
                       f"{EVAL_QA['steps'] - 1} teacher-forced steps",
                       torch.from_numpy(fast[1:]),
                       torch.from_numpy(plain[1:]))
        out[variant.name] = {
            "kl_kernels": qa._kl(ref_logits, fast),
            "kl_plain": qa._kl(ref_logits, plain),
            "max_abs_diff": float(np.abs(fast[1:] - plain[1:]).max())}
        log(f"[eval] quant_accuracy {variant.name}: KL(ref || q) "
            f"{out[variant.name]['kl_kernels']:.4e} through the kernels, "
            f"{out[variant.name]['kl_plain']:.4e} through their plain "
            "versions")
    return out


def run_eval_phase(ckpt, counters, smi, k3, dk) -> tuple:
    """The "eval" phase: the evaluation harness (videollama2_tpu_torch/eval)
    on the api phase's checkpoint (the released 7B-16F layout, LLM cut to
    API_LLM_LAYERS layers) in bf16, as the inference scripts load it (model_init's
    defaults), with LetterTokenizer. (a) MVBench as
    scripts/eval/eval_video_mcqa_mvbench.sh runs it: the inference script in a child
    process over write_eval_media's tree (a GIF task and the JPEG "frame"
    task), the merge and the scorer's command line; each record must equal
    a direct B 1 mm_infer's letter here, with exact K1/K2 counts. (b)
    Video-MME in this process (the JSON question file, SRT subtitles):
    mm_infer_batch over 2 x Q prompts a video with exact counts, each
    record's letters from those outputs, each output's tokens against a
    direct B 1 mm_infer's under check_tokens. (c) run_batched over
    EVAL_GIFS videos x EVAL_BATCH_QUESTIONS questions at batch_prompts
    EVAL_BATCH_PROMPTS: grouped media, exact counts a call, first-token
    logits within compare_logits' bounds of B 1 and tokens under
    check_tokens. No record may hold an error, a missing video or the
    fallback letter. (d) quant_accuracy.measure on the checkpoint's LLM
    (bf16 reference, EVAL_QA), one call a variant with exact K2-K7
    counts, then each packed variant's decode against the plain versions
    of its kernels (check_quant_against_plain). Returns the phase's numbers and the launch counts of each
    in-process call."""
    from videollama2_tpu_torch.eval import batch_runner, common
    from videollama2_tpu_torch.eval import inference_video_mcqa_mvbench as mvb
    from videollama2_tpu_torch.eval import inference_video_mcqa_videomme as vm
    from videollama2_tpu_torch.eval import quant_accuracy as qa
    from videollama2_tpu_torch.inference import api
    from videollama2_tpu_torch.media.preprocess import process_video
    from videollama2_tpu_torch.multimodal import hf_tokenizer
    import videollama2_tpu_torch

    cfg = api_config()
    t_phase = time.perf_counter()
    out = {"device": smi}
    counts = {}
    root = tempfile.mkdtemp()
    try:
        media = write_eval_media(root)
        out["media_write_s"] = media["write_s"]
        log(f"[eval] wrote {EVAL_GIFS} GIFs and {EVAL_FRAME_DIRS} JPEG "
            f"directories ({EVAL_FRAMES[0]} frames {EVAL_FRAMES[1]}x"
            f"{EVAL_FRAMES[2]}), an MVBench and a Video-MME tree in "
            f"{media['write_s']:.1f} s")

        # (a) MVBench: the inference script in a child process, beside the
        # "launch" phase's eval scripts (scripts/torch/eval/, the
        # checkpoint's own tokenizer files): MVBench at CHUNKS 2 and 1,
        # whose records are held below to direct calls through the reader,
        # and Video-MME over the committed parquet fixture; then merge and
        # score
        answers = os.path.join(root, "mvbench_answers", "1_0.jsonl")
        t0 = time.perf_counter()
        child = eval_child_start([
            "videollama2_tpu_torch.eval.inference_video_mcqa_mvbench",
            "--model-path", ckpt, "--question-file", media["mvbench_json"],
            "--video-folder", media["mvbench_video"],
            "--answer-file", answers, "--num-chunks", "1", "--chunk-idx",
            "0", "--tokenizer", "chip_smoke:letter_tokenizer"])
        want_b1 = phase_launches(counters, cfg, 1, True, 0, False)
        try:
            out["launch"], own_records = run_launch_eval(
                ckpt, media, root, counters, counts, want_b1)
        finally:
            eval_child_finish("mvbench", child)
        out["mvbench_process_s"] = time.perf_counter() - t0
        merged = os.path.join(root, "mvbench_answers", "merge.json")
        records = common.merge_chunks([answers], merged,
                                      return_records=True)
        scored = eval_child("mvbench scorer", [
            "videollama2_tpu_torch.eval.eval_video_mcqa_mvbench",
            "--pred_path", merged])
        from videollama2_tpu_torch.eval.eval_video_mcqa_mvbench import score
        out["mvbench_score"] = score(records)
        if scored[0] != f"{merged}: {out['mvbench_score']['overall']}":
            raise RuntimeError(f"[eval] mvbench scorer printed {scored}")
        log(f"[eval] MVBench inference (child process, exit 0, beside the "
            f"launch scripts) {out['mvbench_process_s']:.1f} s: "
            f"{len(records)} records, "
            f"scorer {out['mvbench_score']}")
        if len(records) != 4 or any("error" in r for r in records):
            raise RuntimeError(f"[eval] mvbench records {records}")
        if len(own_records) != 4 or any("error" in r for r in own_records):
            raise RuntimeError(f"[eval] mvbench own tokenizer records "
                               f"{own_records}")

        t0 = time.perf_counter()
        model, processor, tok = api.model_init(
            ckpt, tokenizer=letter_tokenizer(ckpt))
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        log(f"[eval] model_init (bf16, the inference scripts' defaults): "
            f"{out['load_s']:.2f} s")
        rec = CallRecorder(model.engine)
        model.engine = rec

        with rec:
            # the MVBench records against direct B 1 mm_infer calls
            annos = {}
            for task, (ann, subdir, _, has_se) in mvb.MVBENCH_TASKS.items():
                path = os.path.join(media["mvbench_json"], ann)
                if os.path.exists(path):
                    with open(path) as f:
                        annos[task] = (json.load(f), has_se)
            def direct(r, tokenizer, label):
                """A record's option index from a direct B 1 mm_infer."""
                task, j = r["index"].rsplit(":", 1)
                item, has_se = annos[task][0][int(j)], annos[task][1]
                tensor = process_video(
                    r["vid"], cfg.vision,
                    s=item.get("start") if has_se else None,
                    e=item.get("end") if has_se else None,
                    aspect_ratio=None, num_frames=cfg.num_frames)
                resp, _, counts[f"{label} {r['index']}"] = counted_call(
                    f"eval {label} {r['index']}", counters, want_b1,
                    lambda cb: api.mm_infer(
                        tensor, mvb.build_prompt(item["question"],
                                                 item["candidates"]),
                        model, tokenizer, modal="video", max_new_tokens=64,
                        stream_cb=cb))
                letters = [chr(ord("A") + i)
                           for i in range(len(item["candidates"]))]
                pred = letters.index(common.extract_choice_letter(
                    resp, item["candidates"], letters=letters))
                if r["pred"] != pred:
                    raise RuntimeError(
                        f"[eval] {label} {r['index']}: record pred "
                        f"{r['pred']}, direct mm_infer {pred} ({resp[:40]!r})")
                return pred

            for r in records:
                if direct(r, tok, "mvbench") == 2:
                    raise RuntimeError(f"[eval] mvbench {r['index']}: the "
                                       "fallback letter C")
            log(f"[eval] MVBench records equal direct B 1 mm_infer letters: "
                f"{[r['pred'] for r in records]}")
            # the child that read the checkpoint's own tokenizer against
            # direct calls through the reader (its answers are random text:
            # the fallback letter C may stand)
            reader = hf_tokenizer.load(ckpt)
            for r in own_records:
                direct(r, reader, "mvbench own tokenizer")
            log(f"[eval] MVBench records of the child on the checkpoint's "
                f"own tokenizer equal direct B 1 mm_infer letters through "
                f"the reader: {[r['pred'] for r in own_records]}")

            # (b) Video-MME in this process
            batches = []
            batch_fn = api.mm_infer_batch

            def mm_infer_batch(tensor, prompts, *a, **k):
                for c in counters.values():
                    c.launches = 0
                rec.calls.clear()
                t0 = time.perf_counter()
                res = batch_fn(tensor, prompts, *a, **k)
                torch.cuda.synchronize()
                batches.append({
                    "s": time.perf_counter() - t0,
                    "tensor": tensor, "prompts": list(prompts),
                    "outputs": res, "call": rec.calls[-1],
                    "counts": {n: c.launches for n, c in counters.items()}})
                return res

            def model_init(path, tokenizer=None, device="cuda", **kw):
                # the factory's class is chip_smoke.LetterTokenizer, this
                # one's __main__'s when the script runs as a program
                if path != ckpt or device != "cuda" or kw \
                        or type(tokenizer).__name__ != "LetterTokenizer":
                    raise RuntimeError(f"[eval] videomme model_init {path} "
                                       f"{device} {kw} {tokenizer}")
                return model, processor, tokenizer

            vm_out = os.path.join(root, "videomme", "answers", "1_0.json")
            saved = (api.mm_infer_batch, videollama2_tpu_torch.model_init,
                     sys.argv)
            api.mm_infer_batch = mm_infer_batch
            videollama2_tpu_torch.model_init = model_init
            sys.argv = ["inference_video_mcqa_videomme",
                        "--model-path", ckpt,
                        "--video-folder", media["videomme_video"],
                        "--subtitle-folder", media["videomme_subtitle"],
                        "--question-file", media["videomme_questions"],
                        "--answer-file", vm_out,
                        "--tokenizer", "chip_smoke:letter_tokenizer"]
            t0 = time.perf_counter()
            try:
                vm.main()
            finally:
                (api.mm_infer_batch, videollama2_tpu_torch.model_init,
                 sys.argv) = saved
            out["videomme_s"] = time.perf_counter() - t0
            vm_records = {}
            for sub, path in ((False, vm_out),
                              (True, vm_out.replace(".json", "_sub.json"))):
                with open(path) as f:
                    vm_records[sub] = [json.loads(line) for line in f]
            if len(batches) != 2 or any(
                    len(v) != 2 or any(r["missing"] for r in v)
                    for v in vm_records.values()):
                raise RuntimeError(f"[eval] videomme: {len(batches)} batch "
                                   f"calls, records {vm_records}")
            out["videomme"] = []
            for v, b in enumerate(batches):
                label = f"videomme video {v}"
                want = calls_launches(counters, cfg, [b["call"]],
                                      packed=False)
                counts[label] = b["counts"]
                log(f"[eval] {label}: mm_infer_batch over "
                    f"{len(b['prompts'])} prompts, launches {b['counts']} "
                    f"(want {want})")
                if b["counts"] != want or not any(
                        "subtitles are listed below:\nA man walks in"
                        in p for p in b["prompts"]):
                    raise RuntimeError(f"[eval] {label}: launches or "
                                       "subtitles wrong")
                b1 = []
                for i, p in enumerate(b["prompts"]):
                    rec.calls.clear()
                    _, _, counts[f"{label} b1 {i}"] = counted_call(
                        f"eval {label} b1 {i}", counters, want_b1,
                        lambda cb: api.mm_infer(
                            b["tensor"], p, model, tok, modal="video",
                            do_sample=False, max_new_tokens=128,
                            stream_cb=cb))
                    b1.append(rec.calls[-1])
                res = check_tokens(
                    f"eval {label} batch vs B 1",
                    [c["outs"][0] for c in b1], b["call"]["outs"],
                    lambda r, p: b1[r]["picks"][p][0],
                    lambda r, p: b["call"]["picks"][p][r])
                if not res["ok"]:
                    raise RuntimeError(f"[eval] {label}: tokens of the "
                                       "batch differ from B 1 beyond a "
                                       "near-tie")
                flipped = {t["row"] for t in res["near_ties"]
                           if t["position"] == 0}
                for i, (output, p) in enumerate(zip(b["outputs"],
                                                    b["prompts"])):
                    q, with_sub = divmod(i, 2)
                    record = vm_records[bool(with_sub)][v]
                    choices = record["questions"][q]["choices"]
                    options = [re.findall(r"[A-D]\. (.*).", c)[0]
                               for c in choices]
                    got = record["questions"][q]["response"]
                    direct = vm.videomme_dump(record, p, options,
                                              tok.decode(b1[i]["outs"][0]))
                    if got == "C" or got != vm.videomme_dump(
                            record, p, options, output) \
                            or (got != direct and i not in flipped):
                        raise RuntimeError(
                            f"[eval] {label} prompt {i}: record {got}, "
                            f"batch {output[:20]!r}, B 1 {direct}")
                out["videomme"].append({
                    "batch_prompts": len(b["prompts"]),
                    "mm_infer_batch_s": b["s"],
                    "vs_b1": res})
            log(f"[eval] Video-MME (in process, {out['videomme_s']:.1f} s): "
                f"responses "
                f"{[[q['response'] for q in r['questions']] for v in vm_records.values() for r in v]}"
                ", each equal to B 1 mm_infer's (or a near-tie of its "
                "first token)")

            # (c) run_batched: grouped media over EVAL_GIFS videos
            items = [{"vid": f"e{i}", "path": p, "questions": [
                f"what happens in clip {i} part {q} ?"
                for q in range(EVAL_BATCH_QUESTIONS)]}
                for i, p in enumerate(media["gifs"])]
            results, frames_of = [], {}

            def load_media(item):
                frames_of[item["vid"]] = processor["video"](item["path"])
                return frames_of[item["vid"]]

            rec.calls.clear()
            for c in counters.values():
                c.launches = 0
            t0 = time.perf_counter()
            batch_runner.run_batched(
                model, tok, items, load_media,
                lambda item: [({"q": q}, q) for q in item["questions"]],
                lambda item, meta, text: results.append(
                    (item["vid"], meta["q"], text)),
                batch_prompts=EVAL_BATCH_PROMPTS,
                max_new_tokens=EVAL_BATCH_TOKENS)
            torch.cuda.synchronize()
            out["run_batched_s"] = time.perf_counter() - t0
            calls = list(rec.calls)
            counts["run_batched"] = {n: c.launches
                                     for n, c in counters.items()}
            want = calls_launches(counters, cfg, calls, packed=False)
            groups = [list(c["media_group"]) for c in calls]
            log(f"[eval] run_batched {len(results)} answers in "
                f"{out['run_batched_s']:.2f} s: {len(calls)} generate calls,"
                f" media groups {groups}, launches {counts['run_batched']} "
                f"(want {want})")
            if counts["run_batched"] != want or len(results) != \
                    EVAL_GIFS * EVAL_BATCH_QUESTIONS:
                raise RuntimeError("[eval] run_batched: launches or "
                                   "answers wrong")
            rows = [(c, r) for c in calls for r in range(len(c["ids"]))]
            b1 = []
            for i, (c, r) in enumerate(rows):
                vid = results[i][0]
                rec.calls.clear()
                counted_call(f"eval run_batched b1 {i}", counters,
                             phase_launches(counters, cfg, 1, True, 0,
                                            False),
                             lambda cb: rec.generate(
                                 [c["ids"][r]], frames=frames_of[vid][None],
                                 gen=api.GenerationConfig(
                                     max_new_tokens=EVAL_BATCH_TOKENS),
                                 eos_token_id=tok.eos_token_id,
                                 stream_cb=cb))
                b1.append(rec.calls[-1])
            compare_logits("eval run_batched first token vs B 1",
                           torch.stack([c["picks"][0][r]
                                        for c, r in rows]).float(),
                           torch.stack([x["picks"][0][0]
                                        for x in b1]).float())
            out["run_batched_vs_b1"] = check_tokens(
                "eval run_batched vs B 1", [x["outs"][0] for x in b1],
                [c["outs"][r] for c, r in rows],
                lambda b, p: b1[b]["picks"][p][0],
                lambda b, p: rows[b][0]["picks"][p][rows[b][1]])
            if not out["run_batched_vs_b1"]["ok"]:
                raise RuntimeError("[eval] run_batched: tokens differ from "
                                   "B 1 beyond a near-tie")
            out["run_batched_groups"] = groups
        model.engine = rec._engine
        llm = model.engine.params["llm"]
        del model, rec, processor
        gc.collect()
        torch.cuda.empty_cache()

        # (d) quant_accuracy.measure on the checkpoint's LLM, a variant a call
        rng = np.random.default_rng(0)
        prompts = [np.concatenate([[1], rng.integers(
            4, cfg.llm.vocab_size - 1, rng.integers(8, EVAL_QA["bucket"]
                                                     // 2))])
            for _ in range(EVAL_QA["prompts"])]
        table = {}
        t0 = time.perf_counter()
        for variant in qa.DEFAULT_VARIANTS:
            want = quant_launches(counters, cfg.llm, variant, len(prompts),
                                  EVAL_QA["steps"])
            result, stats, counts[f"quant {variant.name}"] = counted_call(
                f"eval quant_accuracy {variant.name}", counters, want,
                lambda cb: qa.measure(
                    llm, cfg.llm, prompts, variants=(variant,),
                    steps=EVAL_QA["steps"], bucket=EVAL_QA["bucket"],
                    max_len=256, dtype=torch.bfloat16, device="cuda"))
            table.update(result)
            table[variant.name]["call_s"] = stats["call_s"]
        out["quant_accuracy_s"] = time.perf_counter() - t0
        out["quant_vs_plain"] = check_quant_against_plain(
            llm, cfg.llm, prompts[0], k3, dk)
        del llm
        for name, m in table.items():
            if not (math.isfinite(m["kl"]) and m["kl"] >= 0):
                raise RuntimeError(f"[eval] quant_accuracy {name}: {m}")
        out["quant_accuracy"] = table
        log(json.dumps({"quant_accuracy": {
            "weights": "seeded random (api checkpoint: Mistral-7B widths, "
                       f"{API_LLM_LAYERS} layers): structural numbers, "
                       "not the accuracy of released weights",
            "device": smi, "reference": "bf16 weights, bf16 cache",
            **{k: v for k, v in EVAL_QA.items()}, "results": table,
            "vs_plain": out["quant_vs_plain"]}}))
        for line in qa.format_table(table).splitlines():
            log(f"[eval] {line}")
    finally:
        shutil_rm(root)
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"[eval] phase {out['phase_s']:.1f} s")
    return out, counts


def _flat_shapes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat_shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), tuple(v)


def shutil_rm(path) -> None:
    import shutil
    shutil.rmtree(path, ignore_errors=True)


def urllib_post(url, payload, timeout=60):
    import urllib.request
    req = urllib.request.Request(
        url, data=json.dumps(payload).encode(),
        headers={"Content-Type": "application/json"}, method="POST")
    return urllib.request.urlopen(req, timeout=timeout)


# ---------------------------------------------------------------------------
# The "parallel" phase: parallel/ (mesh, rule table, sharded step, Trainer
# and Engine) at full width, and K1, K2, K8 and K9 at the shapes a rank
# gets under tensor and sequence parallelism
# ---------------------------------------------------------------------------

PAR_LAYERS = 8          # Mistral-7B at full width, 8 of its 32 LLM layers
PAR_TRAIN_B = 2         # one microbatch: 2 videos of 8 frames, seq TRAIN_S
PAR_GEN_B, PAR_GEN_TOKENS = 2, 16
PAR_TIMEOUT = 600
# a multi-card step against one card's on the same batch: the loss, each
# trained leaf's Adam first moment (the clipped, summed gradient) by its
# relative L2 distance, and its fp32 update by the cosine of the two
# updates (Adam's first step is +-lr an element, so a gradient that keeps
# its sign keeps the update); each on a strided sample of PAR_SAMPLE
# elements a leaf. The limits stand above the readings of fsdp 2 and 4 on
# H100s (PERF.md §6, PR 19: losses 2.2e-5 / 8.5e-5 apart, first moments
# 3.8e-2 at most, update cosines 0.941 at least: bf16 rounding at another
# batch split) and below what a lost gradient sum or a misplaced shard
# gives (a first moment 0.3 or more apart, an update cosine near 0)
PAR_LOSS_REL_TOL = 1e-3
PAR_GRAD_REL_TOL = 0.1
PAR_UPDATE_COS_MIN = 0.9
PAR_SAMPLE = 1 << 18
# (label, B, S, query heads, kv heads) a rank computes: tensor 2 and 4 of
# Mistral-7B (32 / 8 heads) and Qwen2-7B (28 / 4), and Ulysses seq 2 of a
# 4096-token Mistral-7B sequence (every token, half the heads)
PAR_TRAIN_SHAPES = (("Mistral-7B tensor 2", 2, TRAIN_S, 16, 4),
                    ("Mistral-7B tensor 4", 2, TRAIN_S, 8, 2),
                    ("Qwen2-7B tensor 2", 2, TRAIN_S, 14, 2),
                    ("Qwen2-7B tensor 4", 2, TRAIN_S, 7, 1),
                    ("Mistral-7B seq 2 of 4096", 1, 4096, 16, 4))


def parallel_config(cfglib):
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=8)
    return cfg.replace(llm=dataclasses.replace(cfg.llm,
                                               num_layers=PAR_LAYERS))


def _sample(t: torch.Tensor) -> torch.Tensor:
    """A fixed strided sample of a leaf's elements, fp32 on the host."""
    flat = t.detach().reshape(-1)
    return flat[::max(1, flat.numel() // PAR_SAMPLE)].float().cpu()


def parallel_train_step(cfg, batch, counters, device, remat=True,
                        **mesh) -> dict:
    """One Trainer step of stage 2's mask (the LLM and the connector
    trained, bf16 with fp32 masters) from the seed-0 params, on a mesh of
    the given degrees when a process group is up (`batch` is the global
    batch): loss, launches, the trained tensors and their masters as they
    end (this rank's shards), and `samples`: for each trained leaf, whole
    (gathered on every rank), the _sample of its start, its Adam first
    moment and its master. remat: the LLM's policy (models/llm.forward),
    given to the step the Trainer runs."""
    from videollama2_tpu_torch.train import step as step_lib
    from videollama2_tpu_torch.train.optimizer import (OptimizerConfig,
                                                       entry_of, flatten,
                                                       trainable_mask)
    from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    params = synthetic_params(cfg, dtype=torch.bfloat16, device=device,
                              seed=0)
    ocfg = OptimizerConfig(learning_rate=1e-4, warmup_ratio=0.0)
    mask = trainable_mask(params, ocfg)
    init = {p: _sample(t) for p, t in flatten(params).items() if mask[p]}
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg, params, ocfg, TrainerConfig(
            output_dir=out_dir, per_device_batch_size=PAR_TRAIN_B,
            max_steps=1, log_steps=1, save_steps=10 ** 9,
            compute_dtype="bfloat16", **mesh), device=device)
        if remat is not True:
            trainer.step_fn = step_lib.make_train_step(
                cfg, trainer.tx, trainable_mask(trainer.state.params,
                                                trainer.opt_cfg),
                grad_accum=trainer.cfg.gradient_accumulation_steps,
                mesh=trainer.mesh,
                sequence_parallel=trainer.cfg.mesh_seq > 1, remat=remat)
        inner, got = trainer.step_fn, {}

        def step(state, b, *a):
            state, m = inner(state, b, *a)
            got.update(loss=float(m["loss"]), num_tokens=int(m["num_tokens"]))
            return state, m
        trainer.step_fn = step
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with state_saves({}, write=False):
            trainer.train(iter([batch]))
        torch.cuda.synchronize()
        got["step_s"] = time.perf_counter() - t0
    got["launches"] = {n: fn.launches for n, fn in counters.items()}
    state = trainer.state
    flat = flatten(state.params)
    got["trained"] = {p: t.detach() for p, t in flat.items() if mask[p]}
    got["masters"] = dict(state.opt_state["master"])
    got["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9

    def whole(p, t):
        if trainer.layout is None:
            return t
        return trainer.layout.unshard("/".join(p), t,
                                      entry_of(state.params, p))
    got["samples"] = {p: {"init": init[p],
                          "mu": _sample(whole(p, state.opt_state["mu"][p])),
                          "master": _sample(whole(p, got["masters"][p]))}
                      for p in init}
    return got


def compare_step(label, got, ref) -> dict:
    """Hold a sharded step to the unsharded one on the same batch (both
    parallel_train_step's): the loss, and each trained leaf's Adam first
    moment and fp32 update from their samples, under PAR_LOSS_REL_TOL,
    PAR_GRAD_REL_TOL and PAR_UPDATE_COS_MIN. Logs and returns the
    readings, with what is past a limit under "failed"."""
    loss_rel = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    grad_rel, cos = {}, {}
    for p, r in ref["samples"].items():
        g = got["samples"][p]
        name = "/".join(p)
        grad_rel[name] = ((g["mu"] - r["mu"]).norm()
                          / r["mu"].norm().clamp_min(1e-30)).item()
        d1, d2 = r["master"] - r["init"], g["master"] - g["init"]
        n1, n2 = d1.norm().item(), d2.norm().item()
        cos[name] = 1.0 if n1 == n2 == 0 else (
            (d1 @ d2).item() / max(n1 * n2, 1e-30))
    worst_g = max(grad_rel, key=grad_rel.get)
    worst_c = min(cos, key=cos.get)
    rec = {"loss": got["loss"], "unsharded_loss": ref["loss"],
           "loss_rel_diff": loss_rel, "leaves": len(grad_rel),
           "grad_rel_l2_max": grad_rel[worst_g], "grad_rel_l2_worst": worst_g,
           "grad_rel_l2_median": float(np.median(list(grad_rel.values()))),
           "update_cos_min": cos[worst_c], "update_cos_worst": worst_c,
           "grad_rel_l2": grad_rel, "update_cos": cos}
    log(f"[parallel] {label} step against the unsharded one: loss "
        f"{got['loss']:.6f} / {ref['loss']:.6f} (relative {loss_rel:.2e}, "
        f"limit {PAR_LOSS_REL_TOL:.0e}); {len(grad_rel)} trained leaves: "
        f"Adam first moment relative L2 max {grad_rel[worst_g]:.3e} "
        f"({worst_g}), median {rec['grad_rel_l2_median']:.3e} (limit "
        f"{PAR_GRAD_REL_TOL:.0e}); update cosine min {cos[worst_c]:.6f} "
        f"({worst_c}; limit {PAR_UPDATE_COS_MIN})")
    bad = [f"loss {loss_rel:.2e}"] if loss_rel > PAR_LOSS_REL_TOL else []
    bad += [f"{n} first moment {v:.3e}" for n, v in grad_rel.items()
            if not v <= PAR_GRAD_REL_TOL]
    bad += [f"{n} update cosine {v:.6f}" for n, v in cos.items()
            if not v >= PAR_UPDATE_COS_MIN]
    rec["failed"] = (f"parallel {label} step differs from the unsharded "
                     f"one: {'; '.join(bad[:8])}") if bad else None
    return rec


def parallel_generate(cfg, frames, prompt, bucket, counters, mesh=None):
    """A greedy generate of PAR_GEN_TOKENS tokens for the videos, on an
    Engine over the seed-0 params, sharded over `mesh` when given: (the
    tokens, the launches, the first token's logits from a second prefill
    of the same prompts)."""
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.parallel import sharding as sh
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    kw = dict(dtype=torch.bfloat16, max_len=bucket + PAR_GEN_TOKENS,
              buckets=(bucket,), decode_chunk=PAR_GEN_TOKENS)
    if mesh is None:
        eng = Engine(cfg, synthetic_params(cfg, dtype=torch.bfloat16,
                                           device="cuda", seed=0), **kw)
    else:
        with mesh:
            eng = Engine(cfg, synthetic_params(cfg, dtype=torch.bfloat16,
                                               device="cuda", seed=0),
                         shard_fn=lambda p: sh.shard_params(mesh, p, cfg),
                         **kw)
    for fn in counters.values():
        fn.launches = 0
    out = eng.generate([prompt] * len(frames), frames=eng.upload_frames(
        frames), gen=GenerationConfig(max_new_tokens=PAR_GEN_TOKENS),
        eos_token_id=-1)
    counts = {n: fn.launches for n, fn in counters.items()}
    with sh.use_mesh(eng.mesh), torch.inference_mode():
        cache = llm_lib.init_cache(eng.cache_cfg, len(frames), eng.max_len,
                                   eng.dtype, device=eng.device)
        last, _ = _prefill(eng, cfg, _plan_args(cfg, frames, prompt,
                                                eng.device, bucket), cache)
        logits = llm_lib.lm_logits(eng.params["llm"], cfg.llm, last)
    return out, counts, logits.float().cpu()


def parallel_rank(rank, world, store_dir, result_path) -> None:
    """A rank of the multi-device part (spawned, one card each): an fsdp 2
    Trainer step and a tensor 2 Engine generate."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.parallel import mesh as mesh_lib
    from videollama2_tpu_torch.utils.synthetic import synthetic_train_batch
    import torch.distributed as dist
    device = mesh_lib.init_distributed(
        "cuda", store=dist.FileStore(os.path.join(store_dir, "store"),
                                     world), rank=rank, world_size=world)
    cfg = parallel_config(cfglib)
    batch = synthetic_train_batch(cfg, np.random.default_rng(3),
                                  max(PAR_TRAIN_B, world), TRAIN_S,
                                  TRAIN_MIN_VALID)
    got = parallel_train_step(cfg, batch, kernel_counters(), device,
                              mesh_fsdp=world)
    gcfg = cfg.replace(num_frames=16)
    frames, prompt, bucket = slice_inputs(gcfg, PAR_GEN_B)
    tokens, _, logits = parallel_generate(
        gcfg, frames, prompt, bucket, kernel_counters(),
        mesh_lib.make_mesh(fsdp=1, tensor=world))
    if rank == 0:
        torch.save({"loss": got["loss"], "samples": got["samples"],
                    "tokens": tokens, "logits": logits}, result_path)
    dist.destroy_process_group()


def run_parallel_phase(counters, k1, k2, gen) -> tuple:
    """The "parallel" phase. World 1: a one-rank NCCL group in this
    process, a stage-2 Trainer step and a greedy generate at full width
    (Mistral-7B, 8 LLM layers) without a mesh and on the world-1 mesh
    (parallel/: rule table, shards, gathers, the sharded step's loss and
    gradient reductions, shard_fn), held bit-equal (the loss, every
    trained tensor and fp32 master, the tokens and first-token logits),
    with exact K1 / K2 / K8 / K9 counts; then K1, K2 (with and without its
    LSE), K8 and K9 at a rank's shapes under tensor 2 and 4 and Ulysses seq
    2 against their plain versions; with two devices or more, an fsdp 2
    step (compare_step) and a tensor 2 generate (compare_logits) on two
    ranks held to the unsharded results. Returns (the phase's record, its
    kernel rows, the sharded runs' launches)."""
    import torch.distributed as dist
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.parallel import mesh as mesh_lib
    from videollama2_tpu_torch.utils.synthetic import synthetic_train_batch
    t_phase = time.perf_counter()
    cfg = parallel_config(cfglib)
    L = cfg.llm.num_layers
    batch = synthetic_train_batch(cfg, np.random.default_rng(3), PAR_TRAIN_B,
                                  TRAIN_S, TRAIN_MIN_VALID)
    rec = {}
    # stage 2's step: without a mesh, then on the world-1 mesh
    torch.cuda.reset_peak_memory_stats()
    plain = parallel_train_step(cfg, batch, counters, "cuda")
    plain_step = {"loss": plain["loss"], "samples": plain.pop("samples")}
    plain_trained = {p: t.cpu() for p, t in plain.pop("trained").items()}
    plain_masters = {p: t.cpu() for p, t in plain.pop("masters").items()}
    gc.collect()
    torch.cuda.empty_cache()
    device = mesh_lib.init_distributed("cuda")
    try:
        torch.cuda.reset_peak_memory_stats()
        mesh_kw = dict(mesh_data=1, mesh_fsdp=1, mesh_tensor=1, mesh_seq=1)
        sharded = parallel_train_step(cfg, batch, counters, device,
                                      **mesh_kw)
        per_mb = {"encoder_attention": vit_layers(cfg)
                  * max(PAR_TRAIN_B * cfg.num_frames // 128, 1),
                  "flash_attention": 2 * L, "flash_attention_bwd_dq": L,
                  "flash_attention_bwd_dkv": L}
        want = dict.fromkeys(counters, 0)
        want.update(per_mb)
        for label, run in (("unsharded", plain), ("world-1 mesh", sharded)):
            log(f"[parallel] stage-2 Trainer step ({label}): loss "
                f"{run['loss']:.6f}, {run['num_tokens']} supervised tokens, "
                f"{run['step_s']:.2f} s, peak {run['peak_gb']:.1f} GB; "
                f"launches {run['launches']}")
            if run["launches"] != want:
                raise RuntimeError(f"parallel {label} step: launches "
                                   f"{run['launches']} != {want}")
        diffs = {}
        for p, t in sharded["trained"].items():
            a, b = t.cpu(), plain_trained[p]
            if not torch.equal(a, b):
                diffs["/".join(p)] = (a.float() - b.float()).abs().max().item()
        master_diffs = [p for p, t in sharded["masters"].items()
                        if not torch.equal(t.cpu(), plain_masters[p])]
        bit_equal = not diffs and not master_diffs \
            and sharded["loss"] == plain["loss"]
        log(f"[parallel] world-1 mesh vs unsharded: loss {sharded['loss']!r}"
            f" vs {plain['loss']!r}; {len(plain_trained)} trained tensors "
            f"and {len(plain_masters)} fp32 masters: "
            + ("bit-equal" if bit_equal else
               f"{len(diffs)} tensors differ (max "
               f"{max(diffs.values(), default=0):.3e}), "
               f"{len(master_diffs)} masters differ"))
        if not bit_equal:
            raise RuntimeError(
                f"parallel: the world-1 sharded step is not bit-equal to "
                f"the unsharded one (loss {sharded['loss']!r} vs "
                f"{plain['loss']!r}; tensors {sorted(diffs)[:5]}, masters "
                f"{['/'.join(p) for p in master_diffs[:5]]})")
        rec["train"] = {"loss": sharded["loss"], "unsharded_loss":
                        plain["loss"], "bit_equal": bit_equal,
                        "step_s": sharded["step_s"],
                        "unsharded_step_s": plain["step_s"],
                        "peak_gb": sharded["peak_gb"],
                        "launches": sharded["launches"]}
        del sharded, plain, plain_trained, plain_masters
        gc.collect()
        torch.cuda.empty_cache()

        # the sharded Engine (shard_fn) at world 1 against the plain Engine
        gcfg = cfg.replace(num_frames=16)
        frames, prompt, bucket = slice_inputs(gcfg, PAR_GEN_B)
        plain_tokens, _, plain_logits = parallel_generate(
            gcfg, frames, prompt, bucket, counters)
        gc.collect()
        torch.cuda.empty_cache()
        mesh = mesh_lib.make_mesh(fsdp=1)
        tokens, gen_counts, logits = parallel_generate(
            gcfg, frames, prompt, bucket, counters, mesh)
        want_gen = dict.fromkeys(counters, 0)
        want_gen.update(encoder_attention=vit_layers(gcfg) * max(
            PAR_GEN_B * gcfg.num_frames // 128, 1), flash_attention=L)
        log(f"[parallel] sharded Engine (world 1): launches {gen_counts}; "
            f"tokens {'equal' if tokens == plain_tokens else 'DIFFER'} to "
            f"the unsharded Engine's ({PAR_GEN_B} x {PAR_GEN_TOKENS}, first "
            f"row {tokens[0][:8]}...)")
        if gen_counts != want_gen:
            raise RuntimeError(f"parallel generate: launches {gen_counts} "
                               f"!= {want_gen}")
        if tokens != plain_tokens or not torch.equal(logits, plain_logits):
            raise RuntimeError("parallel: the world-1 sharded Engine's "
                               "tokens or first-token logits differ from "
                               "the unsharded Engine's")
        log("[parallel] world-1 first-token logits bit-equal to the "
            "unsharded Engine's")
        rec["generate"] = {"tokens_equal": True, "logits_bit_equal": True,
                           "launches": gen_counts}
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    launches = {n: rec["train"]["launches"][n] + rec["generate"]["launches"][n]
                for n in counters}

    # K1, K2, K8 and K9 at a rank's shapes
    rows = {}
    clip_s, sig_s = 577, 729
    tower = []
    for tp in (2, 4):
        for label, N, S, D in (("CLIP", 64, clip_s, 64),
                               ("SigLIP", 128, sig_s, 72)):
            qkv = tuple(rand_bf16(gen, (N, S, 16 // tp, D))
                        for _ in range(3))
            F = torch.nn.functional
            sq, sk, sv, _ = sdpa_args(*qkv, None, False)
            tower.append((f"{label} tensor {tp}: [{N},{S},{16 // tp},{D}]",
                          (qkv, {}), (tuple(t.float() for t in qkv), {}),
                          lambda f, qkv=qkv: (lambda: f(*qkv)),
                          (attention_bound(qkv[0], qkv[1], None, False, 2,
                                           qkv[0].nbytes),
                           lambda sq=sq, sk=sk, sv=sv:
                           F.scaled_dot_product_attention(sq, sk, sv))))
    rows["encoder_attention"] = check_kernel(
        "encoder_attention", k1.encoder_attention, k1.encoder_attention_plain,
        tower, K1_TOL)
    del tower
    torch.cuda.empty_cache()
    train_rows = {"flash_attention +lse": [], "flash_attention_bwd_dq": [],
                  "flash_attention_bwd_dkv": []}
    for label, B, S, H, K in PAR_TRAIN_SHAPES:
        got = check_training_attention(gen, k2, B=B, S=S, H=H, K=K,
                                       min_valid=S * 2 // 3,
                                       tag=f"{label}: ")
        for name, row in got.items():
            train_rows[name].append(row)
        gc.collect()
        torch.cuda.empty_cache()
    for name, r in train_rows.items():
        rows[name] = {"max_abs_err": max(x["max_abs_err"] for x in r),
                      "cases": r}
    rec["kernels_s"] = time.perf_counter() - t_phase

    # two ranks, one card each
    n_dev = torch.cuda.device_count()
    if n_dev < 2:
        log(f"[parallel] the multi-device part (fsdp 2 step, tensor 2 "
            f"generate on 2 NCCL ranks) needs 2 devices; found {n_dev}")
        rec["two_ranks"] = f"not run: needs 2 devices, found {n_dev}"
    else:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as d:
            result = os.path.join(d, "result.pt")
            ctx = mp.get_context("spawn")
            procs = [ctx.Process(target=parallel_rank,
                                 args=(r, 2, d, result)) for r in range(2)]
            for p in procs:
                p.start()
            for p in procs:
                p.join(PAR_TIMEOUT)
            for p in procs:
                if p.is_alive():
                    p.kill()
            if any(p.exitcode != 0 for p in procs):
                raise RuntimeError(f"parallel: two-rank part failed "
                                   f"({[p.exitcode for p in procs]})")
            two = torch.load(result)
        agree = [next((i for i, (a, b) in enumerate(zip(r2, r1)) if a != b),
                      len(r1)) for r2, r1 in zip(two["tokens"], plain_tokens)]
        log(f"[parallel] 2 ranks: tensor 2 tokens agree with the "
            f"unsharded Engine's for the first {agree} of "
            f"{PAR_GEN_TOKENS} a row")
        # tensor parallelism sums the o and down projections in another
        # order: the first-token logits move by rounding, and greedy
        # tokens may part at near-ties after it
        compare_logits("parallel tensor 2 first token", two["logits"],
                       plain_logits)
        step = compare_step("fsdp 2", two, plain_step)
        if step["failed"]:
            raise RuntimeError(step["failed"])
        rec["two_ranks"] = {"fsdp_2_step": step, "tokens_agree": agree}
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[parallel] phase {rec['phase_s']:.1f} s")
    return rec, rows, launches


PROJ_TYPES = ("linear", "mlp2x_gelu", "stp_connector", "spatial_pool",
              "spatial_conv")
PROJ_LAYERS = 8          # Mistral-7B's widths, 8 of its 32 LLM layers
PROJ_B, PROJ_CHECK_B = 16, 4
PROJ_TRAIN_B = 2         # stage 1: 2 videos of 8 frames at seq TRAIN_S
PROJ_TRAIN_STEPS = 2     # the first step carries one-time costs
PROJ_CONNECTOR_ITERS = 3
PROJ_TRACE_TYPE = "mlp2x_gelu"
# the stage-2 step under each policy (scripts/profile_torch_projectors.py
# runs the pair twice in turns)
REMAT_ORDER = (True, "dots")
# the kernels' symbols a device trace of a generate must hold (K1, K2)
TRACE_SYMBOLS = ("encoder_attention_pipelined_kernel",
                 "flash_attention_kernel")
TRACE_RANGES = ("encode", "prefill", "decode")


def projector_config(cfglib, projector_type: str, frames: int = 16):
    """VideoLLaMA2-7B at `frames` frames with its connector replaced by
    `projector_type` and the LLM cut to PROJ_LAYERS layers."""
    cfg = cfglib.preset("videollama2_mistral").replace(num_frames=frames)
    return cfg.replace(
        llm=dataclasses.replace(cfg.llm, num_layers=PROJ_LAYERS),
        connector=dataclasses.replace(cfg.connector,
                                      projector_type=projector_type))


def generate_launches(counters, cfg, B) -> dict:
    """A bf16 generate's launches: K1 for each tower chunk of each layer,
    K2 once a layer, every other kernel 0 (the bf16 decode is plain)."""
    want = dict.fromkeys(counters, 0)
    want.update(encoder_attention=vit_layers(cfg)
                * max(B * cfg.num_frames // 128, 1),
                flash_attention=cfg.llm.num_layers)
    return want


def step_launches(counters, cfg, B) -> dict:
    """A train step's launches under remat (True or "dots"): K1 for the
    frozen tower, K2 in the forward and again in the recompute, K8 and K9
    once a layer."""
    L = cfg.llm.num_layers
    want = dict.fromkeys(counters, 0)
    want.update(encoder_attention=vit_layers(cfg)
                * max(B * cfg.num_frames // 128, 1),
                flash_attention=2 * L, flash_attention_bwd_dq=L,
                flash_attention_bwd_dkv=L)
    return want


def traced_generate(eng, cfg, frames, prompt, counters, gcfg) -> dict:
    """One generate under utils/profiling.device_trace with annotate
    ranges around the encode (models/videollama2.encode_frames), the
    prefill (models/llm.prefill) and the decode (the Engine's
    _decode_tail): fails unless the trace holds K1's and K2's kernels and
    the three ranges."""
    from videollama2_tpu_torch.models import llm as llm_lib
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.utils import profiling

    def ranged(name, fn):
        def wrapped(*args, **kwargs):
            with profiling.annotate(name):
                return fn(*args, **kwargs)
        return wrapped
    saved = [(vl2, "encode_frames", vl2.encode_frames),
             (llm_lib, "prefill", llm_lib.prefill)]
    for (module, attr, fn), name in zip(saved, TRACE_RANGES):
        setattr(module, attr, ranged(name, fn))
    eng._decode_tail = ranged("decode", eng._decode_tail)
    want = generate_launches(counters, cfg, len(frames))
    try:
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            with profiling.device_trace(d):
                _, stats, counts = counted_call(
                    "projectors traced generate", counters, want,
                    lambda cb: eng.generate(
                        [prompt] * len(frames),
                        frames=eng.upload_frames(frames), gen=gcfg,
                        eos_token_id=-1, stream_cb=cb))
            trace_s = time.perf_counter() - t0
            path = os.path.join(d, profiling.TRACE_FILE)
            size = os.path.getsize(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
    finally:
        for module, attr, fn in saved:
            setattr(module, attr, fn)
        del eng._decode_tail
    names = [e.get("name", "") for e in events]
    kernels = {s: sum(s in n for n in names) for s in TRACE_SYMBOLS}
    ranges = {r: names.count(r) for r in TRACE_RANGES}
    device_events = sum(e.get("cat") == "kernel" for e in events)
    log(f"[projectors] traced generate ({len(frames)} x "
        f"{gcfg.max_new_tokens} tokens, device_trace + annotate): "
        f"{trace_s:.2f} s with the trace written ({size / 1e6:.1f} MB, "
        f"{len(events)} events, {device_events} device kernels); kernel "
        f"events {kernels}, ranges {ranges}; launches {counts}")
    if not all(kernels.values()) or not all(ranges.values()):
        raise RuntimeError(f"projectors: the device trace lacks K1's or "
                           f"K2's kernels or a range: {kernels}, {ranges}")
    return {"trace_s": trace_s, "trace_mb": size / 1e6,
            "events": len(events), "device_kernels": device_events,
            "kernel_events": kernels, "ranges": ranges,
            "generate": stats, "launches": counts}


def prefill_last(eng, cfg, frames, prompt, bucket) -> torch.Tensor:
    """The last valid token's hidden state [B, D] of a bf16 prefill of the
    videos (the input of the first token's head)."""
    from videollama2_tpu_torch.models import llm as llm_lib
    cache = llm_lib.init_cache(cfg.llm, len(frames), bucket, torch.bfloat16,
                               device=eng.device)
    last, _ = _prefill(eng, cfg, _plan_args(cfg, frames, prompt, eng.device,
                                            bucket), cache)
    return last


def projector_stage1_steps(cfg, params, batch, counters) -> dict:
    """PROJ_TRAIN_STEPS stage-1 Trainer steps (tune_mm_mlp_adapter: only
    the connector trains, bf16 with fp32 masters) over `params` (its
    connector cloned first): losses, each step's seconds (a sync on each
    side), peak, launches, and how many connector tensors' fp32 masters
    moved."""
    from videollama2_tpu_torch.train.optimizer import (OptimizerConfig,
                                                       flatten)
    from videollama2_tpu_torch.train.trainer import Trainer, TrainerConfig
    conn = {p: t.clone() for p, t in flatten(params["connector"]).items()}
    tree = {}
    for p, t in conn.items():
        node = tree
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = t
    start = {p: t.clone() for p, t in conn.items()}
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as out_dir:
        trainer = Trainer(cfg, dict(params, connector=tree), OptimizerConfig(
            learning_rate=1e-3, warmup_ratio=0.0, tune_mm_mlp_adapter=True),
            TrainerConfig(output_dir=out_dir,
                          per_device_batch_size=PROJ_TRAIN_B,
                          max_steps=PROJ_TRAIN_STEPS, log_steps=1,
                          save_steps=10 ** 9, compute_dtype="bfloat16"),
            device="cuda")
        inner, got = trainer.step_fn, {"loss": [], "step_s": []}

        def step(state, b, *a):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, m = inner(state, b, *a)
            got["loss"].append(float(m["loss"]))
            torch.cuda.synchronize()
            got["step_s"].append(time.perf_counter() - t0)
            return state, m
        trainer.step_fn = step
        for fn in counters.values():
            fn.launches = 0
        with state_saves({}, write=False):
            trainer.train(iter([batch] * PROJ_TRAIN_STEPS))
    got["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    got["launches"] = {n: fn.launches for n, fn in counters.items()}
    # the fp32 masters: an Adam step of lr 1e-3 on a norm's scale of 1 is
    # below half a bf16 ulp there, so its bf16 copy keeps its value
    masters = trainer.state.opt_state["master"]
    got["moved"] = sum(not torch.equal(masters[("connector",) + p],
                                       start[p].float()) for p in start)
    got["tensors"] = len(start)
    return got


def run_projectors_phase(counters, attn, k1, k2) -> tuple:
    """The "projectors" phase: VideoLLaMA2-7B's CLIP tower whole and 8 of
    Mistral-7B's 32 layers, seeded bf16 weights and cache, its connector
    replaced by each of PROJ_TYPES (the identity projector passes the
    tower's 1024 wide features to a 4096 wide LLM, which cannot be
    spliced: it runs on the CPU only, tests/test_torch_projectors.py).
    For each type: a B 16 generate of 16-frame I420 videos with exact K1
    / K2 counts, first-token logits against the plain attention, the rows
    of a B 4 generate against each video's B 1 generate (prefill hidden
    states, first-token logits, tokens: a difference must be a
    near-tie), the connector's ms at B 16 one media at a time
    beside STC's, and a stage-1 step of 2 videos x 8 frames at seq
    TRAIN_S (every connector tensor's fp32 master moved, finite losses),
    twice. Then one generate under
    utils/profiling.device_trace, and a stage-2 step under remat=True and
    one under "dots" (REMAT_ORDER; equal losses, and equal exact bit sums
    of every trained tensor and fp32 master). Returns (the phase's record,
    the launch counts of each counted run)."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.inference.engine import (Engine,
                                                        GenerationConfig)
    from videollama2_tpu_torch.models import videollama2 as vl2
    from videollama2_tpu_torch.train.optimizer import flatten
    from videollama2_tpu_torch.utils import profiling
    from videollama2_tpu_torch.utils.synthetic import (
        synthetic_connector_params, synthetic_params, synthetic_train_batch)
    timer = profiling.StageTimer()
    t_phase = time.perf_counter()
    rec, counts = {"identity": "not run on the card: its 1024 wide "
                   "features cannot be spliced into the 4096 wide LLM "
                   "(a ValueError naming both); tests/test_torch_"
                   "projectors.py runs it at equal widths on the CPU"}, {}
    log(f"[projectors] identity: {rec['identity']}")
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    with timer.stage("weights"):
        base_cfg = projector_config(cfglib, "stc_connector")
        base = synthetic_params(base_cfg, dtype=torch.bfloat16,
                                device="cuda", seed=0)
        torch.cuda.synchronize()
    frames, prompt, _ = slice_inputs(base_cfg, PROJ_B)
    with torch.inference_mode(), timer.stage("tower features"):
        feats = vl2.frame_features(base, base_cfg,
                                   torch.from_numpy(frames).cuda())
    train_cfg = projector_config(cfglib, "stc_connector", frames=8)
    train_rng = np.random.default_rng(4)
    rec["types"] = {}
    for pt in ("stc_connector",) + PROJ_TYPES:
        cfg = projector_config(cfglib, pt)
        conn = base["connector"] if pt == "stc_connector" else \
            synthetic_connector_params(cfg.connector, dtype=torch.bfloat16,
                                       device="cuda", seed=0)
        params = dict(base, connector=conn)
        with torch.inference_mode(), timer.stage("connector ms"):
            ms = cuda_ms(lambda: vl2.aggregate_each(params, cfg, feats),
                         iters=PROJ_CONNECTOR_ITERS)
        r = {"visual_tokens": cfg.tokens_per_video, "connector_b16_ms": ms,
             "connector_params_m": sum(t.numel() for t in _leaves(conn))
             / 1e6}
        rec["types"][pt] = r
        if pt == "stc_connector":
            log(f"[projectors] stc_connector (the preset's): connector "
                f"{ms:.2f} ms at B {PROJ_B}, one media at a time")
            continue
        _, _, bucket = slice_inputs(cfg, PROJ_B)
        r["bucket"] = bucket
        eng = Engine(cfg, params, dtype=torch.bfloat16,
                     max_len=bucket + NEW_TOKENS, buckets=(bucket,),
                     decode_chunk=NEW_TOKENS, kv_bits=16, device="cuda")
        with timer.stage("generate B 16"):
            out, stats, counts[f"projectors {pt}"] = counted_call(
                f"projectors {pt} B {PROJ_B}", counters,
                generate_launches(counters, cfg, PROJ_B),
                lambda cb: eng.generate(
                    [prompt] * PROJ_B, frames=eng.upload_frames(frames),
                    gen=gcfg, eos_token_id=-1, stream_cb=cb))
        toks = np.asarray(out)
        if toks.shape != (PROJ_B, NEW_TOKENS) or toks.min() < 0 \
                or toks.max() >= cfg.llm.vocab_size:
            raise RuntimeError(f"projectors {pt}: bad tokens {toks.shape}")
        r.update(first_token_s=stats["first_token_s"],
                 decode_ms_per_token=stats["ms_per_token"],
                 generate_s=stats["call_s"])
        with timer.stage("against plain"):
            check_against_plain(eng, cfg, frames[:2], prompt, bucket, attn,
                                k1, k2, label=f"projectors {pt}")
        with timer.stage("B 4 against B 1"), LogitTap() as tap:
            b4, _, _ = counted_call(
                f"projectors {pt} B {PROJ_CHECK_B}", counters,
                generate_launches(counters, cfg, PROJ_CHECK_B),
                lambda cb: eng.generate(
                    [prompt] * PROJ_CHECK_B,
                    frames=eng.upload_frames(frames[:PROJ_CHECK_B]),
                    gen=gcfg, eos_token_id=-1, stream_cb=cb), tap)
            b4_picks = list(tap.picks)
            b1 = []
            for v in range(PROJ_CHECK_B):
                o, _, _ = counted_call(
                    f"projectors {pt} B 1 video {v}", counters,
                    generate_launches(counters, cfg, 1),
                    lambda cb: eng.generate(
                        [prompt], frames=eng.upload_frames(frames[v:v + 1]),
                        gen=gcfg, eos_token_id=-1, stream_cb=cb), tap)
                b1.append((o[0], list(tap.picks)))
        first4 = b4_picks[0].float()
        first1 = torch.stack([p[0][0] for _, p in b1]).float()
        with torch.inference_mode():
            last4 = prefill_last(eng, cfg, frames[:PROJ_CHECK_B], prompt,
                                 bucket)
            last1 = torch.cat([prefill_last(eng, cfg, frames[v:v + 1],
                                            prompt, bucket)
                               for v in range(PROJ_CHECK_B)])
        r["b4_vs_b1"] = {
            "tokens_equal": [b4[v] == b1[v][0] for v in range(PROJ_CHECK_B)],
            "prefill_hidden_bit_equal": bool(torch.equal(last4, last1)),
            "first_logits_bit_equal": bool(torch.equal(first4, first1)),
            "first_logits_max_abs_diff":
                (first4 - first1).abs().max().item()}
        log(f"[projectors] {pt}: B {PROJ_CHECK_B} rows against B 1: "
            f"{r['b4_vs_b1']}")
        compare_logits(f"projectors {pt} first token B {PROJ_CHECK_B} vs "
                       f"B 1", first4, first1)
        held = check_tokens(f"projectors {pt} B {PROJ_CHECK_B} vs B 1",
                            [o for o, _ in b1], b4,
                            lambda b, p: b1[b][1][p][0],
                            lambda b, p: b4_picks[p][b])
        if not held["ok"]:
            raise RuntimeError(f"projectors {pt}: B {PROJ_CHECK_B} tokens "
                               f"differ from B 1 beyond a near-tie")
        del eng, b4_picks, b1
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = projector_config(cfglib, pt, frames=8)
        batch = synthetic_train_batch(tcfg, train_rng, PROJ_TRAIN_B, TRAIN_S,
                                      TRAIN_MIN_VALID)
        with timer.stage("stage-1 steps"):
            step = projector_stage1_steps(tcfg, params, batch, counters)
        counts[f"projectors {pt} stage-1 steps"] = step["launches"]
        want = {n: PROJ_TRAIN_STEPS * c for n, c in step_launches(
            counters, tcfg, PROJ_TRAIN_B).items()}
        r["stage1_steps"] = {k: step[k] for k in ("loss", "step_s",
                                                  "peak_gb", "moved",
                                                  "tensors")}
        log(f"[projectors] {pt}: {PROJ_TRAIN_STEPS} stage-1 steps "
            f"({PROJ_TRAIN_B} x {tcfg.num_frames} frames, "
            f"{tcfg.tokens_per_video} visual tokens a video, seq "
            f"{TRAIN_S}): losses {step['loss']}, "
            f"{[round(x, 3) for x in step['step_s']]} s, peak "
            f"{step['peak_gb']:.1f} GB, {step['moved']} of "
            f"{step['tensors']} connector tensors' fp32 masters moved; "
            f"launches {step['launches']} (want {want})")
        if step["launches"] != want or not all(map(math.isfinite,
                                                   step["loss"])) \
                or step["moved"] != step["tensors"]:
            raise RuntimeError(f"projectors {pt}: stage-1 steps wrong")
        log(f"[projectors] {pt}: {cfg.tokens_per_video} visual tokens a "
            f"video, bucket {bucket}; first token "
            f"{r['first_token_s']:.3f} s, decode "
            f"{r['decode_ms_per_token']:.2f} ms/token; connector "
            f"{ms:.2f} ms at B {PROJ_B} (stc_connector "
            f"{rec['types']['stc_connector']['connector_b16_ms']:.2f})")
        del params, conn, batch
        gc.collect()
        torch.cuda.empty_cache()

    # one generate under the profiler
    cfg = projector_config(cfglib, PROJ_TRACE_TYPE)
    _, _, bucket = slice_inputs(cfg, PROJ_B)
    params = dict(base, connector=synthetic_connector_params(
        cfg.connector, dtype=torch.bfloat16, device="cuda", seed=0))
    eng = Engine(cfg, params, dtype=torch.bfloat16,
                 max_len=bucket + NEW_TOKENS, buckets=(bucket,),
                 decode_chunk=NEW_TOKENS, kv_bits=16, device="cuda")
    with timer.stage("traced generate"):
        rec["trace"] = traced_generate(eng, cfg, frames, prompt, counters,
                                       gcfg)
    counts["projectors traced generate"] = rec["trace"].pop("launches")
    del eng, params, base, feats
    gc.collect()
    torch.cuda.empty_cache()

    # remat="dots" against remat=True: a stage-2 step each, compared by the
    # loss and each trained tensor's and fp32 master's exact bit sum (the
    # tensors themselves are dropped before the next run, so each run's
    # peak is its own)
    with timer.stage("remat pair"):
        batch = synthetic_train_batch(train_cfg, np.random.default_rng(3),
                                      PAR_TRAIN_B, TRAIN_S, TRAIN_MIN_VALID)
        runs = []
        for remat in REMAT_ORDER:
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            run = parallel_train_step(train_cfg, batch, counters, "cuda",
                                      remat=remat)
            run["remat"] = remat
            for key in ("trained", "masters"):
                paths = sorted(run[key])
                run[key] = dict(zip(paths, _checksums(
                    [run[key][p] for p in paths])))
            runs.append(run)
            counts[f"projectors remat {remat} step {len(runs)}"] = \
                run["launches"]
    want = step_launches(counters, train_cfg, PAR_TRAIN_B)
    ref = runs[0]
    rec["remat"] = {"runs": [], "bit_equal": True}
    for run in runs:
        differ = [p for key in ("trained", "masters")
                  for p, c in run[key].items() if c != ref[key][p]]
        bit_equal = not differ and run["loss"] == ref["loss"]
        rec["remat"]["runs"].append({
            "remat": run["remat"], "loss": run["loss"],
            "step_s": run["step_s"], "peak_gb": run["peak_gb"],
            "bit_equal_to_first": bit_equal})
        rec["remat"]["bit_equal"] &= bit_equal
        log(f"[projectors] stage-2 step ({PAR_TRAIN_B} x "
            f"{train_cfg.num_frames} frames, seq {TRAIN_S}, {PROJ_LAYERS} "
            f"LLM layers), remat={run['remat']!r}: loss {run['loss']!r}, "
            f"{run['step_s']:.3f} s, peak {run['peak_gb']:.1f} GB; "
            f"{len(run['trained'])} trained tensors' and fp32 masters' bit "
            f"sums " + ("equal to the first run's" if bit_equal else
                        f"differ from the first run's: {len(differ)} "
                        f"({['/'.join(p) for p in differ[:5]]})"))
        if run["launches"] != want:
            raise RuntimeError(f"projectors remat {run['remat']}: launches "
                               f"{run['launches']} != {want}")
    if not rec["remat"]["bit_equal"]:
        raise RuntimeError("projectors: the remat=\"dots\" steps are not "
                           "bit-equal to the remat=True ones")
    del runs, ref, batch
    gc.collect()
    torch.cuda.empty_cache()
    rec["stage_timer"] = timer.summary()
    rec["phase_s"] = time.perf_counter() - t_phase
    log(f"[projectors] StageTimer: {json.dumps(rec['stage_timer'])}")
    log(f"[projectors] phase {rec['phase_s']:.1f} s")
    return rec, counts


# the "drivers" phase: the serving path's timing drivers at full width, at
# reduced counts (DRIVER_SPEC_TOKENS tokens a speculative run, one timed
# iteration of everything)
DRIVER_SPEC_TOKENS = 32
DRIVER_SPEC_B = 8


def _import_script(name: str):
    """A module of scripts/ (the port's driver scripts), imported by its
    file name."""
    scripts = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "scripts")
    if scripts not in sys.path:
        # last: scripts/ holds directories (torch/, eval/) that must not
        # shadow packages
        sys.path.append(scripts)
    return __import__(name)


def run_drivers_phase(counters) -> tuple:
    """The "drivers" phase: the functions of scripts/bench_session_torch.py,
    bench_speculative_torch.py, profile_torch_components.py and
    profile_torch_kernels.py at full width on the card, each Engine call
    or stage through counted_call with exact launch counts (a session's
    turn 1 of 16 tokens K1 23, K2 32, K3 480, K4 960, K5 480; a continued
    turn no K1 or K2; the speculative bench's 64-token text prompt no K1
    or K2, and its speculative generates, whose budget suffices, no
    K3-K5; a decode chunk of 32 steps at B 8 K3 1024, K4 2048, K5 1024).
    The two bench scripts share one tree (int8 LLM packs, bf16 tower,
    seed 0); their speculative runs go through check_tokens. Returns
    each script's numbers and the launch counts of each call."""
    bst = _import_script("bench_session_torch")
    bsp = _import_script("bench_speculative_torch")
    comp = _import_script("profile_torch_components")
    kern = _import_script("profile_torch_kernels")
    out, counts = {}, {}

    def hook_for(name, wants):
        def hook(label, fn):
            res, _, counts[f"drivers {name} {label}"] = counted_call(
                f"drivers {name} {label}", counters, wants(label),
                lambda cb: fn())
            return res
        return hook

    def want(**per_kernel):
        w = dict.fromkeys(counters, 0)
        w.update(per_kernel)
        return w

    t0 = time.perf_counter()
    cfg, params, dtype = bst.build("7b", "cuda")
    frames, prompt1, turn2, bucket = bst.inputs(cfg, True)
    eng = bst.engine(cfg, params, dtype, "cuda", bucket)
    del params
    steps = bst.NEW_TOKENS - 1
    sess = bst.run(eng, frames, prompt1, turn2, iters=1, hook=hook_for(
        "session", lambda label: phase_launches(
            counters, cfg, 1, label == "turn 1", steps, True)))
    out["session"] = {k: v for k, v in sess.items()
                      if not k.endswith("_tokens")}
    out["session"].update(bucket=bucket, turn2_speedup_vs_fresh=(
        sess["turn1_fresh_s"] / sess["turn2_cached_s"]))
    log(f"[drivers] session: turn 1 {sess['turn1_fresh_s']:.3f} s, turn 2 "
        f"{sess['turn2_cached_s']:.3f} s (bucket {bucket})")
    spec_eng = bsp.engine(cfg, eng.params, dtype, "cuda", DRIVER_SPEC_TOKENS)
    del eng
    spec = bsp.run(
        spec_eng, cfg, DRIVER_SPEC_TOKENS, DRIVER_SPEC_B, iters=1,
        # the 64-token prompt prefills on the plain attention (under 128
        # queries, the JAX package's routing rule): no K2
        hook=hook_for("speculative", lambda label: phase_launches(
            counters, cfg, DRIVER_SPEC_B if "B=" in label else 1, False,
            DRIVER_SPEC_TOKENS - 1 if label.startswith("plain") else 0,
            True)),
        check=bsp.near_ties(spec_eng, cfg))
    out["speculative"] = dict(spec["results"], runs={
        label: {k: v for k, v in r.items() if k not in ("tokens", "record")}
        for label, r in spec["runs"].items()})
    del spec_eng, spec
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[drivers] bench scripts: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    L = cfg.llm.num_layers
    per_chunk = dict(decode_attention=comp.STEPS * L,
                     matmul_q8_layered=2 * comp.STEPS * L,
                     ffn_q8_layered=comp.STEPS * L)
    # warm-up + one timed call a stage; the decode chunk once more on the
    # device clock
    stage_wants = {
        "vit": want(encoder_attention=2 * vit_layers(cfg)
                    * (8 * cfg.num_frames // 128)),
        "conn": want(),
        "prefill w8a8=0": want(flash_attention=2 * L),
        "prefill w8a8=1": want(flash_attention=2 * L),
        "decode": want(**{k: 3 * v for k, v in per_chunk.items()})}
    out["components"] = comp.run(
        ["vit", "conn", "prefill", "decode"], "cuda", w8a8=(False, True),
        iters=1, decode_iters=1,
        hook=hook_for("components", stage_wants.__getitem__))
    gc.collect()
    torch.cuda.empty_cache()
    out["kernels"] = kern.run(
        "cuda", iters=1, scan_iters=1, hook=hook_for(
            "kernels", {"null dispatch": want(),
                        "one layer": want(matmul_q8_layered=3 * 4,
                                          ffn_q8_layered=3),
                        "32 layers": want(matmul_q8_layered=3 * 4 * L,
                                          ffn_q8_layered=3 * L)}
            .__getitem__))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[drivers] profile scripts: {time.perf_counter() - t0:.1f} s")
    return out, counts


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
    smi = card()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    import jinja2  # the tokenizer reader's chat templates (torch needs it)
    log(f"jinja2 {jinja2.__version__} (chat templates of the port's "
        f"tokenizer reader, multimodal/hf_tokenizer.py)")
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

    # the api phases' checkpoints, written first: the "train entry" phase
    # reads them as plain LLM and tower directories
    api_dir = tempfile.TemporaryDirectory()
    api_written = write_api_checkpoint(api_dir.name)
    api_av_dir = tempfile.TemporaryDirectory()
    api_av_written = write_api_av_checkpoint(api_av_dir.name)
    gc.collect()
    torch.cuda.empty_cache()

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

    # -- the "train entry" phase: train/train.py as the recipes launch it ----
    # (child processes, run first so that this process holds no more than
    # its CUDA context beside them; the api checkpoints' tensors in plain
    # directories)
    entry, entry_counts = run_train_entry_phase(api_dir.name,
                                                api_av_dir.name, counters)
    log(json.dumps({"train entry": entry}))

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
                                 QWEN2_BUCKET, (("int8", None),))
        + decode_attention_cases(gen, _quantize_kv_rows, k3, 32, 32,
                                 BUCKET, (("int8", None), ("bf16", None))),
        K3_TOL)
    gc.collect()
    torch.cuda.empty_cache()
    # K4/K5 at Mistral-7B's, Qwen2-7B's and Llama-2-7B's widths; K6/K7
    # (int4, a Mistral slice only) at Mistral-7B's, and also at Qwen2-7B's
    # as kernel cases (widths: D, qkv out, F)
    for mm, ffn, mm_layers, quantize, library, widths in (
            ("matmul_q8_layered", "ffn_q8_layered", 4,
             lambda w: tuple(quantize_int8(w, axis=-2).values()),
             lambda x, q, s: int8pack_library(x, q, s, dk._mm_plain),
             ((4096, 6144, 14336), (3584, 4608, 18944),
              (4096, 12288, 11008))),
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

    # -- the seven serving slices at full width -----------------------------
    B = 16
    gcfg = GenerationConfig(max_new_tokens=NEW_TOKENS)
    steps = NEW_TOKENS - 1
    stages, slice_counts, spec_stages = {}, {}, {}
    for slice_name, preset, bits, int8_embed in (
            ("bf16 slice", "videollama2_mistral", None, False),
            ("int8 slice", "videollama2_mistral", 8, False),
            ("int4 slice", "videollama2_mistral", 4, False),
            ("2.1 bf16 slice", "videollama2_qwen2", None, False),
            ("2.1 int8 slice", "videollama2_qwen2", 8, True),
            ("2.1 int4 slice", "videollama2_qwen2", 4, True),
            ("llama int8 slice", "videollama2_llama", 8, False)):
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
    # -- VideoLLaMA2-8x7B: the Mixtral MoE decoder ----------------------------
    slice_counts["mixtral slice"], stages["mixtral slice"] = \
        run_mixtral_slice(counters, attn, k1, k2)
    gc.collect()
    torch.cuda.empty_cache()
    mixtral_api, slice_counts["mixtral api mm_infer"] = \
        run_mixtral_api_phase(counters, attn, k1, k2)
    log(json.dumps({"mixtral api": mixtral_api}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    log(json.dumps({"stages": stages}))
    log(json.dumps({"speculative": spec_stages}))

    # -- the "drivers" phase: the serving path's timing drivers ----------------
    t0 = time.perf_counter()
    drivers, driver_counts = run_drivers_phase(counters)
    drivers["phase_s"] = time.perf_counter() - t0
    slice_counts.update(driver_counts)
    log(json.dumps({"drivers": drivers}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the public API on a released-layout checkpoint ----------------------
    # (the checkpoint stays for the "lora" phase's model_base)
    api_stage, api_counts = run_api_phase(api_dir.name, api_written,
                                          counters, attn, k1, k2, k3, dk)
    slice_counts.update({f"api {n}": c for n, c in api_counts.items()})
    log(json.dumps({"api": api_stage}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- the "eval" phase: the evaluation harness on the api checkpoint -------
    eval_stage, eval_counts = run_eval_phase(api_dir.name, counters, smi, k3,
                                             dk)
    slice_counts.update({f"eval {n}": c for n, c in eval_counts.items()})
    eval_total = {n: sum(c[n] for c in eval_counts.values())
                  for n in counters}
    log(json.dumps({"eval": eval_stage}))
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    api_av_stage, api_av_counts = run_api_av_phase(
        api_av_dir.name, api_av_written, counters, attn, k1, k2, k3, dk)
    api_av_dir.cleanup()
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
    log(json.dumps({"lora": lora}))
    gc.collect()
    torch.cuda.empty_cache()

    api_dir.cleanup()
    slice_counts.update({f"train entry {n}": c
                         for n, c in entry_counts.items()})

    # -- the "parallel" phase: the mesh, the sharded step and Engine -------
    torch.cuda.reset_peak_memory_stats()
    par, par_rows, par_launches = run_parallel_phase(counters, k1, k2, gen)
    log(json.dumps({"parallel": par}))
    gc.collect()
    torch.cuda.empty_cache()

    # -- the "projectors" phase: the other connector types, remat="dots",
    # utils/profiling --------------------------------------------------------
    torch.cuda.reset_peak_memory_stats()
    proj, proj_counts = run_projectors_phase(counters, attn, k1, k2)
    slice_counts.update(proj_counts)
    log(json.dumps({"projectors": proj}))
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
                "launches_eval": eval_total[
                    "decode_attention" if name == "decode_attention_layered"
                    else name],
                **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                         "bound_by", "library_ms")},
                "cases": r["cases"], **extra}

    def train_entry(name, key, source, replaces, **extra):
        return {"name": name, "route": "cuda",
                "source": f"videollama2_tpu_torch/csrc/{source}",
                "replaces": f"videollama2_tpu/ops/{replaces}",
                "launches": want[name], "launches_lora_run": want_lora[name],
                "launches_eval": eval_total[name],
                "launches_train_entry": {r: c[name] for r, c in
                                         entry_counts.items()},
                "launches_by_slice": by_slice(name),
                **train_kernels[key], **extra}

    def registers(kernel):
        return {n: u for n, (u, _) in ptxas.items()
                if n.startswith(kernel + " ")}

    lse = train_kernels["flash_attention +lse"]
    # launches: each kernel's count in the run of the first slice whose
    # path runs it (K10: its own path; matmul_q8 is on no path: 0, checked
    # in every slice); launches_by_slice: every serving slice's counts;
    # launches_eval: its launches over the eval phase's in-process calls
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
    for name, row, source, replaces in (
            ("encoder_attention", "encoder_attention", "encoder_attention.cu",
             "encoder_attention.py:230"),
            ("flash_attention", "flash_attention +lse", "flash_attention.cu",
             "flash_attention.py:179"),
            ("flash_attention_bwd_dq", "flash_attention_bwd_dq",
             "flash_attention_bwd.cu", "flash_attention.py:352"),
            ("flash_attention_bwd_dkv", "flash_attention_bwd_dkv",
             "flash_attention_dkv.cu", "flash_attention.py:383")):
        r = par_rows[row]
        first = r["cases"][0]
        kernels.append({
            "name": f"{name} (parallel phase: a rank's shapes)",
            "route": "cuda", "source": f"videollama2_tpu_torch/csrc/{source}",
            "replaces": f"videollama2_tpu/ops/{replaces}",
            "launches": par_launches[name],
            "launches_parallel": {"train step": par["train"]["launches"][name],
                                  "generate": par["generate"]["launches"][
                                      name]},
            "max_abs_err": r["max_abs_err"],
            **{k: first[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "library_ms")},
            "cases": r["cases"]})
    log(f"[total] {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
