#!/usr/bin/env python3
"""Per-stage timing of bench.py's workload on the PyTorch port, each stage
on its own (port of scripts/profile_components.py): the tower's encode
(models/vit.features), the STC connector (models/connector.apply), the
LLM prefill (models/llm.forward) with and without W8A8, and a decode
chunk of 32 steps (models/llm.decode_step, which takes the layered
kernels K3-K5 on int8 packs).

Weights are the JAX script's constant fills, built on the device: every
floating leaf 0.01, the LLM's projections int8 packs of ones with scales
1e-4 (fp32), its head floating, the tower floating (VIT_Q8=1: the
tower's linears quantized to int8 packs by ops/quant, run W8A8). The
stages only time; a constant tree times as a random one does. Inputs:
B videos of 16 frames (uint8 / 255), connector features 0.1, prefill
embeddings 0.1 with every row valid to S - 100, decode from token 0 over
an empty cache of bucket + 32 rows (bucket 2048) with bucket - 100 valid
prompt rows.

Every stage prints the host clock: a stage's calls are enqueued and the
device synchronized once (the JAX script's method; warm-up calls first).
The decode chunk also prints its device time from CUDA events: each step
behind a spin kernel sized to cover the step's enqueue
(chip_smoke.spin_timed_ms), so that the events hold the step's kernels
without the host's gaps between launches, and the gap between the two
clocks is the time the device waits on the host. The line says how many
steps' enqueue the spin covered: where the launch queue fills before the
spin ends, the rest of the step is enqueued while it runs, and the
events' sum is an upper bound of the device time. TF/s are shares of the
H100's 989 TFLOP/s (dense bf16), weight streams of its 3.35 TB/s
(PERF.md §6's bounds).

Settings (the JAX script's): STAGES=vit,conn,prefill,decode (a subset
runs alone, in this order), VIT_Q8=1, PREFILL_B (default B), PREFILL_S
(default 2048), W8A8=0,1 (the prefill's dequantize branch, its W8A8
branch, or both in turn), B (default 8: videos and decode rows; the
default path of scripts/profile_decode.py), FUSEQKV (default 1: the
port's decoder takes the fused qkv layout only, so FUSEQKV=0 raises).
On a GPU the model is VideoLLaMA2-7B-16F at full width (CLIP-L/336 +
STC + Mistral-7B, bf16). PLATFORM=cpu runs core/config.tiny_model in fp32
on the CPU (B 2 of its 4 frames, S and bucket 128); without a GPU and without
PLATFORM=cpu the script raises.

Usage, from the repository root:

    python3 scripts/profile_torch_components.py        # on a CUDA GPU
    STAGES=prefill W8A8=0,1 python3 scripts/profile_torch_components.py
    PLATFORM=cpu python3 scripts/profile_torch_components.py
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

STEPS = 32               # a decode chunk
PACKED = ("qkv", "o", "gate", "up", "down")


def setup(device: str) -> dict:
    """The model and default shapes: VideoLLaMA2-7B-16F in bf16 on a GPU,
    the tiny config in fp32 on the CPU."""
    from videollama2_tpu_torch.core import config as cfglib
    if device == "cuda":
        cfg = cfglib.preset("videollama2_mistral").replace(num_frames=16)
        return dict(cfg=cfg, dtype=torch.bfloat16, S=2048, bucket=2048, B=8)
    return dict(cfg=cfglib.tiny_model(), dtype=torch.float32, S=128,
                bucket=128, B=2)


def _fill(spec: dict, dtype, device) -> dict:
    return {k: _fill(v, dtype, device) if isinstance(v, dict)
            else torch.full(v, 0.01, dtype=dtype, device=device)
            for k, v in spec.items()}


def vit_params(cfg, dtype, device, q8: bool = False) -> dict:
    """The tower's constant fills; q8: its linears as int8 packs."""
    from videollama2_tpu_torch.models import vit
    from videollama2_tpu_torch.ops import quant
    params = _fill(vit.param_shapes(cfg.vision), dtype, device)
    return quant.quantize_vision_params(params) if q8 else params


def connector_params(cfg, dtype, device) -> dict:
    from videollama2_tpu_torch.models import connector
    return _fill(connector.param_shapes(cfg.connector), dtype, device)


def llm_params(cfg, dtype, device) -> dict:
    """The LLM's constant fills with its projections as int8 packs (ones,
    fp32 scales 1e-4) and its head floating, in the port's one layer
    layout (the fused qkv: the JAX script's FUSEQKV=1)."""
    from videollama2_tpu_torch.models import llm
    spec = llm.param_shapes(cfg.llm)
    kernels = {name: spec["layers"][name].pop("kernel") for name in PACKED}
    params = _fill(spec, dtype, device)
    for name, shape in kernels.items():
        params["layers"][name]["kernel_q8"] = {
            "q": torch.ones(shape, dtype=torch.int8, device=device),
            "scale": torch.full(shape[:-2] + (1, shape[-1]), 1e-4,
                                dtype=torch.float32, device=device)}
    return params


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, device, iters: int = 3, warmup: int = 1):
    """(seconds a call, the last call's output): warm-up calls, each
    synchronized, then `iters` calls and one synchronize."""
    for _ in range(warmup):
        fn()
        _sync(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn()
    _sync(device)
    return (time.perf_counter() - t0) / iters, out


def vit_flops(cfg, frames: int) -> float:
    v = cfg.vision
    S, D, F_ = v.seq_len, v.hidden_size, v.intermediate_size
    layers = v.select_layer % (v.num_layers + 1)
    return frames * layers * (4 * S * D * D * 2 + 2 * S * S * D * 2
                              + 2 * S * D * F_ * 2)


def run_vit(cfg, vparams, pixels, q8: bool, iters: int = 3,
            warmup: int = 1):
    """The tower over pixels [N, H, W, 3] -> (s, features)."""
    from videollama2_tpu_torch.models import vit
    with torch.inference_mode():
        return timeit(lambda: vit.features(vparams, cfg.vision, pixels,
                                           w8a8=q8),
                      pixels.device, iters, warmup)


def run_conn(cfg, cparams, feats, iters: int = 3, warmup: int = 1):
    """The connector over features [B, T, N, D] -> (s, tokens)."""
    from videollama2_tpu_torch.models import connector
    with torch.inference_mode():
        return timeit(lambda: connector.apply(cparams, cfg.connector, feats),
                      feats.device, iters, warmup)


def prefill_inputs(cfg, B: int, S: int, dtype, device):
    """Embeddings 0.1 [B, S, D], positions 0..S-1, valid_len S - 100."""
    embeds = torch.full((B, S, cfg.llm.hidden_size), 0.1, dtype=dtype,
                        device=device)
    positions = torch.arange(S, dtype=torch.int32,
                             device=device).expand(B, S)
    valid = torch.full((B,), S - 100, dtype=torch.int32, device=device)
    return embeds, positions, valid


def run_prefill(cfg, lparams, embeds, positions, valid, w8a8: bool,
                iters: int = 3, warmup: int = 1):
    """The LLM's forward over the whole sequence -> (s, hidden)."""
    from videollama2_tpu_torch.models import llm
    with torch.inference_mode():
        return timeit(lambda: llm.forward(lparams, cfg.llm, embeds,
                                          positions, valid, w8a8=w8a8),
                      embeds.device, iters, warmup)


def matmul_weights(lparams) -> int:
    """Weights a token meets in the LLM's products (layers and head)."""
    layers = lparams["layers"]
    n = sum(layers[name]["kernel_q8"]["q"].numel() for name in PACKED)
    return n + lparams["lm_head"]["kernel"].numel()


def weight_bytes(lparams) -> int:
    """Bytes a decode step reads of the weights: every leaf but the
    embedding, of which it gathers B rows."""
    def leaves(t):
        for v in t.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    return sum(t.nbytes for k, v in lparams.items() if k != "embed"
               for t in leaves(v))


def run_decode(cfg, lparams, B: int, bucket: int, dtype, iters: int = 4,
               steps: int = STEPS, device_clock: bool = True) -> dict:
    """Decode chunks of `steps` greedy steps from token 0 over a bf16 (the
    dtype's) cache of bucket + 32 rows, valid_len bucket - 100, the cache
    carried from chunk to chunk (each chunk rewrites rows bucket + 0..31,
    as the JAX script's donated scan does): one warm-up chunk, `iters`
    timed on the host clock, and on a GPU with device_clock one more
    whose steps are timed by CUDA events behind a spin kernel. Returns
    the host seconds a chunk, the device ms a chunk (None on the CPU)
    and the steps whose enqueue the spin covered (where it did not, the
    step's events hold host gaps too: the sum is then an upper bound),
    and the last chunk's tokens, logits and cache."""
    from videollama2_tpu_torch.models import llm
    device = lparams["final_norm"]["scale"].device
    state = {"tok": torch.zeros((B,), dtype=torch.long, device=device),
             "cache": llm.init_cache(cfg.llm, B, bucket + 32, dtype,
                                     device=device)}
    valid = torch.full((B,), bucket - 100, dtype=torch.int32, device=device)

    def step(s):
        te = llm.embed_tokens(lparams, state["tok"][:, None], dtype)
        logits, state["cache"] = llm.decode_step(
            lparams, cfg.llm, te, state["cache"], valid, bucket, s,
            w8a8=True)
        state["tok"], state["logits"] = torch.argmax(logits, -1), logits

    def chunk():
        for s in range(steps):
            step(s)

    out = {"device_ms": None, "covered": None}
    with torch.inference_mode():
        chunk()
        state["tok"].tolist()
        t0 = time.perf_counter()
        for _ in range(iters):
            chunk()
        state["tok"].tolist()
        out["host_s"] = (time.perf_counter() - t0) / iters
        if device.type == "cuda" and device_clock:
            host_step_ms = out["host_s"] / steps * 1e3
            timed = [cs.spin_timed_ms(lambda s=s: step(s), host_step_ms)
                     for s in range(steps)]
            out["device_ms"] = sum(ms for ms, _ in timed)
            out["covered"] = sum(c for _, c in timed)
    out.update(tokens=state["tok"], logits=state["logits"],
               cache=state["cache"])
    return out


def run(stages, device: str, B=None, vit_q8: bool = False,
        w8a8=(False,), prefill_b=None, prefill_s=None, iters: int = 3,
        decode_iters: int = 4, hook=None) -> dict:
    """The JAX script's stages in order, each through hook(label, fn)
    (fn() by default; labels "vit", "conn", "prefill w8a8=0" / "=1",
    "decode"): a stage runs its call once to warm up and `iters` more
    timed (the decode chunk decode_iters, plus one on CUDA events on a
    GPU). B (videos and decode rows), prefill_b and prefill_s default to
    the size's (setup). Prints the JAX script's lines; returns their
    numbers."""
    hook = hook or (lambda label, fn: fn())
    dev = torch.device(device)
    st = setup(device)
    cfg, dtype = st["cfg"], st["dtype"]
    B = B or st["B"]
    T = cfg.num_frames
    H = cfg.vision.image_size
    out = {}
    if "vit" in stages:
        q8 = vit_q8
        vparams = vit_params(cfg, dtype, dev, q8)
        rng = np.random.default_rng(0)
        pixels = (torch.from_numpy(rng.integers(0, 255, (B * T, H, H, 3),
                                                dtype=np.uint8))
                  .to(dev).float() / 255.0).to(dtype)
        t, _ = hook("vit", lambda: run_vit(cfg, vparams, pixels, q8, iters))
        fl = vit_flops(cfg, B * T)
        out["vit_ms"] = t * 1e3
        print(f"ViT encode {B * T}f{' int8' if q8 else ''}: {t * 1e3:.1f} "
              f"ms ({fl / t / 1e12:.1f} TF/s, "
              f"{fl / t / cs.PEAK_BF16_FLOPS:.1%} of 989)", flush=True)
        del vparams, pixels
    if "conn" in stages:
        cparams = connector_params(cfg, dtype, dev)
        n = (H // cfg.vision.patch_size) ** 2
        feats = torch.full((B, T, n, cfg.vision.hidden_size), 0.1,
                           dtype=dtype, device=dev)
        t, _ = hook("conn", lambda: run_conn(cfg, cparams, feats, iters))
        out["conn_ms"] = t * 1e3
        print(f"STC connector: {t * 1e3:.1f} ms", flush=True)
        del cparams, feats
    lparams = None
    if "prefill" in stages or "decode" in stages:
        lparams = llm_params(cfg, dtype, dev)
    if "prefill" in stages:
        PB, S = prefill_b or B, prefill_s or st["S"]
        args = prefill_inputs(cfg, PB, S, dtype, dev)
        impl = "K2" if device == "cuda" else "plain"
        fl = PB * S * matmul_weights(lparams) * 2
        for w in w8a8:
            t, _ = hook(f"prefill w8a8={int(w)}", lambda: run_prefill(
                cfg, lparams, *args, w, iters))
            out[f"prefill_w8a8_{int(w)}_ms"] = t * 1e3
            print(f"prefill B={PB} S={S} ({impl}{', w8a8' if w else ''})"
                  f": {t * 1e3:.1f} ms ({fl / t / 1e12:.1f} TF/s, "
                  f"{fl / t / cs.PEAK_BF16_FLOPS:.1%} of 989)", flush=True)
        del args
    if "decode" in stages:
        d = hook("decode", lambda: run_decode(cfg, lparams, B, st["bucket"],
                                              dtype, decode_iters))
        per_tok = d["host_s"] / STEPS
        nbytes = weight_bytes(lparams)
        out.update(decode_host_ms_per_tok=per_tok * 1e3,
                   decode_device_ms_per_tok=None if d["device_ms"] is None
                   else d["device_ms"] / STEPS, decode_covered=d["covered"])
        line = (f"decode chunk {STEPS} (B={B}): {d['host_s'] * 1e3:.1f} ms "
                f"({per_tok * 1e3:.2f} ms/tok, weight-stream "
                f"{nbytes / per_tok / 1e9:.0f} GB/s, "
                f"{nbytes / per_tok / cs.HBM_BYTES_PER_S:.1%} of 3.35 TB/s)")
        if d["device_ms"] is not None:
            dev_tok = d["device_ms"] / STEPS / 1e3
            line += (f"; CUDA events {d['device_ms']:.1f} ms "
                     f"({dev_tok * 1e3:.2f} ms/tok, weight-stream "
                     f"{nbytes / dev_tok / 1e9:.0f} GB/s, "
                     f"{nbytes / dev_tok / cs.HBM_BYTES_PER_S:.1%} of 3.35 "
                     f"TB/s; the spin covered the enqueue of "
                     f"{d['covered']} of {STEPS} steps)")
        print(line, flush=True)
    return out


def main() -> None:
    device = cs.script_device("profile_torch_components")
    if os.environ.get("FUSEQKV", "1") != "1":
        raise ValueError("FUSEQKV=0: the port's decoder takes the fused "
                         "qkv layout only (ops/quant.fuse_qkv)")
    print("device:", cs.card() if device == "cuda" else "cpu",
          file=sys.stderr, flush=True)
    env = os.environ.get
    run(env("STAGES", "vit,conn,prefill,decode").split(","), device,
        B=int(env("B", 0)), vit_q8=env("VIT_Q8", "0") == "1",
        w8a8=tuple(x == "1" for x in env("W8A8", "0").split(",")),
        prefill_b=int(env("PREFILL_B", 0)),
        prefill_s=int(env("PREFILL_S", 0)))


if __name__ == "__main__":
    main()
