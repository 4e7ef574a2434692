#!/usr/bin/env python3
"""Speculative decode on the PyTorch port: plain greedy against
prompt-lookup drafts and oracle drafts (port of
scripts/bench_speculative.py).

Batch-1 greedy decode reads every weight for one token a step. This
times, ms a token (median of timed runs after a first, untimed one):

  * plain        the Engine's chunked decode (the layered kernels K3-K5
                 on int8 packs, K3, K6, K7 on int4 ones);
  * lookup k=K   prompt-lookup drafting (inference/speculative.py), K-slot
                 verify passes: its acceptance depends on how repetitive
                 the greedy continuation is, so on random weights it
                 bounds the overhead;
  * oracle k=K   drafts served from the recorded plain run (the JAX
                 script's proposer swap): the speedup's ceiling, bounded
                 by a verify pass's cost against K plain steps, while the
                 verify passes give plain greedy's tokens;
  * verify-oracle k=K
                 drafts served from the lookup run's recorded tokens, the
                 verify passes' own greedy continuation: the ceiling
                 where verify and plain decode part (below);

then B = SPEC_B (8) rotated prompts, plain against lookup k=8 (per-row
cache frontiers).

Every speculative run is held against plain greedy. On the CPU (the tiny
fp32 config) its tokens must equal plain greedy's exactly, as the JAX
script asserts. On a GPU, verify passes over packed weights take W8A8
(W4A8) while plain decode takes the weight-only kernels, so tokens may
part at a near-tie of the plain logits: each run goes through
chip_smoke.check_tokens (with its verify_logits replay through the
independent W8A8 reference on packed trees), and the script raises on any
difference that is not a near-tie. After such a flip the recorded plain
run no longer matches, so the oracle is no longer fully accepted (with
seeded random weights on the JAX script's text prompt the first flip
comes within a few tokens): each run prints its verify passes and the
drafts accepted a pass, and the verify-oracle, whose drafts follow the
verify arithmetic, shows the ceiling. The JSON line keeps the JAX
script's keys.

Sizes (SPEC_SIZE): "7b", the default on a GPU, is Mistral-7B at full
width with the JAX script's tree: int8 (SPEC_BITS=8) or folded int4
(SPEC_BITS=4) LLM packs, an int8 head and a bf16 tower (utils/synthetic
quantize_vision=False), bf16 KV cache. Its weights are the port's seeded
random ones (synthetic_params, seed 0), not JAX's constant fills, under
which every logit ties and greedy decode is degenerate. "tiny"
(core/config.tiny_model, fp32, seeded random weights) is what
PLATFORM=cpu runs, on the CPU. Without a GPU and without PLATFORM=cpu the
script raises. SPEC_TOKENS sets the tokens a run (128 on a GPU, 24 on the
CPU).

Usage, from the repository root:

    python3 scripts/bench_speculative_torch.py           # on a CUDA GPU
    SPEC_BITS=4 python3 scripts/bench_speculative_torch.py
    PLATFORM=cpu python3 scripts/bench_speculative_torch.py

Prints the card's name and power limit (on a GPU), the JAX script's
`[spec-bench]` lines on stderr and its JSON line.
"""

import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

# the JAX script's text-only, mildly repetitive prompt (what extractive
# answers echo) and bucket
BASE = [3, 11, 12, 13, 5, 11, 12, 13, 9]
BUCKET = 64
KS = (4, 8)


def build(size: str, bits: int, device: str):
    """(cfg, params, dtype) of a size: "7b" (int8 or int4 LLM packs, bf16
    tower) or "tiny" (floating fp32)."""
    from videollama2_tpu_torch.core import config as cfglib
    from videollama2_tpu_torch.utils.synthetic import synthetic_params
    if size == "tiny":
        cfg = cfglib.tiny_model()
        return cfg, synthetic_params(cfg, dtype=torch.float32, device=device,
                                     seed=0), torch.float32
    cfg = cfglib.preset("videollama2_mistral")
    return cfg, synthetic_params(cfg, dtype=torch.bfloat16, device=device,
                                 seed=0, llm_bits=bits,
                                 quantize_vision=False), torch.bfloat16


def prompts(B: int) -> list:
    """B rotations of the prompt (row 0 is the B = 1 prompt)."""
    return [((BASE[i % len(BASE):] + BASE[:i % len(BASE)]) * 8)[:BUCKET]
            for i in range(B)]


def engine(cfg, params, dtype, device, steps: int):
    from videollama2_tpu_torch.inference.engine import Engine
    return Engine(cfg, params, dtype=dtype, max_len=BUCKET + steps + 16,
                  buckets=(BUCKET,), decode_chunk=32, device=device)


def oracle_for(ref: list):
    """The JAX script's oracle drafter: serves the recorded plain
    continuation `ref` after the longest prefix of it that ends the
    context."""
    def oracle(context, want, max_n=3, min_n=1, _ref=ref):
        tail = [t for t in context]
        for done in range(len(_ref), -1, -1):
            if done == 0 or tail[-done:] == _ref[:done]:
                return _ref[done:done + want]
        return []
    return oracle


def exact(label, plain, run, rows) -> dict:
    """The CPU's rule: the run's tokens equal plain greedy's."""
    if run["tokens"] != plain["tokens"]:
        raise AssertionError(f"{label} speculative diverged from greedy")
    return {"ok": True}


def near_ties(eng, cfg):
    """The GPU's rule (chip_smoke.check_tokens): every token the run does
    not share with plain greedy follows a near-tie of the plain logits;
    on packed weights the verify passes are replayed through the
    independent W8A8 reference (chip_smoke.verify_logits)."""
    packed = any(pack in eng.params["llm"]["layers"]["qkv"]
                 for pack in ("kernel_q8", "kernel_q4"))

    def check(label, plain, run, rows):
        res = cs.check_tokens(
            label, plain["tokens"], run["tokens"],
            lambda b, p: cs.logits_at(plain["record"], b, p, False),
            lambda b, p: cs.logits_at(run["record"], b, p, True),
            (lambda firsts: cs.verify_logits(
                eng, cfg, None, None, BUCKET, run["record"], firsts,
                prompts=rows)) if packed else None)
        if not res["ok"]:
            raise AssertionError(f"{label}: speculative tokens differ from "
                                 "greedy beyond a near-tie")
        return res
    return check


def run(eng, cfg, steps: int, B: int, iters: int = 3, hook=None,
        check=exact) -> dict:
    """The JAX script's runs. Each generate goes through hook(label, fn)
    (fn() by default); the first of a configuration is untimed and
    recorded (chip_smoke.LogitTap: the logits behind its tokens, its
    verify passes and accepted drafts), `iters` timed ones follow and
    must give its tokens. Each speculative run is held against its plain
    run by check(label, plain, run, prompts). Returns the JAX script's
    results and, under "runs", each configuration's tokens, ms a token,
    verify passes, drafts accepted a pass and check."""
    from videollama2_tpu_torch.inference import speculative as spec_lib
    from videollama2_tpu_torch.inference.engine import GenerationConfig
    hook = hook or (lambda label, fn: fn())
    tap = cs.LogitTap()
    runs = {}

    def measure(label, rows, gen, width):
        call = lambda: eng.generate(rows, gen=gen, eos_token_id=-1)  # noqa
        with tap:
            out = hook(label, call)
            rec, accepted = tap.record(), list(tap.accepted)
        per_tok = []
        for _ in range(iters):
            t0 = time.perf_counter()
            again = hook(label, call)
            per_tok.append((time.perf_counter() - t0)
                           / sum(len(o) for o in again) * 1e3)
            if again != out:
                raise RuntimeError(f"{label}: a timed run gave other tokens "
                                   "than the first")
        ms = float(np.median(per_tok))
        n = sum(len(o) for o in out)
        print(f"[spec-bench] {label:{width}s} {ms:7.2f} ms/tok"
              f"{' aggregate' if len(rows) > 1 else ''} ({n} toks)",
              file=sys.stderr, flush=True)
        r = {"tokens": out, "record": rec, "ms_per_tok": ms,
             "verify_passes": len(rec["verifies"]),
             "accepted_per_pass": (statistics.mean(accepted) if accepted
                                   else None)}
        if accepted:
            print(f"[spec-bench] {label}: {r['verify_passes']} verify "
                  f"passes, {r['accepted_per_pass']:.2f} drafts accepted a "
                  f"pass{' a row' if len(rows) > 1 else ''} (of "
                  f"{gen.speculative_k - 1})",
                  file=sys.stderr, flush=True)
        runs[label] = r
        return r

    def held(label, plain, r, rows):
        r["check"] = check(label, plain, r, rows)

    one = prompts(1)
    plain = measure("plain", one, GenerationConfig(max_new_tokens=steps), 14)
    results = {"plain_ms_per_tok": round(plain["ms_per_tok"], 3)}
    real_propose = spec_lib.ngram_propose
    try:
        for k in KS:
            gen = GenerationConfig(max_new_tokens=steps, speculative_k=k)
            spec_lib.ngram_propose = real_propose
            lookup = measure(f"lookup k={k}", one, gen, 14)
            held(f"lookup k={k}", plain, lookup, one)
            spec_lib.ngram_propose = oracle_for(plain["tokens"][0])
            oracle = measure(f"oracle k={k}", one, gen, 14)
            held(f"oracle k={k}", plain, oracle, one)
            spec_lib.ngram_propose = oracle_for(lookup["tokens"][0])
            ceiling = measure(f"verify-oracle k={k}", one, gen, 14)
            held(f"verify-oracle k={k}", plain, ceiling, one)
            results[f"lookup_k{k}_ms_per_tok"] = round(lookup["ms_per_tok"],
                                                      3)
            results[f"oracle_k{k}_ms_per_tok"] = round(oracle["ms_per_tok"],
                                                      3)
            results[f"oracle_k{k}_speedup"] = round(
                plain["ms_per_tok"] / oracle["ms_per_tok"], 2)
    finally:
        spec_lib.ngram_propose = real_propose

    rows = prompts(B)
    bplain = measure(f"plain B={B}", rows,
                     GenerationConfig(max_new_tokens=steps), 18)
    bspec = measure(f"lookup B={B} k=8", rows,
                    GenerationConfig(max_new_tokens=steps, speculative_k=8),
                    18)
    held(f"batched B={B} k=8", bplain, bspec, rows)
    results[f"batch{B}_plain_ms_per_tok"] = round(bplain["ms_per_tok"], 3)
    results[f"batch{B}_lookup_k8_ms_per_tok"] = round(bspec["ms_per_tok"], 3)
    results[f"batch{B}_lookup_k8_speedup"] = round(
        bplain["ms_per_tok"] / bspec["ms_per_tok"], 2)
    return {"results": results, "runs": runs}


def main() -> None:
    device = cs.script_device("bench_speculative_torch")
    on_gpu = device == "cuda"
    if on_gpu:
        print(cs.card(), flush=True)
    size = os.environ.get("SPEC_SIZE", "7b" if on_gpu else "tiny")
    steps = int(os.environ.get("SPEC_TOKENS", "128" if on_gpu else "24"))
    bits = int(os.environ.get("SPEC_BITS", "8"))
    print(f"[spec-bench] init {size} params...", file=sys.stderr, flush=True)
    cfg, params, dtype = build(size, bits, device)
    eng = engine(cfg, params, dtype, device, steps)
    del params
    out = run(eng, cfg, steps, int(os.environ.get("SPEC_B", "8")),
              check=near_ties(eng, cfg) if on_gpu else exact)
    print(json.dumps(out["results"]))


if __name__ == "__main__":
    main()
