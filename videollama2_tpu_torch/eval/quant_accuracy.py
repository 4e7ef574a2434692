"""Quantization-accuracy measurement: logit drift and answer flips (port of
videollama2_tpu/eval/quant_accuracy.py).

The reference loads quantized weights through bitsandbytes and inherits its
accuracy contract silently (videollama2/model/__init__.py:59-69 — load_8bit/
load_4bit flags, no accuracy evaluation anywhere in the repo). Here the trade
is measured: for each quantized configuration (int8 / int4 weights, W8A8
prefill, int8 KV cache, and combinations) against the full-precision
reference on the SAME model:

  * teacher-forced decode KL(ref || quant) per step (the distribution-level
    drift, independent of sampling);
  * teacher-forced top-1 agreement (would greedy pick the same token given
    the same context?);
  * free-running greedy exact-match + first-divergence step (the
    user-visible "answer flip" metric).

The JAX harness picks its arithmetic with three contexts (quant_inference,
w8a8_prefill, force_native_quant); the port's models/llm functions take one
`w8a8` argument instead. The prefill (its head included) takes W8A8 only
in the "int8+w8a8" variant, and every decode step takes it for the packed
head, as JAX's step function does; packed layers decode on the layered
kernels (K3 over the bf16 or int8 cache, K4/K5 for int8, K6/K7 for int4:
models/llm.decode_step routes them), floating weights over an int8 cache
("kv8") on the plain attention. Eager PyTorch replaces jax.jit.

Works on any port LLM tree (fused qkv, as checkpoint/from_jax gives it):
the tiny fixtures of the CPU tests, or a released checkpoint through
scripts/quant_accuracy_torch.py --model-path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import LLMConfig
from ..inference.engine import _prepare, check_device
from ..models import llm as llm_lib
from ..ops import quant as quant_lib


@dataclasses.dataclass
class QuantVariant:
    """One quantization configuration to compare against the fp reference."""
    name: str
    weight_bits: int = 0          # 0 = full precision weights
    kv_bits: int = 16
    w8a8_prefill: bool = False


DEFAULT_VARIANTS = (
    QuantVariant("int8", weight_bits=8),
    QuantVariant("int4", weight_bits=4),
    QuantVariant("int8+w8a8", weight_bits=8, w8a8_prefill=True),
    QuantVariant("kv8", kv_bits=8),
    QuantVariant("int8+kv8", weight_bits=8, kv_bits=8),
    QuantVariant("int4+kv8", weight_bits=4, kv_bits=8),
)


def _prep_params(params: dict, variant: QuantVariant, dtype,
                 device) -> dict:
    """The variant's tree on `device`: int8 or folded int4 packs of the
    projections and an int8 head (quantize_llm_params), made from fp32
    values as the JAX harness quantizes its fp32 tree, then every floating
    leaf in `dtype`, as the Engine keeps its tree."""
    if variant.weight_bits:
        params = quant_lib.quantize_llm_params(
            _prepare(params, torch.float32, device),
            bits=variant.weight_bits)
    return _prepare(params, dtype, device)


@torch.inference_mode()
def _decode_logits(params: dict, cfg: LLMConfig, variant: QuantVariant,
                   prompt: np.ndarray, forced: Optional[np.ndarray],
                   steps: int, bucket: int, max_len: int, dtype, device):
    """Prefill `prompt` then decode `steps` tokens.

    forced=None: free-running greedy (each step feeds its own argmax).
    forced=[steps] ids: teacher forcing — step i feeds forced[i-1] (the
    reference's trajectory), so per-step logits are comparable across
    configurations.
    Returns (logits [steps, V] fp32, tokens [steps])."""
    S = len(prompt)
    ids = torch.zeros((1, bucket), dtype=torch.long)
    ids[0, :S] = torch.as_tensor(np.asarray(prompt, np.int64))
    ids = ids.to(device)
    valid = torch.tensor([S], dtype=torch.int32, device=device)
    positions = torch.arange(bucket, dtype=torch.int32, device=device)[None]
    cache = llm_lib.init_cache(cfg, 1, max_len, dtype,
                               kv_bits=variant.kv_bits, device=device)
    embeds = llm_lib.embed_tokens(params, ids, dtype)
    last, cache = llm_lib.prefill(params, cfg, embeds, positions, valid,
                                  cache, w8a8=variant.w8a8_prefill)
    logits = llm_lib.lm_logits(params, cfg, last, w8a8=variant.w8a8_prefill)

    out_logits: List[np.ndarray] = [logits[0].float().cpu().numpy()]
    tok = int(np.argmax(out_logits[0]))
    tokens = [tok]
    for i in range(1, steps):
        feed = int(forced[i - 1]) if forced is not None else tokens[-1]
        te = llm_lib.embed_tokens(
            params, torch.tensor([[feed]], dtype=torch.long, device=device),
            dtype)
        logits, cache = llm_lib.decode_step(params, cfg, te, cache, valid,
                                            bucket, i - 1, w8a8=True)
        out_logits.append(logits[0].float().cpu().numpy())
        tokens.append(int(np.argmax(out_logits[-1])))
    return np.stack(out_logits), np.asarray(tokens)


def _kl(ref_logits: np.ndarray, q_logits: np.ndarray) -> float:
    """Mean KL(ref || quant) over steps, computed in float64 log-space."""
    def logsoft(x):
        x = x.astype(np.float64)
        x = x - x.max(-1, keepdims=True)
        return x - np.log(np.exp(x).sum(-1, keepdims=True))
    lr, lq = logsoft(ref_logits), logsoft(q_logits)
    p = np.exp(lr)
    return float((p * (lr - lq)).sum(-1).mean())


def measure(params: dict, cfg: LLMConfig,
            prompts: Sequence[np.ndarray],
            variants: Sequence[QuantVariant] = DEFAULT_VARIANTS,
            steps: int = 16, bucket: int = 64, max_len: int = 256,
            dtype=torch.float32, device="cuda") -> Dict[str, dict]:
    """Run the full variant matrix on `device` (cuda by default; "cpu"
    runs the kernels' plain versions). Returns {variant: metrics} where
    metrics = {kl, top1_agreement, greedy_exact_match,
    mean_first_divergence, steps, prompts}."""
    device = check_device(device)
    run = dict(cfg=cfg, steps=steps, bucket=bucket, max_len=max_len,
               dtype=dtype, device=device)
    # reference trajectories (full precision, bf16/fp32 cache)
    reference = QuantVariant("reference")
    ref_params = _prep_params(params, reference, dtype, device)
    refs = [_decode_logits(ref_params, variant=reference, prompt=p,
                           forced=None, **run)
            for p in prompts]
    del ref_params

    results: Dict[str, dict] = {}
    for variant in variants:
        vparams = _prep_params(params, variant, dtype, device)
        kls, agree, total = [], 0, 0
        exact, first_div = 0, []
        for p, (ref_lo, ref_toks) in zip(prompts, refs):
            # teacher-forced on the reference trajectory
            q_lo, q_toks = _decode_logits(vparams, variant=variant, prompt=p,
                                          forced=ref_toks, **run)
            kls.append(_kl(ref_lo, q_lo))
            agree += int((q_toks == ref_toks).sum())
            total += steps
            # free-running greedy (the user-visible answer)
            _, free_toks = _decode_logits(vparams, variant=variant, prompt=p,
                                          forced=None, **run)
            same = free_toks == ref_toks
            exact += int(same.all())
            first_div.append(int(np.argmax(~same)) if not same.all()
                             else steps)
        del vparams
        results[variant.name] = {
            "kl": float(np.mean(kls)),
            "top1_agreement": agree / total,
            "greedy_exact_match": exact / len(prompts),
            "mean_first_divergence": float(np.mean(first_div)),
            "steps": steps,
            "prompts": len(prompts),
        }
    return results


def format_table(results: Dict[str, dict]) -> str:
    lines = [f"{'variant':<12} {'KL(ref||q)':>12} {'top-1 agree':>12} "
             f"{'greedy exact':>13} {'1st divergence':>15}"]
    for name, m in results.items():
        lines.append(
            f"{name:<12} {m['kl']:>12.3e} {m['top1_agreement']:>11.1%} "
            f"{m['greedy_exact_match']:>12.1%} "
            f"{m['mean_first_divergence']:>12.1f}/{m['steps']}")
    return "\n".join(lines)
