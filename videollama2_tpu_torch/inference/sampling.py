"""Token sampling: greedy and temperature + top-p (port of
videollama2_tpu/inference/sampling.py, HF TopPLogitsWarper semantics).

Randomness comes from a caller-owned torch.Generator on the logits' device;
it draws other numbers than jax.random from the same seed.
"""

from __future__ import annotations

from typing import Optional

import torch


def greedy(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def sample_top_p(generator: torch.Generator, logits: torch.Tensor,
                 temperature: float, top_p: float) -> torch.Tensor:
    """logits: [B, V] fp32 -> [B] sampled token ids."""
    logits = logits / max(temperature, 1e-6)
    probs = torch.softmax(logits, dim=-1)
    sorted_probs = torch.sort(probs, dim=-1, descending=True).values
    cumsum = torch.cumsum(sorted_probs, dim=-1)
    # keep while the prefix-exclusive cumsum < p (the top token always)
    num_keep = torch.sum((cumsum - sorted_probs) < top_p, dim=-1)
    threshold = torch.gather(sorted_probs, -1, (num_keep - 1)[:, None])
    masked = torch.where(probs >= threshold, logits,
                         torch.full_like(logits, float("-inf")))
    return torch.multinomial(torch.softmax(masked, dim=-1), 1,
                             generator=generator)[:, 0]


def select_token(generator: Optional[torch.Generator], logits: torch.Tensor,
                 do_sample: bool, temperature: float,
                 top_p: float) -> torch.Tensor:
    if not do_sample or temperature == 0.0:
        return greedy(logits)
    return sample_top_p(generator, logits, temperature, top_p)
