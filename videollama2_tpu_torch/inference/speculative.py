"""Self-speculative decoding: prompt-lookup (n-gram) drafts and greedy
acceptance.

The port's own copy of videollama2_tpu/inference/speculative.py, held
equal to it by tests/test_torch_config.py. Decode reads every weight once
for one token; a verify pass (models/llm.decode_verify) reads them once
for K slots: the last accepted token and K-1 drafts found by looking up
the context's newest n-gram earlier in the context. Each accepted draft
is a token gained without another pass, and greedy acceptance keeps the
token stream exactly that of plain greedy decoding.

Host side only: contexts are a few thousand ints.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def ngram_propose(context: Sequence[int], k: int, max_n: int = 3,
                  min_n: int = 1) -> List[int]:
    """Draft up to `k` continuation tokens by prompt lookup.

    Finds the most recent earlier occurrence of the longest suffix n-gram
    (n from max_n down to min_n) of `context` and returns the tokens that
    followed it. Returns fewer than k (possibly zero) tokens when no match
    exists or the match sits near the end.
    """
    L = len(context)
    if L < min_n + 1 or k <= 0:
        return []
    ctx = list(context)
    for n in range(min(max_n, L - 1), min_n - 1, -1):
        suffix = ctx[L - n:]
        # rightmost occurrence strictly before the suffix itself
        for start in range(L - n - 1, -1, -1):
            if ctx[start:start + n] == suffix:
                cont = ctx[start + n:start + n + k]
                if cont:
                    return cont
                break
    return []


def accept_drafts(drafts: Sequence[int], greedy: Sequence[int]
                  ) -> Tuple[List[int], int]:
    """Greedy acceptance for one verify round.

    Slot inputs were [t0, d1, .., d_{K-1}] and `greedy[i]` is the model's
    argmax continuation after slot i's prefix. Drafts are accepted while
    d_{i+1} == greedy[i]; the round always emits at least greedy[0] (the
    token a plain decode step would have produced).

    Returns (emitted tokens, number of accepted drafts). emitted has
    length accepted+1 and next round resumes from emitted[-1].
    """
    a = 0
    while a < len(drafts) and drafts[a] == greedy[a]:
        a += 1
    return list(greedy[:a + 1]), a
