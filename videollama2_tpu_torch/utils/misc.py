"""Misc utilities: moderation hook and keyword stopping (the port's copy of
the JAX package's utils/misc.py violates_moderation and KeywordsStopper).

Parity: reference videollama2/utils.py:102-120 (violates_moderation) and
mm_utils.py:314-345 (KeywordsStoppingCriteria). The stopping criterion is
re-expressed as a host-side predicate consumed by the engine's chunked
decode loop (inference/engine.py stop_fn): the engine handles EOS, and the
host scans the emitted tokens for keywords after each chunk.
"""

from __future__ import annotations

import json
import os
from typing import List, Sequence


def violates_moderation(text: str) -> bool:
    """OpenAI moderation-API hook (utils.py:102-120). Gated on the API key;
    returns False (allow) when unconfigured or unreachable — same failure
    semantics as the reference."""
    api_key = os.environ.get("OPENAI_API_KEY")
    if not api_key:
        return False
    try:
        import urllib.request
        req = urllib.request.Request(
            "https://api.openai.com/v1/moderations",
            data=json.dumps({"input": text.replace("\n", "")}).encode(),
            headers={"Content-Type": "application/json",
                     "Authorization": "Bearer " + api_key},
            method="POST")
        with urllib.request.urlopen(req, timeout=5) as r:
            flagged = json.loads(r.read())["results"][0]["flagged"]
        return bool(flagged)
    except Exception:
        return False


class KeywordsStopper:
    """Keyword stopping for the engine's chunked decode.

    Usage: engine.generate(..., stop_fn=KeywordsStopper(keywords,
    tokenizer).as_stop_fn()). Matches both token-suffix and decoded-text
    containment like the reference criteria (mm_utils.py:314-345).
    """

    def __init__(self, keywords: Sequence[str], tokenizer):
        self.keywords = list(keywords)
        self.tokenizer = tokenizer
        self.keyword_ids: List[List[int]] = []
        self.max_keyword_len = 0
        for kw in self.keywords:
            ids = tokenizer(kw).input_ids
            if len(ids) > 1 and ids[0] == tokenizer.bos_token_id:
                ids = ids[1:]
            self.max_keyword_len = max(self.max_keyword_len, len(ids))
            self.keyword_ids.append(ids)

    def should_stop(self, generated_ids: List[int]) -> bool:
        for ids in self.keyword_ids:
            if len(generated_ids) >= len(ids) and \
                    generated_ids[-len(ids):] == ids:
                return True
        offset = min(len(generated_ids), self.max_keyword_len + 2)
        tail = self.tokenizer.decode(generated_ids[-offset:],
                                     skip_special_tokens=True)
        return any(kw in tail for kw in self.keywords)

    def as_stop_fn(self):
        return self.should_stop
