"""Shared eval-harness machinery.

Parity: the per-benchmark boilerplate repeated across the reference's 18 eval
files (videollama2/eval/*): chunked dataset sharding (--num-chunks /
--chunk-idx, inference_video_mcqa_videomme.py:27-34), multiple-choice answer
extraction with option-text fallback and default 'C'
(videomme_dump :185-227), and resumable JSONL result writing.
"""

from __future__ import annotations

import json
import math
import os
import re
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence


def split_list(lst: Sequence, n: int) -> List[Sequence]:
    """Split into n (roughly) equal chunks."""
    chunk = math.ceil(len(lst) / n)
    return [lst[i:i + chunk] for i in range(0, len(lst), chunk)]


def get_chunk(lst: Sequence, num_chunks: int, idx: int) -> Sequence:
    chunks = split_list(lst, num_chunks)
    return chunks[idx] if idx < len(chunks) else []


def extract_choice_letter(response: str,
                          options: Optional[Sequence[str]] = None,
                          letters: Sequence[str] = ("A", "B", "C", "D"),
                          default: str = "C") -> str:
    """Extract the chosen letter from a free-form MC answer.

    Regex-first with option-text fallback, defaulting to `default` on failure
    (reference videomme_dump / mvbench_dump / egoschema_dump behavior).
    """
    response = response.strip()
    letter_group = "".join(letters)
    matches = re.search(rf"[\(\[]?([{letter_group}])[\)\].:,]?(\s|$)",
                        response)
    if matches:
        return matches.group(1)
    matches = re.search(rf"(?:answer is|answer:)\s*\(?([{letter_group}])",
                        response, re.IGNORECASE)
    if matches:
        return matches.group(1).upper()
    if options:
        low = response.lower()
        for letter, opt in zip(letters, options):
            body = re.sub(rf"^\(?{letter}\)?[.:]?\s*", "", opt.strip(),
                          flags=re.IGNORECASE).lower()
            if body and body in low:
                return letter
    if len(response) >= 1 and response[0].upper() in letters:
        return response[0].upper()
    return default


class ResultWriter:
    """Append-only JSONL results with idempotent resume (the reference's
    retry-until-complete loop, eval_video_oqa_activitynet.py:123-149)."""

    def __init__(self, path: str, key: str = "index"):
        self.path = path
        self.key = key
        self.done = set()
        if os.path.exists(path):
            with open(path) as f:
                for line in f:
                    try:
                        self.done.add(json.loads(line)[key])
                    except Exception:
                        pass
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        self._f = open(path, "a")

    def is_done(self, key_val) -> bool:
        return key_val in self.done

    def write(self, record: Dict[str, Any]) -> None:
        self._f.write(json.dumps(record) + "\n")
        self._f.flush()
        self.done.add(record[self.key])

    def close(self):
        self._f.close()


def merge_chunks(pattern_paths: Iterable[str], out_path: str,
                 return_records: bool = False):
    """Merge per-chunk JSON/JSONL files into one JSON array (the bash merge
    step of scripts/eval/*.sh). Returns the record count, or the records
    themselves with return_records=True (for post-merge format converters,
    e.g. the EgoSchema Kaggle CSV)."""
    records = []
    for p in pattern_paths:
        with open(p) as f:
            text = f.read().strip()
            if not text:
                continue
            if text[0] == "[":
                records.extend(json.loads(text))
            else:
                for line in text.splitlines():
                    records.append(json.loads(line))
    with open(out_path, "w") as f:
        json.dump(records, f)
    return records if return_records else len(records)


def run_inference_loop(items: Sequence[dict],
                       infer_fn: Callable[[dict], dict],
                       writer: ResultWriter,
                       desc: str = "eval") -> None:
    """Drive inference with per-sample fault tolerance (missing/corrupt media
    degrades instead of crashing, inference_video_mcqa_videomme.py:94-98)."""
    for i, item in enumerate(items):
        key = item.get("index", i)
        if writer.is_done(key):
            continue
        try:
            rec = infer_fn(item)
        except Exception as e:
            rec = {"error": str(e)}
        rec["index"] = key
        writer.write(rec)
        if (i + 1) % 10 == 0:
            print(f"[{desc}] {i + 1}/{len(items)}")
