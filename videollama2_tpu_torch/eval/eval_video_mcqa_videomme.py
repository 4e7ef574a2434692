"""Video-MME scorer: accuracy matrices by duration / domain / sub-category /
task type.

Parity: reference videollama2/eval/eval_video_mcqa_videomme.py — same
results-file contract (a JSON array of per-video records carrying
duration/domain/sub_category/missing and questions[{task_type, answer,
response}]), same answer extraction (prefix stripping, >10-words-no-letter
guard, first [ABCD] match, eval_video_mcqa_videomme.py:64-85), same
accumulation (only extractable responses count as answered, :148-177) and
the same CLI flags. The category taxonomy is data-driven (grouped over
whatever duration/domain/sub_category/task_type values appear) instead of
hard-coded lists — identical accuracies on Video-MME data.
"""

from __future__ import annotations

import argparse
import json
import re
from collections import defaultdict
from typing import List, Optional, Union

# NOTE: the two implicit string concatenations (missing commas) reproduce
# the reference list verbatim (:66-76) — scoring parity beats tidiness here.
ANSWER_PREFIXES = [
    "The best answer is",
    "The correct answer is",
    "The answer is",
    "The answer",
    "The best option is"
    "The correct option is",
    "Best answer:"
    "Best option:",
]


def extract_characters_regex(s: str) -> str:
    """Reference extract_characters_regex (:64-85)."""
    s = s.strip()
    for answer_prefix in ANSWER_PREFIXES:
        s = s.replace(answer_prefix, "")
    if len(s.split()) > 10 and not re.search("[ABCD]", s):
        return ""
    matches = re.search(r"[ABCD]", s)
    if matches is None:
        return ""
    return matches[0]


def eval_your_results(your_results_path: str,
                      video_types: Optional[Union[List[str], str]] = None,
                      skip_missing: bool = True,
                      return_categories_accuracy: bool = True,
                      return_sub_categories_accuracy: bool = False,
                      return_task_types_accuracy: bool = False,
                      gt_answer_key: str = "answer",
                      your_answer_key: str = "response") -> dict:
    """Accumulate + print the accuracy matrices; returns them as a dict
    {duration: {"domain"/"sub_category"/"task_type":
    {name: {"correct", "answered"}}}} for programmatic use."""
    with open(your_results_path) as f:
        text = f.read().strip()
    your_results = (json.loads(text) if text.startswith("[")
                    else [json.loads(l) for l in text.splitlines()])

    if isinstance(video_types, str):
        video_types = video_types.split(",")
    if video_types is None:
        video_types = sorted({item["duration"] for item in your_results})

    def matrix():
        return defaultdict(lambda: {"correct": 0, "answered": 0})

    q_type_dict = {v: matrix() for v in video_types}
    v_type_dict = {v: matrix() for v in video_types}
    v_sub_type_dict = {v: matrix() for v in video_types}

    for video_type in video_types:
        for item in your_results:
            if item["duration"] != video_type:
                continue
            if skip_missing and item.get("missing"):
                continue
            video_category = item["domain"]
            video_sub_category = item["sub_category"]
            for question in item["questions"]:
                q_type = question["task_type"]
                gt_answer = question[gt_answer_key]
                response = question[your_answer_key]
                extraction = extract_characters_regex(response)
                if extraction == "":
                    continue
                ok = int(extraction == gt_answer)
                for d, key in ((q_type_dict, q_type),
                               (v_type_dict, video_category),
                               (v_sub_type_dict, video_sub_category)):
                    d[video_type][key]["answered"] += 1
                    d[video_type][key]["correct"] += ok

    def pct(c, a):
        return 100 * c / a if a > 0 else 0

    report = {}
    for video_type in video_types:
        print("=====================================")
        print(f"Evaluation on video Type: {video_type}")
        print("=====================================")
        report[video_type] = {
            "domain": {k: dict(v) for k, v in
                       v_type_dict[video_type].items()},
            "sub_category": {k: dict(v) for k, v in
                             v_sub_type_dict[video_type].items()},
            "task_type": {k: dict(v) for k, v in
                          q_type_dict[video_type].items()},
        }
        if return_categories_accuracy:
            print("-------------------------------------")
            print("Video Domains")
            print("-------------------------------------")
            for k, v in sorted(v_type_dict[video_type].items()):
                print(f"{k}: {pct(v['correct'], v['answered']): .1f}%")
        if return_sub_categories_accuracy:
            print("-------------------------------------")
            print("Video Sub Categories")
            print("-------------------------------------")
            for k, v in sorted(v_sub_type_dict[video_type].items()):
                print(f"{k}: {pct(v['correct'], v['answered']): .1f}%")
        if return_task_types_accuracy:
            print("-------------------------------------")
            print("Task Categories")
            print("-------------------------------------")
            for k, v in sorted(q_type_dict[video_type].items()):
                print(f"{k}: {pct(v['correct'], v['answered']): .1f}%")
        print("-------------------------------------")
        print("Overall Performance")
        print("-------------------------------------")
        c = sum(v["correct"] for v in q_type_dict[video_type].values())
        a = sum(v["answered"] for v in q_type_dict[video_type].values())
        print(f"Overall: {pct(c, a): .1f}%\n")
        report[video_type]["overall"] = {"correct": c, "answered": a}

    print("=====================================")
    print("Evaluation on the entire dataset")
    print("=====================================")
    total_c = sum(report[v]["overall"]["correct"] for v in video_types)
    total_a = sum(report[v]["overall"]["answered"] for v in video_types)
    print(f"Overall: {pct(total_c, total_a): .1f}%")
    report["overall"] = {"correct": total_c, "answered": total_a,
                         "accuracy": total_c / max(total_a, 1)}
    return report


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--results_file", required=True)
    ap.add_argument("--video_duration_type", type=str, default=None)
    ap.add_argument("--return_categories_accuracy", action="store_true")
    ap.add_argument("--return_sub_categories_accuracy", action="store_true")
    ap.add_argument("--return_task_types_accuracy", action="store_true")
    ap.add_argument("--skip_missing", action="store_true")
    args = ap.parse_args()

    eval_your_results(
        args.results_file,
        video_types=args.video_duration_type,
        skip_missing=args.skip_missing,
        return_categories_accuracy=args.return_categories_accuracy,
        return_sub_categories_accuracy=args.return_sub_categories_accuracy,
        return_task_types_accuracy=args.return_task_types_accuracy,
    )


if __name__ == "__main__":
    main()
