"""MVBench scorer: per-task accuracy table.

Parity: reference videollama2/eval/eval_video_mcqa_mvbench.py — same
prediction-file contract (JSONL of {"pred": idx, "gt": idx, "task_type":
display-name}, `--pred_path`), same per-task percentage accuracies and
overall score; the 4-per-row tabulate layout is replaced by an aligned
plain-text table (tabulate is not in this image) with identical numbers.
"""

from __future__ import annotations

import argparse
import json
from collections import defaultdict


def score(results) -> dict:
    """-> {"overall": pct, "tasks": {task_type: pct}} (reference :34-45)."""
    acc = []
    task_acc = defaultdict(list)
    for x in results:
        value = 1 if x["pred"] == x["gt"] else 0
        acc.append(value)
        task_acc[x["task_type"]].append(value)
    overall = sum(acc) * 100 / max(len(acc), 1)
    tasks = {t: sum(v) * 100 / len(v) for t, v in task_acc.items()}
    return {"overall": overall, "tasks": tasks}


def main():
    ap = argparse.ArgumentParser(description="Evaluate MVBench predictions.")
    ap.add_argument("--pred_path", required=True,
                    help="JSONL predictions: {'pred','gt','task_type'}")
    args = ap.parse_args()

    with open(args.pred_path) as f:
        text = f.read().strip()
    results = (json.loads(text) if text.startswith("[")
               else [json.loads(l) for l in text.splitlines()])

    rep = score(results)
    print(f"{args.pred_path}:", rep["overall"])
    width = max((len(t) for t in rep["tasks"]), default=10)
    for task in sorted(rep["tasks"]):
        print(f"{task:<{width}}  {rep['tasks'][task]:.1f}")


if __name__ == "__main__":
    main()
