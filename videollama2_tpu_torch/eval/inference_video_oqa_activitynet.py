"""ActivityNet-QA / MSVD-QA open-ended QA inference.

Parity: reference videollama2/eval/inference_video_oqa_activitynet.py —
question/answer files are index-aligned lists (questions[i] pairs with
answers[i], :42-45), videos resolve as `v_{name}` then `{name}` over the
5-extension list (:51-61), the raw question is the prompt, and output
records are {'id', 'question', 'answer', 'pred'} JSONL (:129-130) written
to --output-file. The same script serves MSVD/MSRVTT/TGIF (the bare-name
fallback). Generation errors degrade to pred="error" (:125-127).

Port of videollama2_tpu/eval/inference_video_oqa_activitynet.py:
the same flags, prompts, records and chunking, plus `--device` (cuda by
default) and an optional `--tokenizer module:callable` for the port's
model_init, which reads the checkpoint's own tokenizer files without it.
"""

from __future__ import annotations

import argparse
import json
import os

from .common import ResultWriter, get_chunk, run_inference_loop
from ..inference.api import add_model_flags, load_tokenizer

VIDEO_EXTS = (".mp4", ".webm", ".avi", ".mov", ".mkv", ".gif")


def resolve_video(folder: str, name: str):
    for ext in VIDEO_EXTS:
        for prefix in ("v_", ""):
            p = os.path.join(folder, f"{prefix}{name}{ext}")
            if os.path.exists(p):
                return p
    return None


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--video-folder", required=True)
    ap.add_argument("--question-file", required=True,
                    help="list of {video_name, question, question_id}")
    ap.add_argument("--answer-file", required=True,
                    help="index-aligned list of {answer, ...}")
    ap.add_argument("--output-file", required=True)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    add_model_flags(ap)
    args = ap.parse_args()

    from .. import mm_infer, model_init
    model, processor, tokenizer = model_init(
        args.model_path, device=args.device,
        tokenizer=load_tokenizer(args.tokenizer, args.model_path))

    with open(args.question_file) as f:
        gt_questions = json.load(f)
    with open(args.answer_file) as f:
        gt_answers = json.load(f)
    gt_questions = get_chunk(gt_questions, args.num_chunks, args.chunk_idx)
    gt_answers = get_chunk(gt_answers, args.num_chunks, args.chunk_idx)

    writer = ResultWriter(args.output_file, key="index")

    def infer(item):
        sample, answer = item["sample"], item["gt"]
        video_name = sample["video_name"]
        question = sample["question"]
        question_id = sample["question_id"]
        video_path = resolve_video(args.video_folder, video_name)
        try:
            if video_path is None:
                raise FileNotFoundError(f"Video file not found for "
                                        f"{video_name}")
            tensor = processor["video"](video_path)
            pred = mm_infer(tensor, question, model, tokenizer,
                            modal="video", do_sample=False,
                            max_new_tokens=256)
        except Exception:
            pred = "error"
        return {"id": question_id, "question": question,
                "answer": answer["answer"], "pred": pred}

    items = [dict(index=str(q.get("question_id", i)), sample=q, gt=a)
             for i, (q, a) in enumerate(zip(gt_questions, gt_answers))]
    run_inference_loop(items, infer, writer, desc="oqa")
    writer.close()


if __name__ == "__main__":
    main()
