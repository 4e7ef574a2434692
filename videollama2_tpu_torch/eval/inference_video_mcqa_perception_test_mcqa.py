"""Perception-Test MC-QA inference.

Parity: reference videollama2/eval/inference_video_mcqa_perception_test_mcqa.py
— per-video multi-question MC over three options; answer id dumped per
question.

Port of videollama2_tpu/eval/inference_video_mcqa_perception_test_mcqa.py:
the same flags, prompts, records and chunking, plus `--device` (cuda by
default) and an optional `--tokenizer module:callable` for the port's
model_init, which reads the checkpoint's own tokenizer files without it.
"""

from __future__ import annotations

import argparse
import json
import os

from .common import ResultWriter, extract_choice_letter, get_chunk, \
    run_inference_loop
from ..inference.api import add_model_flags, load_tokenizer

LETTERS = ("A", "B", "C")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--video-folder", required=True)
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--answer-file", required=True)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    add_model_flags(ap)
    args = ap.parse_args()

    from .. import mm_infer, model_init
    model, processor, tokenizer = model_init(
        args.model_path, device=args.device,
        tokenizer=load_tokenizer(args.tokenizer, args.model_path))

    with open(args.question_file) as f:
        data = json.load(f)  # {video_id: {mc_question: [...], ...}}
    video_ids = get_chunk(sorted(data), args.num_chunks, args.chunk_idx)
    writer = ResultWriter(args.answer_file, key="index")

    def infer(item):
        vid = item["vid"]
        video_path = None
        for fmt in (".mp4", ".avi", ".mov", ".mkv", ".gif"):
            p = os.path.join(args.video_folder, f"{vid}{fmt}")
            if os.path.exists(p):
                video_path = p
                break
        try:
            tensor = processor["video"](video_path)
        except Exception:
            tensor = None  # missing/corrupt video: every answer degrades
        answers = []
        for q in data[vid].get("mc_question", []):
            options = q["options"]
            # the reference's exact instruct (:61)
            prompt = (f"Question: {q['question']}\nOptions:\n"
                      f"(A) {options[0]}\n(B) {options[1]}\n"
                      f"(C) {options[2]}\n"
                      "Answer with the option's letter from the given "
                      "choices directly and only give the best option.")
            try:
                if tensor is None:
                    raise ValueError("video unavailable")
                resp = mm_infer(tensor, prompt, model, tokenizer,
                                modal="video", max_new_tokens=64)
                letter = extract_choice_letter(resp, options, letters=LETTERS)
            except Exception:
                letter = "C"
            # reference record shape (:147): per-question id/answer_id/answer
            answers.append(dict(id=q["id"], answer_id=LETTERS.index(letter),
                                answer=options[LETTERS.index(letter)]))
        return {"vid": vid, "answers": answers}

    items = [{"index": v, "vid": v} for v in video_ids]
    run_inference_loop(items, infer, writer, desc="perception")
    writer.close()


if __name__ == "__main__":
    main()
