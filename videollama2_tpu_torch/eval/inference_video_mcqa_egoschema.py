"""EgoSchema MC-QA inference.

Parity: reference videollama2/eval/inference_video_mcqa_egoschema.py — 5-way
multiple choice over long egocentric videos; generation failure degrades to
option index 2 / 'C' (:119-130); answers dumped as (q_uid, letter-index) CSV.

Port of videollama2_tpu/eval/inference_video_mcqa_egoschema.py:
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

LETTERS = ("A", "B", "C", "D", "E")


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
        questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)
    writer = ResultWriter(args.answer_file, key="index")

    def infer(item):
        quid = item["q_uid"]
        video_path = None
        for fmt in (".mp4", ".avi", ".mov", ".mkv", ".gif"):
            p = os.path.join(args.video_folder, f"{quid}{fmt}")
            if os.path.exists(p):
                video_path = p
                break
        options = [item[f"option {i}"] for i in range(5)]
        # the reference's exact instruct (:63)
        prompt = ("Select the best answer to the following multiple-choice "
                  "question based on the video.\n" + item["question"] +
                  "\nOptions:\n" +
                  "\n".join(f"({l}) {o}" for l, o in zip(LETTERS, options)) +
                  "\nAnswer with the option's letter from the given choices "
                  "directly and only give the best option. The best answer "
                  "is: ")
        try:
            tensor = processor["video"](video_path)
            resp = mm_infer(tensor, prompt, model, tokenizer, modal="video",
                            max_new_tokens=64)
            letter = extract_choice_letter(resp, options, letters=LETTERS)
        except Exception:
            resp, letter = "", "C"  # default pred_idx=2 (:119-130)
        return dict(q_uid=quid, response=resp,
                    pred_idx=LETTERS.index(letter))

    items = [dict(q, index=q["q_uid"]) for q in questions]
    run_inference_loop(items, infer, writer, desc="egoschema")
    writer.close()


if __name__ == "__main__":
    main()
