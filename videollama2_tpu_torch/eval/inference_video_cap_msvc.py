"""MSVC multi-source video captioning inference.

Parity: reference videollama2/eval/inference_video_cap_msvc.py — input
records carry {'video_path', 'question', 'captions'} (:41-46), the record's
own question is the prompt, and output records are {'video_name',
'question', 'answer', 'pred'} JSONL written to --output-file (:100-101);
the per-video multi-reference captions ride through as `answer` for the
GPT-judge correctness/detailedness scorers.

Port of videollama2_tpu/eval/inference_video_cap_msvc.py:
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--video-folder", required=True)
    ap.add_argument("--question-file", required=True)
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
    gt_questions = get_chunk(gt_questions, args.num_chunks, args.chunk_idx)
    writer = ResultWriter(args.output_file, key="index")

    def infer(item):
        video_name = item["video_path"]
        question = item["question"]
        answer = item["captions"]
        tensor = processor["video"](os.path.join(args.video_folder,
                                                 video_name))
        pred = mm_infer(tensor, question, model, tokenizer, modal="video",
                        do_sample=False, max_new_tokens=512)
        # reference record shape (:100)
        return {"video_name": video_name, "question": question,
                "answer": answer, "pred": pred}

    items = [dict(x, index=i) for i, x in enumerate(gt_questions)]
    run_inference_loop(items, infer, writer, desc="msvc")
    writer.close()


if __name__ == "__main__":
    main()
