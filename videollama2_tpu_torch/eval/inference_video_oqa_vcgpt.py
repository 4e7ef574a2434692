"""Video-ChatGPT benchmark inference: general (correctness/detail/context/
temporal) and consistency modes.

Parity: reference videollama2/eval/inference_video_oqa_vcgpt_general.py and
_consistency.py — input records carry {'video_name', 'Q', 'A'} (general) or
{'video_name', 'Q1', 'Q2', 'A'} (consistency, :43-48); the raw question is
the prompt; output records are {'video_name', 'Q', 'A', 'P'} /
{'video_name', 'Q1', 'Q2', 'A', 'P1', 'P2'} JSONL (general :110, consistency
:124); videos resolve over the 5-extension list.

Port of videollama2_tpu/eval/inference_video_oqa_vcgpt.py:
the same flags, prompts, records and chunking, plus `--device` (cuda by
default) and an optional `--tokenizer module:callable` for the port's
model_init, which reads the checkpoint's own tokenizer files without it.
"""

from __future__ import annotations

import argparse
import json

from .common import ResultWriter, get_chunk, run_inference_loop
from .inference_video_oqa_activitynet import resolve_video
from ..inference.api import add_model_flags, load_tokenizer


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=["general", "consistency"],
                    default="general")
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
        name = item["video_name"]
        video_path = resolve_video(args.video_folder, name)
        if video_path is None:
            return dict(video_name=name, missing=True)
        tensor = processor["video"](video_path)
        if args.mode == "general":
            q, a = item["Q"], item["A"]
            pred = mm_infer(tensor, q, model, tokenizer, modal="video",
                            do_sample=False, max_new_tokens=512)
            # reference record shape (general :110)
            return {"video_name": name, "Q": q, "A": a, "P": pred}
        q1, q2, a = item["Q1"], item["Q2"], item["A"]
        pred1 = mm_infer(tensor, q1, model, tokenizer, modal="video",
                         do_sample=False, max_new_tokens=512)
        pred2 = mm_infer(tensor, q2, model, tokenizer, modal="video",
                         do_sample=False, max_new_tokens=512)
        # reference record shape (consistency :124)
        return {"video_name": name, "Q1": q1, "Q2": q2, "A": a,
                "P1": pred1, "P2": pred2}

    items = [dict(q, index=str(q.get("video_name", q.get("video", i))) +
                  f":{i}")
             for i, q in enumerate(questions)]
    run_inference_loop(items, infer, writer, desc=f"vcgpt-{args.mode}")
    writer.close()


if __name__ == "__main__":
    main()
