"""Video-MME multiple-choice QA inference.

Parity: reference videollama2/eval/inference_video_mcqa_videomme.py —
field-for-field:
  * parquet loading groups rows into per-video records with the published
    column names (videoID/url/duration/domain/sub_category/question_id/
    task_type/question/options/answer, reference :135-171);
  * the video file is resolved from the youtube id in `url`
    ('watch?v=' suffix, reference :80-86), subtitles from `{ytid}.srt`;
  * subtitles are aligned to the uniformly-sampled frame timestamps
    (reference :100-119; pysubs2 replaced by a from-scratch SRT parser);
  * every question runs twice (without / with subtitles) and the two runs
    land in `answer_file` and `answer_file.replace('.json', '_sub.json')`
    (reference :236-285), each record a deep copy of the grouped video
    record plus `missing` and per-question `response` letters;
  * answer-letter extraction matches videomme_dump (:185-227): strip
    'answer'/'Answer', regex [A-D], option-text fallback with arabic-digit
    to-word mapping, default 'C' (pred_idx=2) on failure.

The per-video (question x sub-mode) prompts are batched
through mm_infer_batch so the video encodes once and its tokens broadcast
across the batch; per-chunk output is JSONL and the merge step produces the
same JSON array the reference's bash `[ ... ]` wrap yields.

Port of videollama2_tpu/eval/inference_video_mcqa_videomme.py:
the same flags, prompts, records and chunking, plus `--device` (cuda by
default) and an optional `--tokenizer module:callable` for the port's
model_init, which reads the checkpoint's own tokenizer files without it.
The parquet question file is read by eval/parquet.py (no pandas).
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import re

from ..media import sampler as sampler_lib
from . import parquet
from .common import get_chunk
from ..inference.api import add_model_flags, load_tokenizer

VIDEO_FORMATS = [".mp4", ".avi", ".mov", ".mkv", ".webm", ".gif"]

LETTERS = ["A", "B", "C", "D"]

DIGIT2WORD = {"1": "one", "2": "two", "3": "three", "4": "four", "5": "five",
              "6": "six", "7": "seven", "8": "eight", "9": "nine",
              "0": "zero"}

INSTRUCT_HEAD = ("Select the best answer to the following multiple-choice "
                 "question based on the video. Respond with only the letter "
                 "(A, B, C, or D) of the correct option.\n")
INSTRUCT_TAIL = ("Answer with the option's letter from the given choices "
                 "directly and only give the best option. The best answer "
                 "is: ")


def load_parquet(parquet_file: str):
    """Parquet -> per-video grouped records (reference :135-171).

    One parquet row per question; rows group by `video_id` into
    {video_id, youtube_id, url, duration, domain, sub_category,
     questions: [{question_id, task_type, question, choices, answer}]}.
    The rows come from the port's own reader (eval/parquet.py), in place
    of pandas, which the GPU host lacks.
    """
    jsons = []
    for record in parquet.read_rows(parquet_file):
        q = {
            "question_id": record.question_id,
            "task_type": record.task_type,
            "question": record.question,
            "choices": list(record.options),
            "answer": record.answer,
        }
        if len(jsons) < int(record.video_id):
            jsons.append({
                "video_id": record.video_id,
                "youtube_id": record.videoID,
                "url": record.url,
                "duration": record.duration,
                "domain": record.domain,
                "sub_category": record.sub_category,
                "questions": [q],
            })
        else:
            jsons[-1]["questions"].append(q)
    return jsons


def parse_srt(path: str):
    """From-scratch SRT parser -> [(start_sec, end_sec, text)] (pysubs2
    replacement; handles index-led and bare timestamp blocks)."""
    with open(path, errors="ignore") as f:
        text = f.read()
    entries = []
    for block in re.split(r"\n\s*\n", text.strip()):
        lines = block.strip().splitlines()
        if not lines:
            continue
        ts_i = 1 if (lines[0].strip().isdigit() and len(lines) > 1) else 0
        if ts_i >= len(lines) or "-->" not in lines[ts_i]:
            continue
        m = re.match(r"(\d+):(\d+):(\d+)[,.](\d+)\s*-->\s*"
                     r"(\d+):(\d+):(\d+)[,.](\d+)", lines[ts_i])
        if not m:
            continue
        g = [int(x) for x in m.groups()]
        start = g[0] * 3600 + g[1] * 60 + g[2] + g[3] / 1000
        end = g[4] * 3600 + g[5] * 60 + g[6] + g[7] / 1000
        body = " ".join(lines[ts_i + 1:]).replace("\\N", " ")
        entries.append((start, end, body))
    return entries


def align_subtitles(sub_path: str, frame_indices, fps: float) -> str:
    """Per sampled frame, the first subtitle spanning its timestamp
    (reference :100-119: sub.start < frame_time < sub.end, one line per
    frame, empty lines dropped, joined with newlines)."""
    if not sub_path or not os.path.exists(sub_path) or fps <= 0:
        return ""
    entries = parse_srt(sub_path)
    picked = []
    for fi in frame_indices:
        cur_time = fi / fps  # seconds (pysubs2.make_time(fps, frames))
        sub_text = ""
        for start, end, body in entries:
            if start < cur_time < end:
                sub_text = body
                break
        if sub_text.strip():
            picked.append(sub_text)
    return "\n".join(picked)


def videomme_dump(record: dict, instruct: str, options, output: str) -> str:
    """Answer-letter extraction, parity with reference videomme_dump
    (:185-227). options: the choice texts stripped of their 'A. ' prefix."""
    output = output.replace("answer", "")
    output = output.replace("Answer", "")
    pred_answer = re.findall(r"[\(\ \[]*([A-D])[\)\.\ \]]*", output)
    pred_idx = 2
    if len(pred_answer) == 0:
        for idx, opt in enumerate(options):
            opt2 = DIGIT2WORD.get(opt, opt)
            if (opt.lower() in output.lower()
                    or opt2.lower() in output.lower()):
                pred_idx = idx
                break
    else:
        ans = pred_answer[0].strip().strip("()")
        if ans in LETTERS:
            pred_idx = LETTERS.index(ans)
    return LETTERS[pred_idx]


def build_instruct(question: str, choices) -> str:
    """The exact reference prompt (:268-273)."""
    instruct = INSTRUCT_HEAD + f"{question}\n"
    for cho in choices:
        instruct += f"{cho}\n"
    instruct += INSTRUCT_TAIL
    return instruct


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--video-folder", required=True)
    ap.add_argument("--subtitle-folder", required=True)
    ap.add_argument("--question-file", required=True)
    ap.add_argument("--answer-file", required=True)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    ap.add_argument("--num-frames", type=int, default=None)
    add_model_flags(ap)
    args = ap.parse_args()

    from .. import model_init
    model, processor, tokenizer = model_init(
        args.model_path, device=args.device,
        tokenizer=load_tokenizer(args.tokenizer, args.model_path))
    num_frames = args.num_frames or model.config.num_frames

    if args.question_file.endswith(".parquet"):
        questions = load_parquet(args.question_file)
    else:  # pre-grouped JSON (same record shape)
        with open(args.question_file) as f:
            questions = json.load(f)
    questions = get_chunk(questions, args.num_chunks, args.chunk_idx)

    answer_file = os.path.expanduser(args.answer_file)
    answer_sub_file = answer_file.replace(".json", "_sub.json")
    os.makedirs(os.path.dirname(os.path.abspath(answer_file)), exist_ok=True)
    ans_f = open(answer_file, "w")
    ans_sub_f = open(answer_sub_file, "w")

    for record in questions:
        video_ytid = record["url"].split("watch?v=")[-1]
        video_path = None
        for fmt in VIDEO_FORMATS:
            p = os.path.join(args.video_folder, f"{video_ytid}{fmt}")
            if os.path.exists(p):
                video_path = p
                break

        new_record = copy.deepcopy(record)
        new_record_sub = copy.deepcopy(record)
        try:
            tensor = processor["video"](video_path) if video_path else None
        except Exception:
            tensor = None
        if tensor is None:
            new_record["missing"] = True
            new_record_sub["missing"] = True
            ans_f.write(json.dumps(new_record) + "\n")
            ans_sub_f.write(json.dumps(new_record_sub) + "\n")
            continue
        new_record["missing"] = False
        new_record_sub["missing"] = False

        # subtitle window over the sampled frames (reference :99-117)
        subtitle = ""
        sub_path = os.path.join(args.subtitle_folder, f"{video_ytid}.srt")
        if os.path.exists(sub_path):
            try:
                from ..media.video_reader import probe_video
                total, fps = probe_video(video_path)
                idx = sampler_lib.sample_indices(total, fps, num_frames)
                subtitle = align_subtitles(sub_path, idx, fps)
            except Exception:
                subtitle = ""

        # batch (question x sub-mode) prompts: the video encodes once
        prompts, metas = [], []
        for q_idx, question in enumerate(record["questions"]):
            choices = question["choices"]
            # strip the 'A. ' prefix (reference :265); keep index alignment
            # by falling back to the raw choice if a row deviates
            options = []
            for c in choices:
                m = re.findall(r"[A-D]\. (.*).", c)
                options.append(m[0] if m else c)
            instruct = build_instruct(question["question"], choices)
            prompts.append(instruct)
            metas.append((q_idx, False, options, instruct))
            sub_instruct = (f"This video's subtitles are listed below:\n"
                            f"{subtitle}\n" + instruct)
            prompts.append(sub_instruct)
            metas.append((q_idx, True, options, sub_instruct))
        try:
            from ..inference.api import mm_infer_batch
            outputs = mm_infer_batch(tensor, prompts, model, tokenizer,
                                     modal="video", do_sample=False,
                                     max_new_tokens=128)
        except Exception:
            outputs = [""] * len(prompts)
        for output, (q_idx, with_sub, options, instruct) in zip(outputs,
                                                                metas):
            letter = videomme_dump(record, instruct, options, output)
            target = new_record_sub if with_sub else new_record
            target["questions"][q_idx]["response"] = letter

        ans_f.write(json.dumps(new_record) + "\n")
        ans_sub_f.write(json.dumps(new_record_sub) + "\n")

    ans_f.close()
    ans_sub_f.close()


if __name__ == "__main__":
    main()
