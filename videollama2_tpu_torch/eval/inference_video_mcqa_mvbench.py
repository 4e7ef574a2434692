"""MVBench multiple-choice QA inference (20 sub-tasks).

Parity: reference videollama2/eval/inference_video_mcqa_mvbench.py — the
20-task table with per-task annotation files, video roots, media types
(video / frame-dir) and start/end second bounds (:78-99); annotation
records carry video/question/candidates/answer (+start/end, :45-53); the
instruct is the reference's exact 'Question: ...\\nOptions:\\n(A) ...'
format (:64); output records are {"vid", "task_type", "pred", "gt"} with
option INDICES, pred defaulting to 2 on extraction failure (:124-149,
:182).

Port of videollama2_tpu/eval/inference_video_mcqa_mvbench.py:
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

# task display name -> (annotation_file, video_subdir, media_type,
# has_start_end); matches the reference's `tasks` table (:78-99)
MVBENCH_TASKS = {
    "Action Sequence": ("action_sequence.json", "star/Charades_v1_480/",
                        "video", True),
    "Action Prediction": ("action_prediction.json", "star/Charades_v1_480/",
                          "video", True),
    "Action Antonym": ("action_antonym.json", "ssv2_video/", "video", False),
    "Fine-grained Action": ("fine_grained_action.json",
                            "Moments_in_Time_Raw/videos/", "video", False),
    "Unexpected Action": ("unexpected_action.json", "FunQA_test/test/",
                          "video", False),
    "Object Existence": ("object_existence.json",
                         "clevrer/video_validation/", "video", False),
    "Object Interaction": ("object_interaction.json",
                           "star/Charades_v1_480/", "video", True),
    "Object Shuffle": ("object_shuffle.json", "perception/videos/", "video",
                       False),
    "Moving Direction": ("moving_direction.json",
                         "clevrer/video_validation/", "video", False),
    "Action Localization": ("action_localization.json", "sta/sta_video/",
                            "video", True),
    "Scene Transition": ("scene_transition.json", "scene_qa/video/", "video",
                         False),
    "Action Count": ("action_count.json", "perception/videos/", "video",
                     False),
    "Moving Count": ("moving_count.json", "clevrer/video_validation/",
                     "video", False),
    "Moving Attribute": ("moving_attribute.json",
                         "clevrer/video_validation/", "video", False),
    "State Change": ("state_change.json", "perception/videos/", "video",
                     False),
    "Fine-grained Pose": ("fine_grained_pose.json", "nturgbd/", "video",
                          False),
    "Character Order": ("character_order.json", "perception/videos/",
                        "video", False),
    "Egocentric Navigation": ("egocentric_navigation.json", "vlnqa/",
                              "video", False),
    "Episodic Reasoning": ("episodic_reasoning.json", "tvqa/frames_fps3_hq/",
                           "frame", True),
    "Counterfactual Inference": ("counterfactual_inference.json",
                                 "clevrer/video_validation/", "video",
                                 False),
}


def build_prompt(question: str, candidates) -> str:
    """The reference's exact instruct (:56-64)."""
    options_string = ""
    for option_idx, c in enumerate(candidates):
        options_string += f"({chr(ord('A') + option_idx)}) {c}\n"
    return (f"Question: {question}\nOptions:\n{options_string}"
            "Answer with the option's letter from the given choices "
            "directly and only give the best option.")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--question-file", required=True,
                    help="directory of MVBench json annotation files")
    ap.add_argument("--video-folder", required=True)
    ap.add_argument("--answer-file", required=True)
    ap.add_argument("--num-chunks", type=int, default=1)
    ap.add_argument("--chunk-idx", type=int, default=0)
    add_model_flags(ap)
    args = ap.parse_args()

    from .. import mm_infer, model_init
    model, processor, tokenizer = model_init(
        args.model_path, device=args.device,
        tokenizer=load_tokenizer(args.tokenizer, args.model_path))

    samples = []
    for task, (ann_file, subdir, media_type, has_se) in \
            MVBENCH_TASKS.items():
        path = os.path.join(args.question_file, ann_file)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            for j, item in enumerate(json.load(f)):
                samples.append(dict(
                    index=f"{task}:{j}", task_type=task,
                    video=os.path.join(args.video_folder, subdir,
                                       item["video"]),
                    media_type=media_type,
                    question=item["question"],
                    candidates=item["candidates"],
                    answer=item["answer"],
                    start=item.get("start") if has_se else None,
                    end=item.get("end") if has_se else None))
    samples = get_chunk(samples, args.num_chunks, args.chunk_idx)

    writer = ResultWriter(args.answer_file, key="index")

    def infer(item):
        from ..media.preprocess import process_video
        tensor = process_video(item["video"], model.config.vision,
                               s=item["start"], e=item["end"],
                               aspect_ratio=None,
                               num_frames=model.config.num_frames)
        candidates = item["candidates"]
        prompt = build_prompt(item["question"], candidates)
        try:
            resp = mm_infer(tensor, prompt, model, tokenizer, modal="video",
                            max_new_tokens=64)
        except Exception:
            resp = "C"
        letters = [chr(ord("A") + i) for i in range(len(candidates))]
        letter = extract_choice_letter(resp, candidates, letters=letters)
        pred_idx = letters.index(letter)
        # gt as option index; -1 when the answer string is absent (:54-62)
        gt_idx = (candidates.index(item["answer"])
                  if item["answer"] in candidates else -1)
        # reference record shape (:182): option indices, full video path
        return dict(vid=item["video"], task_type=item["task_type"],
                    pred=pred_idx, gt=gt_idx)

    run_inference_loop(samples, infer, writer, desc="mvbench")
    writer.close()


if __name__ == "__main__":
    main()
