#!/bin/bash
# Perception-Test MC-QA: chunk-sharded inference + merged submission JSON.
# PyTorch/CUDA port of scripts/eval/eval_video_mcqa_perception_test_mcqa.sh: the same inference,
# merge and scoring through videollama2_tpu_torch, one inference chunk
# a card as the reference runs them (scripts/torch/lib/chunks.sh): the
# cards are CUDA_VISIBLE_DEVICES (every card when unset), CHUNKS defaults
# to their number, chunk IDX runs on card IDX % cards, and a failed
# chunk fails the script. Deviation: --device cuda.
source "$(dirname "${BASH_SOURCE[0]}")/../lib/chunks.sh"

CKPT=${CKPT:-DAMO-NLP-SG/VideoLLaMA2-7B}
EVAL_DATA_DIR=${EVAL_DATA_DIR:-eval}
OUTPUT_DIR=${OUTPUT_DIR:-eval_output}
CKPT_NAME=$(basename ${CKPT})
eval_cards

out=${OUTPUT_DIR}/perception_test_mcqa/answers/${CKPT_NAME}
output_file=${out}/merge.json

if [ ! -f "$output_file" ]; then
    infer() {
        python -m videollama2_tpu_torch.eval.inference_video_mcqa_perception_test_mcqa \
            --model-path ${CKPT} \
            --video-folder ${EVAL_DATA_DIR}/perception_test_mcqa/videos \
            --question-file ${EVAL_DATA_DIR}/perception_test_mcqa/mc_question_test.json \
            --answer-file ${out}/${CHUNKS}_${1}.jsonl \
            --num-chunks $CHUNKS --chunk-idx $1 \
            --device cuda
    }
    run_chunks infer
    python - <<EOF
import glob, json
from videollama2_tpu_torch.eval.common import merge_chunks
recs = merge_chunks(sorted(glob.glob("${out}/${CHUNKS}_*.jsonl")),
                    "${out}/flat.json", return_records=True)
# submission format (reference merge step): {vid: {"mc_question": [...]}}
sub = {r["vid"]: {"mc_question": r["answers"]} for r in recs}
with open("${output_file}", "w") as f:
    json.dump(sub, f)
print(f"wrote {len(sub)} videos to ${output_file}")
EOF
fi
echo "submit ${output_file} to the Perception-Test eval server"
