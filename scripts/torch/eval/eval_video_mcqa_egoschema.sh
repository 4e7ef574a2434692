#!/bin/bash
# EgoSchema MC-QA: chunk-sharded inference + Kaggle-format CSV merge.
# PyTorch/CUDA port of scripts/eval/eval_video_mcqa_egoschema.sh: the same inference,
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

out=${OUTPUT_DIR}/egoschema/answers/${CKPT_NAME}
output_file=${out}/merge.csv

if [ ! -f "$output_file" ]; then
    infer() {
        python -m videollama2_tpu_torch.eval.inference_video_mcqa_egoschema \
            --model-path ${CKPT} \
            --video-folder ${EVAL_DATA_DIR}/egoschema/good_clips_git \
            --question-file ${EVAL_DATA_DIR}/egoschema/questions.json \
            --answer-file ${out}/${CHUNKS}_${1}.jsonl \
            --num-chunks $CHUNKS --chunk-idx $1 \
            --device cuda
    }
    run_chunks infer
    python - <<EOF
import csv, glob
from videollama2_tpu_torch.eval.common import merge_chunks
recs = merge_chunks(sorted(glob.glob("${out}/${CHUNKS}_*.jsonl")),
                    "${out}/merge.json", return_records=True)
with open("${output_file}", "w", newline="") as f:
    w = csv.writer(f)
    w.writerow(["q_uid", "answer"])          # Kaggle submission header
    for r in recs:
        w.writerow([r["q_uid"], r["pred_idx"]])
print(f"wrote {len(recs)} rows to ${output_file}")
EOF
fi
echo "submit ${output_file} to the EgoSchema Kaggle leaderboard"
