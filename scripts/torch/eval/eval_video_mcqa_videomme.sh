#!/bin/bash
# Video-MME eval: chunk-sharded inference workers + merge + scorer, run on
# both the no-subtitle and with-subtitle answer sets.
# PyTorch/CUDA port of scripts/eval/eval_video_mcqa_videomme.sh: the same inference,
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

out=${OUTPUT_DIR}/videomme/answers/${CKPT_NAME}
output_file=${out}/merge.json
output_sub_file=${out}/merge_sub.json

if [ ! -f "$output_file" ]; then
    infer() {
        python -m videollama2_tpu_torch.eval.inference_video_mcqa_videomme \
            --model-path ${CKPT} \
            --video-folder ${EVAL_DATA_DIR}/videomme/videos \
            --subtitle-folder ${EVAL_DATA_DIR}/videomme/subtitles \
            --question-file ${EVAL_DATA_DIR}/videomme/test-00000-of-00001.parquet \
            --answer-file ${out}/${CHUNKS}_${1}.json \
            --num-chunks $CHUNKS --chunk-idx $1 \
            --device cuda
    }
    run_chunks infer
    python - <<EOF
from videollama2_tpu_torch.eval.common import merge_chunks
import glob
nosub = sorted(p for p in glob.glob("${out}/${CHUNKS}_*.json")
               if not p.endswith("_sub.json"))
sub = sorted(glob.glob("${out}/${CHUNKS}_*_sub.json"))
n = merge_chunks(nosub, "${output_file}")
m = merge_chunks(sub, "${output_sub_file}")
print(f"merged {n} records (+{m} with subtitles)")
EOF
fi

for f in ${output_file} ${output_sub_file}; do
    python -m videollama2_tpu_torch.eval.eval_video_mcqa_videomme \
        --results_file ${f} \
        --video_duration_type "short,medium,long" \
        --return_categories_accuracy \
        --return_sub_categories_accuracy \
        --return_task_types_accuracy \
        --skip_missing
done
