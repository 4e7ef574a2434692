#!/bin/bash
# MSVC multi-sentence captioning: inference + correctness & detailedness
# PyTorch/CUDA port of scripts/eval/eval_video_cap_msvc.sh: the same inference,
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
out=${OUTPUT_DIR}/msvc/answers/${CKPT_NAME}
output_file=${out}/merge.json
if [ ! -f "$output_file" ]; then
    infer() {
        python -m videollama2_tpu_torch.eval.inference_video_cap_msvc \
            --model-path ${CKPT} \
            --video-folder ${EVAL_DATA_DIR}/msvc \
            --question-file ${EVAL_DATA_DIR}/msvc/msvc.json \
            --output-file ${out}/${CHUNKS}_${1}.jsonl \
            --num-chunks $CHUNKS --chunk-idx $1 \
            --device cuda
    }
    run_chunks infer
    python - <<PYEOF
from videollama2_tpu_torch.eval.common import merge_chunks
import glob
merge_chunks(sorted(glob.glob("${out}/${CHUNKS}_*.jsonl")), "${output_file}")
PYEOF
fi
python -m videollama2_tpu_torch.eval.gpt_judge --dimension msvc_correctness \
    --pred-file ${output_file} --output-dir ${out}/judge_correctness \
    --output-json ${out}/results_correctness.json ${JUDGE_ARGS:---api none}
python -m videollama2_tpu_torch.eval.gpt_judge --dimension msvc_detailedness \
    --pred-file ${output_file} --output-dir ${out}/judge_detailedness \
    --output-json ${out}/results_detailedness.json ${JUDGE_ARGS:---api none}
