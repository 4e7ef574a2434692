#!/bin/bash
# Stage-2 SFT of the PyTorch/CUDA port: full model (tower frozen) at lr
# 2e-5, pad aspect ratio, under torchrun on every card of every node.
# Port of scripts/vllava/finetune.sh: the same flags and torchrun plumbing
# as scripts/torch/vllava/pretrain.sh. Deviations: --vision_tower is
# VISION_TOWER (see pretrain.sh), and --pretrain_mm_mlp_adapter is the
# newest adapter-{step}/ stage 1 wrote under PRETRAIN_DIR (default
# ${OUTP_DIR}/vllava_pretrain/pretrain): nothing writes the JAX script's
# adapter-latest.
source "$(dirname "${BASH_SOURCE[0]}")/../lib/torchrun.sh"
torch_world "$@"

RUN_NAME=${RUN_NAME:-vllava_finetune}
DATA_DIR=${DATA_DIR:-datasets/videollava_sft}
OUTP_DIR=${OUTP_DIR:-work_dirs}
PRETRAIN_DIR=${PRETRAIN_DIR:-${OUTP_DIR}/vllava_pretrain/pretrain}

GLOBAL_BATCH_SIZE=${GLOBAL_BATCH_SIZE:-128}
LOCAL_BATCH_SIZE=${LOCAL_BATCH_SIZE:-4}
grad_accum

STEP=$(ls -d "${PRETRAIN_DIR}"/adapter-* 2>/dev/null \
       | sed -n 's/.*adapter-\([0-9][0-9]*\)$/\1/p' | sort -n | tail -n 1)
if [ -z "$STEP" ]; then
    echo "no adapter-{step}/ under ${PRETRAIN_DIR}: run stage 1" \
         "(scripts/torch/vllava/pretrain.sh) first" >&2
    exit 1
fi

torch_train \
    --model_type videollama2_mistral \
    --model_path ${MODEL_PATH:-mistralai/Mistral-7B-Instruct-v0.2} \
    --vision_tower ${VISION_TOWER:-openai/clip-vit-large-patch14-336} \
    --mm_projector_type stc_connector \
    --pretrain_mm_mlp_adapter ${PRETRAIN_DIR}/adapter-${STEP} \
    --mm_vision_select_layer -2 \
    --image_aspect_ratio pad \
    --data_path ${DATA_DIR}/annotations/videochatgpt_llavaimage_tune.json \
    --data_folder ${DATA_DIR} \
    --num_frames 8 \
    --model_max_length 2048 \
    --output_dir ${OUTP_DIR}/${RUN_NAME}/finetune \
    --num_train_epochs 1 \
    --per_device_train_batch_size ${LOCAL_BATCH_SIZE} \
    --gradient_accumulation_steps ${GRAD_ACCUM} \
    --learning_rate 2e-5 \
    --weight_decay 0. \
    --warmup_ratio 0.03 \
    --lr_scheduler_type cosine \
    --save_steps 500 \
    --logging_steps 1 \
    --bf16 true \
    --group_by_modality_length true \
    --mesh_fsdp -1 --mesh_tensor 1
