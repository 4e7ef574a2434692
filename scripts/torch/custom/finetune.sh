#!/bin/bash
# Custom full-parameter finetune of the PyTorch/CUDA port (tower frozen,
# 2-LR projector), under torchrun on every card of every node.
# Port of scripts/custom/finetune.sh: the same flags and the torchrun
# plumbing of scripts/torch/lib/torchrun.sh: 4 x 4 (per-card batch x
# accumulation) on every card, as the JAX script's on every device.
# Deviation: --pretrain_mm_mlp_adapter is passed only when ADAPTER_PATH
# is set (the JAX script gives the flag no value without it).
source "$(dirname "${BASH_SOURCE[0]}")/../lib/torchrun.sh"
torch_world "$@"

RUN_NAME=${RUN_NAME:-custom_ft}
DATA_DIR=${DATA_DIR:-datasets/custom_sft}
OUTP_DIR=${OUTP_DIR:-work_dirs}

torch_train \
    --model_type videollama2_mistral \
    --model_path ${MODEL_PATH:-DAMO-NLP-SG/VideoLLaMA2-7B-Base} \
    --mm_projector_type stc_connector \
    ${ADAPTER_PATH:+--pretrain_mm_mlp_adapter ${ADAPTER_PATH}} \
    --data_path ${DATA_DIR}/custom.json \
    --data_folder ${DATA_DIR} \
    --mm_vision_select_layer -2 \
    --image_aspect_ratio pad \
    --num_frames 8 \
    --model_max_length 2048 \
    --output_dir ${OUTP_DIR}/${RUN_NAME} \
    --num_train_epochs 1 \
    --per_device_train_batch_size 4 \
    --gradient_accumulation_steps 4 \
    --learning_rate 2e-5 \
    --mm_projector_lr 2e-5 \
    --warmup_ratio 0.03 \
    --lr_scheduler_type cosine \
    --save_steps 500 --logging_steps 1 --bf16 true \
    --mesh_fsdp -1
