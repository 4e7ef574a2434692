#!/bin/bash
# Custom LoRA finetune of the PyTorch/CUDA port: r=128, alpha=256,
# projector lr 2e-5, under torchrun on every card of every node.
# Port of scripts/custom/finetune_lora.sh: the same flags and the torchrun
# plumbing of scripts/torch/custom/finetune.sh.
source "$(dirname "${BASH_SOURCE[0]}")/../lib/torchrun.sh"
torch_world "$@"

RUN_NAME=${RUN_NAME:-custom_lora}
DATA_DIR=${DATA_DIR:-datasets/custom_sft}
OUTP_DIR=${OUTP_DIR:-work_dirs}

torch_train \
    --lora_enable true --lora_r 128 --lora_alpha 256 \
    --mm_projector_lr 2e-5 \
    --model_type videollama2_mistral \
    --model_path ${MODEL_PATH:-DAMO-NLP-SG/VideoLLaMA2-7B} \
    --data_path ${DATA_DIR}/custom.json \
    --data_folder ${DATA_DIR} \
    --num_frames 8 \
    --model_max_length 2048 \
    --output_dir ${OUTP_DIR}/${RUN_NAME} \
    --num_train_epochs 1 \
    --per_device_train_batch_size 4 \
    --gradient_accumulation_steps 4 \
    --learning_rate 2e-5 \
    --warmup_ratio 0.03 \
    --lr_scheduler_type cosine \
    --save_steps 500 --logging_steps 1 --bf16 true \
    --mesh_fsdp -1
