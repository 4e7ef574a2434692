#!/bin/bash
# Stage-1 pretrain of the PyTorch/CUDA port: projector-only tuning at lr
# 1e-3, under torchrun on every card of every node.
# Port of scripts/vllava/pretrain.sh: the same flags, plus the reference's
# torchrun plumbing (scripts/torch/lib/torchrun.sh; arguments NNODES and
# NPROC_PER_NODE, or the platform's WORLD_SIZE / NPROC_PER_NODE /
# MASTER_ADDR / MASTER_PORT / RANK). Deviation: --vision_tower is
# VISION_TOWER, a local HF directory the port reads (the default names a
# hub id, which the port refuses: it downloads nothing).
source "$(dirname "${BASH_SOURCE[0]}")/../lib/torchrun.sh"
torch_world "$@"

RUN_NAME=${RUN_NAME:-vllava_pretrain}
DATA_DIR=${DATA_DIR:-datasets/videollava_pt}
OUTP_DIR=${OUTP_DIR:-work_dirs}

GLOBAL_BATCH_SIZE=${GLOBAL_BATCH_SIZE:-256}
LOCAL_BATCH_SIZE=${LOCAL_BATCH_SIZE:-8}
grad_accum

torch_train \
    --model_type videollama2_mistral \
    --model_path ${MODEL_PATH:-mistralai/Mistral-7B-Instruct-v0.2} \
    --vision_tower ${VISION_TOWER:-openai/clip-vit-large-patch14-336} \
    --mm_projector_type stc_connector \
    --mm_vision_select_layer -2 \
    --tune_mm_mlp_adapter true \
    --data_path ${DATA_DIR}/annotations/valley_llavaimage.json \
    --data_folder ${DATA_DIR} \
    --num_frames 8 \
    --model_max_length 2048 \
    --output_dir ${OUTP_DIR}/${RUN_NAME}/pretrain \
    --num_train_epochs 1 \
    --per_device_train_batch_size ${LOCAL_BATCH_SIZE} \
    --gradient_accumulation_steps ${GRAD_ACCUM} \
    --learning_rate 1e-3 \
    --weight_decay 0. \
    --warmup_ratio 0.03 \
    --lr_scheduler_type cosine \
    --save_steps 500 \
    --logging_steps 1 \
    --bf16 true \
    --mesh_fsdp -1 --mesh_tensor 1
