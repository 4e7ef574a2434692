# Sourced by the port's training scripts (scripts/torch/{vllava,custom}/):
# the reference's torchrun plumbing and the gradient accumulation.
#
# torch_world [NNODES [NPROC_PER_NODE]]: the node count, processes a node,
# master address and port and this node's rank, from the platform's
# WORLD_SIZE (nodes), NPROC_PER_NODE, MASTER_ADDR, MASTER_PORT and RANK
# where they are all set, else from the single-node fallbacks
# ARG_WORLD_SIZE (the first argument, else 1), ARG_NPROC_PER_NODE (the
# second, else every card torch sees), ARG_MASTER_ADDR (127.0.0.1),
# ARG_MASTER_PORT (16666) and ARG_RANK (0).
torch_world() {
    ARG_WORLD_SIZE=${1:-${ARG_WORLD_SIZE:-1}}
    ARG_NPROC_PER_NODE=${2:-${ARG_NPROC_PER_NODE:-}}
    ARG_MASTER_ADDR=${ARG_MASTER_ADDR:-127.0.0.1}
    ARG_MASTER_PORT=${ARG_MASTER_PORT:-16666}
    ARG_RANK=${ARG_RANK:-0}
    if [ -z "$WORLD_SIZE" ] || [ -z "$NPROC_PER_NODE" ]; then
        WORLD_SIZE=$ARG_WORLD_SIZE
        if [ -z "$ARG_NPROC_PER_NODE" ]; then
            ARG_NPROC_PER_NODE=$(python -c \
                "import torch; print(torch.cuda.device_count())") || exit 1
        fi
        NPROC_PER_NODE=$ARG_NPROC_PER_NODE
    fi
    if [ -z "$MASTER_ADDR" ] || [ -z "$MASTER_PORT" ] || [ -z "$RANK" ]; then
        MASTER_ADDR=$ARG_MASTER_ADDR
        MASTER_PORT=$ARG_MASTER_PORT
        RANK=$ARG_RANK
    fi
    case $NPROC_PER_NODE in
        '' | *[!0-9]* | 0)
            echo "NPROC_PER_NODE=$NPROC_PER_NODE: no CUDA card to train on" >&2
            exit 1 ;;
    esac
    echo "WORLD_SIZE (nodes): $WORLD_SIZE  NPROC_PER_NODE: $NPROC_PER_NODE"
}

# grad_accum: GRAD_ACCUM = GLOBAL_BATCH_SIZE / (LOCAL_BATCH_SIZE x
# NPROC_PER_NODE x WORLD_SIZE), refused unless that product divides the
# global batch (a quotient of 0 included).
grad_accum() {
    local per_step=$((LOCAL_BATCH_SIZE * NPROC_PER_NODE * WORLD_SIZE))
    if [ "$per_step" -lt 1 ] || [ "$GLOBAL_BATCH_SIZE" -lt "$per_step" ]; then
        echo "GLOBAL_BATCH_SIZE=$GLOBAL_BATCH_SIZE is below LOCAL_BATCH_SIZE" \
             "x NPROC_PER_NODE x nodes = $LOCAL_BATCH_SIZE x" \
             "$NPROC_PER_NODE x $WORLD_SIZE = $per_step: the gradient" \
             "accumulation would be 0" >&2
        exit 1
    fi
    if [ $((GLOBAL_BATCH_SIZE % per_step)) -ne 0 ]; then
        echo "GLOBAL_BATCH_SIZE=$GLOBAL_BATCH_SIZE is not a multiple of" \
             "LOCAL_BATCH_SIZE x NPROC_PER_NODE x nodes = $LOCAL_BATCH_SIZE" \
             "x $NPROC_PER_NODE x $WORLD_SIZE = $per_step" >&2
        exit 1
    fi
    GRAD_ACCUM=$((GLOBAL_BATCH_SIZE / per_step))
}

# torch_train FLAGS...: videollama2_tpu_torch.train.train under torchrun
# on this node.
torch_train() {
    torchrun --nnodes "$WORLD_SIZE" \
        --nproc_per_node "$NPROC_PER_NODE" \
        --master_addr "$MASTER_ADDR" \
        --master_port "$MASTER_PORT" \
        --node_rank "$RANK" \
        -m videollama2_tpu_torch.train.train "$@"
}
