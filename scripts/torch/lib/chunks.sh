# Sourced by the port's eval scripts (scripts/torch/eval/): one inference
# chunk a card, as the reference's eval scripts run them.
#
# eval_cards: GPULIST, the cards of CUDA_VISIBLE_DEVICES, or every card
# torch sees when it is unset; CHUNKS defaults to their number.
eval_cards() {
    if [ -n "${CUDA_VISIBLE_DEVICES+set}" ]; then
        IFS=',' read -ra GPULIST <<< "$CUDA_VISIBLE_DEVICES"
    else
        local n
        n=$(python -c "import torch; print(torch.cuda.device_count())") \
            || exit 1
        GPULIST=()
        for ((i = 0; i < n; i++)); do GPULIST+=("$i"); done
    fi
    if [ ${#GPULIST[@]} -eq 0 ]; then
        echo "no CUDA card to evaluate on" >&2
        exit 1
    fi
    CHUNKS=${CHUNKS:-${#GPULIST[@]}}
}

# run_chunks FN: FN IDX for IDX in 0 .. CHUNKS-1, all at once, chunk IDX
# with CUDA_VISIBLE_DEVICES=${GPULIST[IDX % cards]}; fails if any chunk
# fails.
run_chunks() {
    local fn=$1 idx pids=() failed=0
    for ((idx = 0; idx < CHUNKS; idx++)); do
        (
            export CUDA_VISIBLE_DEVICES=${GPULIST[$((idx % ${#GPULIST[@]}))]}
            "$fn" "$idx"
        ) &
        pids+=($!)
    done
    for pid in "${pids[@]}"; do
        wait "$pid" || failed=1
    done
    if [ $failed -ne 0 ]; then
        echo "an inference chunk failed" >&2
        exit 1
    fi
}
