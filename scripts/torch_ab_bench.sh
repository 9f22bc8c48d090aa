#!/usr/bin/env bash
# Interleaved A/B timing of the PyTorch port's bench across source trees.
#
#   scripts/torch_ab_bench.sh ROUNDS OUTDIR TREE... -- BENCH_ARGS...
#
# Each TREE is a checkout (e.g. the parent unpacked with `git archive`).
# Round i runs `python3 -m porousfreezethaw_tpu_torch.bench BENCH_ARGS`
# once from every tree, in the given order on odd rounds and reversed on
# even ones, so that neither side always runs first.  Prints one line per
# run, "TREE rc=RC ms_per_attempt", after the card's name and power limit;
# each run's full output goes to OUTDIR/<tree>_<round>.log.
#
# Example (the f64 LR row, plain PyTorch path):
#   scripts/torch_ab_bench.sh 8 build/ab build/parent build/change -- \
#       --device cuda:0 --grid-nodes 100 --steps 100 --warm-steps 20 \
#       --fused off --dtype f64
set -u
rounds=$1; out=$2; shift 2
trees=()
while [ $# -gt 0 ] && [ "$1" != "--" ]; do trees+=("$1"); shift; done
shift
mkdir -p "$out"
out=$(cd "$out" && pwd)
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader
run() {
    local tree=$1 round=$2 log
    log="$out/$(basename "$tree")_$round.log"
    (cd "$tree" && python3 -m porousfreezethaw_tpu_torch.bench "${@:3}" \
        > "$log" 2>&1)
    local rc=$?
    echo "$(basename "$tree") rc=$rc $(grep -o '"ms_per_attempt": [0-9.]*' \
        "$log" | cut -d' ' -f2)"
}
for ((i = 1; i <= rounds; i++)); do
    order=("${trees[@]}")
    if ((i % 2 == 0)); then
        order=(); for ((j = ${#trees[@]} - 1; j >= 0; j--)); do
            order+=("${trees[j]}"); done
    fi
    for tree in "${order[@]}"; do run "$tree" "$i" "$@"; done
done
