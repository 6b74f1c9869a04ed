#!/bin/bash
# The spread of one cell: two sets of 6 runs at the benchmark's run_seconds on the same
# 6 seeds from SEED0, then TRACED runs with --trace 1 on further seeds.
# Usage: sets.sh CELL SEED0 [TRACED]; result lines in $OUT/sets/CELL.jsonl (OUT=portbench_out).
set -u
cell=$1; seed0=$2; traced=${3:-3}
out=${OUT:-portbench_out}/sets
mkdir -p "$out"
secs=$(python3 -c "import json; print(json.load(open('BENCHMARK.json'))['run_seconds'])")
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -1
run() {  # set seed trace
  python3 portbench/run.py --workload "$cell" --seed "$2" --seconds "$secs" --trace "$3" > "$out/$cell.$1.$2.out" 2> "$out/$cell.$1.$2.err"
  rc=$?
  line=$(tail -n 1 "$out/$cell.$1.$2.out")
  echo "{\"set\": \"$1\", \"seed\": $2, \"trace\": $3, \"rc\": $rc, \"result\": ${line:-null}}" >> "$out/$cell.jsonl"
  echo "$1 seed $2 trace $3 rc $rc"
}
for set in A B; do
  for i in 0 1 2 3 4 5; do run $set $((seed0 + i)) 0; done
done
for i in $(seq 1 "$traced"); do run T $((seed0 + 50 + i)) 1; done
