#!/bin/bash
# The check's readings for one cell: the program's and the control's numbers on COUNT
# seeds from SEED0, in one process (portbench/control.py), then RUNS full-length runs.
# Usage: readings.sh CELL SEED0 COUNT [RUNS]; logs under $OUT/readings/ (OUT=portbench_out).
set -u
cell=$1; seed0=$2; count=$3; runs=${4:-0}
out=${OUT:-portbench_out}/readings
mkdir -p "$out"
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader | head -1
seeds=$(python3 -c "print(','.join(str($seed0 + i) for i in range($count)))")
python3 portbench/control.py --workload "$cell" --seeds "$seeds" --seconds 3 > "$out/$cell.control.jsonl" 2> "$out/$cell.control.err"
echo "control rc $?"; cat "$out/$cell.control.jsonl"; grep -E "Traceback|Error" "$out/$cell.control.err"
for i in $(seq 1 "$runs"); do
  s=$((seed0 + 100 + i))
  python3 portbench/run.py --workload "$cell" --seed $s --seconds 20 --trace 0 > "$out/$cell.run$s.out" 2> "$out/$cell.run$s.err"
  echo "run seed $s rc $?"; tail -n 1 "$out/$cell.run$s.out" | cut -c1-600
done
