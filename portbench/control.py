"""Readings that the check's limits are set from, for one cell on the card:

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 --seconds 3

For each seed, in one process, a run of the cell (a short window, no trace) reads the
program's numbers on its checked batches, and the control (the plain reference in the
program's place, one precision below what the configuration states: bf16 products or
sums where it states f32 accumulation) reads the same numbers on the same batches.
One JSON line a seed: {"seed", "program": {number: value}, "control": {...}}. The
benchmark's own runs never run this.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from portbench import core

    bench = core.load_json(core.BENCH_FILE)
    cell, _, _ = core.load_cell(args.workload, bench)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    torch.cuda.set_device(devices[0])
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        r = core.run_cell(args.workload, seed, args.seconds, False, devices, t0, bench,
                          log=lambda msg: print(msg, file=sys.stderr, flush=True), control=True)
        print(json.dumps(core.json_safe({"seed": seed, "program": {k: c["value"] for k, c in r["checks"].items()},
                                         "control": r["control"], "seconds": time.perf_counter() - t0})),
              flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
