"""Run one cell of the port's benchmark once and print its result as the last line.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with as many CUDA devices as the cell asks
for. `--trace 0` measures the cell's end-to-end metrics, `--trace 1` adds a traced
window and reports its per-layer metrics. Either way the checked batches of the
measured window are held against the plain reference; the numbers compared, each
with its limit, end standard error and the result line (`checks`).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(CHECKOUT))
# kernel caches at fixed places inside the checkout (the port builds its own library
# under wax_tpu_torch/_build/ there)
os.environ.setdefault("TRITON_CACHE_DIR", str(CHECKOUT / "portbench" / ".cache" / "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(CHECKOUT / "portbench" / ".cache" / "torch_extensions"))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    t = [time.perf_counter()]
    import torch

    t.append(time.perf_counter())
    from portbench import core

    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    bench = core.load_json(core.BENCH_FILE)
    cell, _, _ = core.load_cell(args.workload, bench)
    chips = int(cell["chips"])
    t.append(time.perf_counter())
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {chips} CUDA device(s); this machine has {n}", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", i) for i in range(chips)]
    t.append(time.perf_counter())
    opened = core.open_cards(devices)
    torch.cuda.set_device(devices[0])
    t.append(time.perf_counter())
    log(f"set-up: import torch {t[1] - t[0]:.3f} s, the harness {t[2] - t[1]:.3f} s, the driver's device count "
        f"{t[3] - t[2]:.3f} s, CUDA contexts {t[4] - t[3]:.3f} s (cards {', '.join(f'{s:.3f}' for s in opened)})")
    result = core.run_cell(args.workload, args.seed, args.seconds, bool(args.trace), devices, T_START, bench, log=log)
    bad = core.forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package were loaded: {bad}", file=sys.stderr)
        return 3
    for line in core.check_lines(result["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(core.json_safe(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
