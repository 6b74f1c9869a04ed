"""Small sizes of the cells, for runs on the CPU: the program's CPU path (its
kernels' plain twins) under the harness, with the same code as on the card."""
from __future__ import annotations

import time

import torch

from portbench import core

SEED = 2**31 + 12_345  # larger than 32 signed bits hold, as a check's seeds may be

OVERRIDES = {
    # past the chunkmax lane's floor of 524,288 rows, and not a multiple of its 2,048
    "flat_msmarco1.b256": {"config": {"rows": 530_001, "dim": 8},
                           "workload": {"batch": 8, "check_queries": 8, "trace_batches": 2}},
    "shard_msmarco2.b64": {"config": {"rows": 4 << 20, "dim": 8},
                           "workload": {"batch": 4, "check_queries": 4, "trace_batches": 2}},
}


def chips(cell: str) -> int:
    return next(w["chips"] for w in core.load_json(core.BENCH_FILE)["workloads"] if w["name"] == cell)


def run(cell: str, trace: bool = False, seconds: float = 1.0, control: bool = False, seed: int = SEED) -> dict:
    """One run of `cell` at its small size on the CPU."""
    return core.run_cell(cell, seed, seconds, trace, [torch.device("cpu")] * chips(cell), time.perf_counter(),
                         overrides=OVERRIDES[cell], log=lambda msg: None, control=control)
