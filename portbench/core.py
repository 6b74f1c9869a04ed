"""One run of one cell: set-up, the measured window, the traced window, the check.

Everything that belongs to one cell is found by name: the cell in `BENCHMARK.json`,
its traffic in `workloads/<cell>.json`, its configuration in
`configs/<config>.json` (whose `entry` names the adapter `entries/<entry>.py` that
drives the program and holds its check), and each per-layer metric's reader in
`metrics/<metric>.py`.

The window is a closed loop with `in_flight` batches in flight: batch i + 1 is
dispatched before batch i's top-k is copied to the host and waited for. A batch's
latency runs from its dispatch to its top-k on the host; `qps` counts the queries
whose top-k reached the host inside the window.
"""
from __future__ import annotations

import gc
import importlib
import json
import math
import sys
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BENCH_FILE = ROOT.parent / "BENCHMARK.json"
FORBIDDEN = ("jax", "jaxlib", "flax", "wax_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench: dict | None = None) -> tuple:
    """(the cell's BENCHMARK.json entry, its configuration, its workload file)."""
    bench = bench or load_json(BENCH_FILE)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return cell, load_json(ROOT.parent / config["file"]), load_json(ROOT / "workloads" / f"{name}.json")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's (whole names:
    `wax_tpu_torch` is not `wax_tpu`)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def open_cards(devices: list) -> list:
    """Create every card's CUDA context, the cards at once (a thread each, so that four
    cards take about as long as one); the seconds each card took."""
    def one(dev):
        t = time.perf_counter()
        torch.cuda.set_device(dev)
        torch.empty(1, device=dev)
        torch.cuda.synchronize(dev)
        return time.perf_counter() - t

    torch.cuda.init()
    with ThreadPoolExecutor(len(devices)) as pool:
        return list(pool.map(one, devices))


class Tap:
    """Records (args, result) of calls to a module attribute while armed."""

    def __init__(self, module_name: str, attr: str):
        self.module = importlib.import_module(module_name)
        self.attr = attr
        self.orig = getattr(self.module, attr)
        self.armed = False
        self.seen: list = []
        setattr(self.module, attr, self)

    def __call__(self, *args, **kwargs):
        out = self.orig(*args, **kwargs)
        if self.armed:
            self.seen.append((args, out))
        return out

    def remove(self) -> None:
        setattr(self.module, self.attr, self.orig)


class Loop:
    """The closed loop over one entry: dispatch, copy to the host, wait."""

    def __init__(self, entry, make_batch, in_flight: int, device: torch.device, taps: list):
        self.entry, self.make, self.in_flight, self.taps = entry, make_batch, in_flight, taps
        self.cuda = device.type == "cuda"
        self.host = None

    def _host_buffers(self, out) -> list:
        if self.host is None:
            self.host = [[torch.empty(t.shape, dtype=t.dtype, pin_memory=self.cuda) for t in out]
                         for _ in range(self.in_flight)]
        return self.host

    def run(self, first: int, seconds: float | None = None, batches: int | None = None, sample: int = 0,
            rng: np.random.Generator | None = None):
        """Batches first, first + 1, ... for `seconds` (or `batches` batches). With
        `sample`, a uniform sample (drawn by `rng`) of that many of the batches that
        complete inside the window keeps its inputs, host outputs and tapped calls.
        Returns {"latency_s", "call_s", "done", "dispatched", "kept": {i: (batch, host
        outputs, taps)}, "next"}."""
        pending: deque = deque()
        lat, calls, kept = [], [], []
        i = first
        t0 = time.perf_counter()
        t_end = t0 + seconds if seconds is not None else math.inf
        done = 0
        while True:
            now = time.perf_counter()
            more = now < t_end and (batches is None or i < first + batches)
            if more:
                batch = self.make(i)
                for tap in self.taps:
                    tap.armed, tap.seen = bool(sample), []
                t_disp = time.perf_counter()
                out = self.entry.call(batch)
                calls.append(time.perf_counter() - t_disp)
                for tap in self.taps:
                    tap.armed = False
                bufs = self._host_buffers(out)[i % self.in_flight]
                for h, t in zip(bufs, out):
                    h.copy_(t, non_blocking=self.cuda)
                ev = None
                if self.cuda:
                    ev = torch.cuda.Event()
                    ev.record(torch.cuda.current_stream(out[0].device))
                taps = {tap.attr: tap.seen for tap in self.taps}
                pending.append((i, t_disp, ev, bufs, batch if sample else None, taps))
                i += 1
            if not pending:
                break
            if len(pending) >= self.in_flight or not more:
                j, t_disp, ev, bufs, batch, taps = pending.popleft()
                if ev is not None:
                    ev.synchronize()
                t_done = time.perf_counter()
                if t_done > t_end:
                    continue
                lat.append(t_done - t_disp)
                done += 1
                if sample:  # reservoir sampling over the batches completed in the window
                    slot = len(kept) if len(kept) < sample else int(rng.integers(done))
                    if slot < sample:
                        entry = (j, batch, [h.clone().numpy() for h in bufs], taps)
                        if slot == len(kept):
                            kept.append(entry)
                        else:
                            kept[slot] = entry
        return {"latency_s": lat, "call_s": calls, "done": done, "dispatched": i - first,
                "kept": {j: rest for j, *rest in kept}, "next": i}


def p95(values: list) -> float:
    """The 95th percentile (linear between order statistics)."""
    return float(np.percentile(np.asarray(values), 95))


def sync_calls(fn, cuda: bool):
    """Synchronising CUDA calls a warm fn() made, under torch.cuda.set_sync_debug_mode
    ("warn"); one untimed call runs first. A copy of `chip_smoke.sync_calls`
    (`chip_smoke.py:2213-2232`). None off the card."""
    import warnings

    if not cuda:
        return None
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    return sum(1 for w in seen if "called a synchronizing" in str(w.message))


def run_cell(name: str, seed: int, seconds: float, trace: bool, devices: list, t_start: float,
             bench: dict | None = None, overrides: dict | None = None, log=print, control: bool = False) -> dict:
    """One run; returns the result object (the last line's keys). `overrides` replaces
    configuration and workload keys (the tests' small sizes); `control` also reads the
    control's numbers on the same batches (under "control")."""
    bench = bench or load_json(BENCH_FILE)
    _, cfg, wl = load_cell(name, bench)
    cfg = {**cfg, **(overrides or {}).get("config", {})}
    wl = {**wl, **(overrides or {}).get("workload", {})}
    t_import = time.perf_counter()
    mod = importlib.import_module(f"portbench.entries.{cfg['entry']}")  # the program with it
    cuda = devices[0].type == "cuda"
    lead = devices[0]
    taps = [Tap(m, a) for m, a in mod.TAPS]
    try:
        if cuda:
            for d in devices:
                torch.cuda.reset_peak_memory_stats(d)
        from portbench.traffic import make_batch

        t_entry = time.perf_counter()
        entry = mod.Entry(cfg, wl, seed, devices)
        t_warm = time.perf_counter()
        loop = Loop(entry, lambda i: make_batch(wl, cfg, seed, i, lead), int(wl["in_flight"]), lead, taps)
        loop.run(-int(wl["warm_batches"]) - 1_000_000, batches=int(wl["warm_batches"]))
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s (before the cell {t_import - t_start:.3f}, program import "
            f"{t_entry - t_import:.3f}, inputs and program state {t_warm - t_entry:.3f}, warm-up "
            f"{time.perf_counter() - t_warm:.3f})")
        gc.collect()
        win = loop.run(0, seconds=seconds, sample=int(wl["check_batches"]),
                       rng=np.random.default_rng([seed % 2**63, 17]))
        log(f"checking batches {sorted(win['kept'])} of {win['done']}")
        if not win["latency_s"]:
            raise RuntimeError(f"no batch completed in the {seconds} s window")
        mem = max(torch.cuda.max_memory_allocated(d) for d in devices) if cuda else 0
        b = int(wl["batch"])
        result = {"correct": False, "attempted": win["dispatched"] * b, "failed": 0, "metrics": {}}
        e2e = {"qps": win["done"] * b / seconds, "batch_p95_ms": p95(win["latency_s"]) * 1e3, "setup_s": setup_s}
        device = {"platform": "gpu" if cuda else "cpu",
                  "kind": torch.cuda.get_device_name(lead) if cuda else "cpu",
                  "count": len(devices), "memory_peak_bytes": int(mem)}
        if trace:
            from portbench import tracing

            traced = tracing.traced_window(loop, win["next"], int(wl["trace_batches"]), devices)
            work = entry.work(loop.make(win["next"]))
            ctx = tracing.Context(traced=traced, work=work, window=win, seconds=seconds,
                                  syncs=sync_calls(lambda: entry.call(loop.make(-1)), cuda), chips=len(devices))
            metrics = tracing.read_metrics(ctx, bench["per_layer"], name)
            device.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
            result["breakdown"] = traced["breakdown"]
        else:
            metrics = {m["name"]: e2e[m["name"]] for m in bench["end_to_end"] if name in m.get("workloads", [name])}
        units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
        result["metrics"] = {k: {"value": v, "unit": units[k]} for k, v in metrics.items()}
        result["device"] = device
        for tap in taps:
            tap.remove()
        taps = []
        entry.free_program()
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()
        numbers = judge(entry, win["kept"], wl, seed, log)
        limits = cfg["limits"]
        result["correct"] = bool(numbers) and all(numbers[k] <= limits[k] for k in mod.CHECKS)
        result["checks"] = {k: {"value": numbers.get(k, math.inf), "limit": limits[k]} for k in mod.CHECKS}
        if control:
            result["control"] = judge(entry, win["kept"], wl, seed, log, control=True)
        return result
    finally:
        for tap in taps:
            tap.remove()


def judge(entry, kept: dict, wl: dict, seed: int, log, control: bool = False) -> dict:
    """The cell's numbers over the checked batches: each the worst over the batches
    and the queries drawn from the seed in each. With `control`, of the reference in
    the program's place, one precision below (`entry.control`)."""
    numbers: dict = {}
    if not kept:
        log("check: no checked batch completed in the window")
        return numbers
    for i, (batch, outputs, taps) in sorted(kept.items()):
        b = batch["queries"].shape[0]
        pick = np.sort(np.random.default_rng([seed % 2**63, 23, i]).choice(
            b, min(b, int(wl["check_queries"])), replace=False))
        got = entry.control(batch, pick) if control else entry.check(batch, outputs, taps, pick)
        for k, v in got.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def check_lines(checks: dict) -> list:
    return [f"check {k}: {c['value']!r} (limit {c['limit']!r})" for k, c in checks.items()]


def json_safe(obj):
    """Non-finite numbers as strings (JSON has no inf)."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    if isinstance(obj, dict):
        return {k: json_safe(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [json_safe(v) for v in obj]
    return obj
