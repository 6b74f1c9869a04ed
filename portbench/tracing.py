"""The traced window and the per-layer metrics read from it.

`traced_window` runs a fixed number of the cell's batches through the same closed
loop under `torch.profiler` (CPU and CUDA activities) and reduces the trace to device
operations a card: their names, starts and durations, the union of their intervals
(busy time), and the host operations in flight during each idle gap. The raw events
are read as `chip_smoke.device_profile` reads them (`chip_smoke.py:361-366`): building
the profiler's Python event tree takes seconds for a window of thousands of launches.

Each per-layer metric is a reader `metrics/<name>.py` with `read(ctx)`, which
returns a number or None (nothing to read: the metric is left out of the line).
"""
from __future__ import annotations

import importlib
import time
from dataclasses import dataclass

import torch

from portbench.roofline import short_kernel_name


@dataclass
class Context:
    traced: dict  # traced_window's result
    work: dict  # the entry's work: kernel id -> roofline.Work, "batch_ms", entry-specific keys
    window: dict  # the measured window (core.Loop.run)
    seconds: float
    syncs: int | None
    chips: int

    def kernel_ms(self, kid: str):
        """(device ms a launch, launches) of port kernel `kid` in the traced window."""
        durs = [d for ops in self.traced["ops"].values() for name, _, d in ops if short_kernel_name(name) == kid]
        return (sum(durs) / len(durs) / 1e3, len(durs)) if durs else (None, 0)


def _union(intervals: list) -> tuple:
    """(total covered us, [(gap start, gap end)]) of sorted (start, end) intervals."""
    busy, gaps, end = 0.0, [], None
    for s, e in intervals:
        if end is None or s > end:
            if end is not None:
                gaps.append((end, s))
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy, gaps


def traced_window(loop, first: int, batches: int, devices: list) -> dict:
    """Run `batches` batches under the profiler. Returns {"window_s", "busy_s" (mean over
    the cards), "busy_by_card" (s), "ops" {card: [(name, start us, duration us)]},
    "batches", "breakdown"}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    cuda = loop.cuda
    mark = "portbench traced window"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    if cuda:
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        loop.run(first - 10_000, batches=2)  # the profiler records no device event in its first ms
        with record_function(mark):
            t0 = time.perf_counter()
            loop.run(first, batches=batches)
            window_s = time.perf_counter() - t0
    events = [e for e in prof.profiler.kineto_results.events() if not getattr(e, "is_hidden_event", lambda: False)()]
    marks = [e for e in events if e.name() == mark]
    start = min(e.start_ns() for e in marks) / 1e3
    stop = max(e.start_ns() + e.duration_ns() for e in marks) / 1e3
    ops: dict = {}
    host = []
    for e in events:
        s, d = e.start_ns() / 1e3, e.duration_ns() / 1e3
        if s < start or s > stop or e.name() == mark:
            continue
        if e.device_type() == DeviceType.CUDA:
            ops.setdefault(e.device_index(), []).append((e.name(), s, d))
        elif e.device_type() == DeviceType.CPU and d > 0:
            host.append((e.name(), s, d))
    busy_by_card, gaps_by_card = {}, {}
    for card, lst in ops.items():
        lst.sort(key=lambda o: o[1])
        busy, gaps = _union([(s, s + d) for _, s, d in lst])
        busy_by_card[card] = busy / 1e6
        gaps_by_card[card] = gaps
    n_cards = len(devices)
    busy_s = sum(busy_by_card.values()) / n_cards if busy_by_card else 0.0
    return {"window_s": window_s, "busy_s": busy_s, "busy_by_card": busy_by_card, "ops": ops, "batches": batches,
            "breakdown": _breakdown(ops, gaps_by_card, host)}


def _breakdown(ops: dict, gaps_by_card: dict, host: list) -> dict:
    """The 10 device operations that took most time (all cards) and the lead card's 10
    longest idle gaps, each named by the shortest host operation in flight at its
    middle."""
    by_name: dict = {}
    for lst in ops.values():
        for name, _, d in lst:
            key = short_kernel_name(name)
            by_name[key] = by_name.get(key, 0.0) + d / 1e6
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    idle = []
    if gaps_by_card:
        lead = min(gaps_by_card)
        for a, b in sorted(gaps_by_card[lead], key=lambda g: g[0] - g[1])[:10]:
            mid = (a + b) / 2
            inflight = [(d, name) for name, s, d in host if s <= mid <= s + d]
            idle.append([min(inflight)[1][:60] if inflight else "host idle", (b - a) / 1e6])
    return {"device_ops": [[k, v] for k, v in device_ops], "idle_gaps": idle}


def read_metrics(ctx: Context, per_layer: list, cell: str) -> dict:
    """Every per-layer metric of BENCHMARK.json that applies to `cell` and whose reader
    finds something to read."""
    out = {}
    for m in per_layer:
        if cell not in m.get("workloads", [cell]):
            continue
        value = importlib.import_module(f"portbench.metrics.{m['name']}").read(ctx)
        if value is not None:
            out[m["name"]] = value
    return out
