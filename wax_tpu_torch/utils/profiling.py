# Copy of wax_tpu/utils/profiling.py with one change: `device_trace` records a
# torch.profiler trace (CPU and CUDA activity) and writes it into `log_dir` as a
# Chrome trace, where the JAX package wraps jax.profiler. Keep the two in step.
"""Profiling hooks: torch.profiler device traces + lightweight wall-clock spans.

The reference has no tracing framework — counters are hand-rolled stats structs
(SURVEY.md §5); this module keeps that pattern (span counters surface through
runtime stats) and adds the device piece: `device_trace` wraps `torch.profiler` so
any engine call can be captured as a Chrome trace (chrome://tracing, Perfetto).
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

__all__ = ["device_trace", "span", "span_stats", "reset_spans"]

_spans: dict[str, list[float]] = defaultdict(list)
# spans record from the orchestrator's CONCURRENT read phase; snapshotting under
# the same lock keeps span_stats() from iterating a dict being resized
_spans_lock = threading.Lock()


@contextlib.contextmanager
def device_trace(log_dir: str):
    """Capture a torch.profiler trace of the block (CPU ops, and CUDA kernels when a
    card is present) into `log_dir`/trace-<pid>-<n>.json (Chrome trace format)."""
    import os
    from pathlib import Path

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    n = len(list(out.glob(f"trace-{os.getpid()}-*.json")))
    prof.export_chrome_trace(str(out / f"trace-{os.getpid()}-{n}.json"))


@contextlib.contextmanager
def span(name: str):
    """Wall-clock span recorded into process-wide stats."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        with _spans_lock:
            _spans[name].append(dt)


def span_stats() -> dict[str, dict]:
    out = {}
    with _spans_lock:
        snapshot = {name: list(times) for name, times in _spans.items()}
    for name, times in snapshot.items():
        s = sorted(times)
        n = len(s)
        out[name] = {
            "count": n,
            "total_ms": round(sum(s) * 1e3, 3),
            "p50_ms": round(s[n // 2] * 1e3, 3),
            "p95_ms": round(s[min(n - 1, int(n * 0.95))] * 1e3, 3),
        }
    return out


def reset_spans() -> None:
    with _spans_lock:
        _spans.clear()
