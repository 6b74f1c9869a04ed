# Changed copy of wax_tpu/utils/profiling.py: `span`, `span_stats` and `reset_spans`
# keep its API, with each name's percentiles over its latest 4,096 samples; the port
# adds a tracing switch with CUDA-event device spans (`set_tracing`, `device_span`,
# `drain_spans`) and always-on named counters (`count`, `counters`), and has no
# `device_trace`. Keep the two in step.
"""Profiling hooks: wall-clock span stats, device spans and named counters.

The reference has no tracing framework — counters are hand-rolled stats structs
(SURVEY.md §5); this module keeps that pattern (span counters surface through
runtime stats) and adds the device piece.

* `span(name)`: always on. Each name keeps an exact count and total and the
  percentiles of its latest `SAMPLES` durations, so a long-running server's stats
  stay bounded.
* `device_span(name, device)`: off by default; while off it returns one shared no-op
  after a single flag check. While `set_tracing(True)` holds, each span records its
  name, a request id (a top-level span takes a new one, its children inherit it), its
  parent, host start and end (`time.perf_counter_ns`) and a pair of timing events on
  the device's current stream; the block also runs inside
  `torch.profiler.record_function(name)` when a profiler is active. Nothing on the
  call path synchronises or copies to the host: `drain_spans()` waits for the events,
  puts their times on the host clock through one anchor event a card (recorded, with
  a synchronise, by `set_tracing(True)`), returns the records and clears the buffer.
  While tracing is on, `span` writes a host-only record into the same buffer.
* `count(name)`: always-on counters (the kernel library counts each launch by its
  entry name); `counters()` reads them.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import Counter, defaultdict, deque
from dataclasses import dataclass

import torch

__all__ = ["span", "span_stats", "reset_spans", "set_tracing", "tracing_enabled", "device_span", "drain_spans",
           "SpanRecord", "count", "counters", "reset_counters"]

SAMPLES = 4096  # durations kept a span name for its percentiles
SPAN_BUFFER = 1 << 16  # records held between drains; past it the oldest are dropped ("spans.dropped")


class _Samples:
    __slots__ = ("count", "total", "recent")

    def __init__(self):
        self.count, self.total, self.recent = 0, 0.0, deque(maxlen=SAMPLES)


_spans: dict[str, _Samples] = defaultdict(_Samples)
# spans record from the orchestrator's CONCURRENT read phase; snapshotting under
# the same lock keeps span_stats() from iterating a dict being resized
_spans_lock = threading.Lock()

_counts: Counter = Counter()
_counts_lock = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add `n` to counter `name`."""
    with _counts_lock:
        _counts[name] += n


def counters() -> dict[str, int]:
    """A snapshot of every counter."""
    with _counts_lock:
        return dict(_counts)


def reset_counters() -> None:
    with _counts_lock:
        _counts.clear()


@dataclass
class SpanRecord:
    """One span. Host times are `time.perf_counter_ns`; device times (set by
    `drain_spans`, None for a host-only span) are on the same clock."""

    name: str
    id: int
    parent: int | None
    request: int
    device: int | None  # CUDA device index
    host_start_ns: int = 0
    host_end_ns: int = 0
    device_start_ns: int | None = None
    device_end_ns: int | None = None

    @property
    def device_ms(self) -> float | None:
        if self.device_start_ns is None:
            return None
        return (self.device_end_ns - self.device_start_ns) / 1e6


_tracing = False
_NOOP = contextlib.nullcontext()
_local = threading.local()  # .stack: the thread's open spans
_ids = itertools.count(1)
_requests = itertools.count(1)
_lock = threading.Lock()  # the buffer, the event pool and the anchors
_records: deque = deque()  # (record, (start, end) events and the card's anchor, or None, None)
_pool: dict[int, list] = defaultdict(list)  # device index -> resolved timing events
_anchors: dict[int, tuple] = {}  # device index -> (event, host ns at its device time)


def tracing_enabled() -> bool:
    return _tracing


def set_tracing(on: bool) -> None:
    """Turn device spans on or off. Turning them on records one anchor event on each
    visible card and waits for it (the only synchronisation tracing makes)."""
    global _tracing
    if on and torch.cuda.is_available():
        anchors = {}
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
            ev = torch.cuda.Event(enable_timing=True)
            t0 = time.perf_counter_ns()
            ev.record(torch.cuda.current_stream(i))
            ev.synchronize()
            anchors[i] = (ev, (t0 + time.perf_counter_ns()) // 2)
        with _lock:
            _anchors.update(anchors)
    _tracing = bool(on)


def _push(rec: SpanRecord, events, anchor) -> None:
    with _lock:
        if len(_records) >= SPAN_BUFFER:
            _records.popleft()  # its events may be pending: they are not pooled again
            count("spans.dropped")
        _records.append((rec, events, anchor))


class _Span:
    """An open span while tracing is on; `device` None records host times only."""

    __slots__ = ("name", "device", "rec", "events", "anchor", "prof")

    def __init__(self, name: str, device: int | None):
        self.name, self.device = name, device
        self.events = self.anchor = self.prof = None

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        rec = self.rec = SpanRecord(self.name, next(_ids), parent.id if parent else None,
                                    parent.request if parent else next(_requests), self.device)
        if rec.device is not None:
            with _lock:
                pool = _pool[rec.device]
                self.events = (pool.pop(), pool.pop()) if len(pool) >= 2 else None
                self.anchor = _anchors.get(rec.device)
            if self.events is None:
                self.events = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            self.events[0].record(torch.cuda.current_stream(rec.device))
        if torch.autograd._profiler_enabled():
            self.prof = torch.profiler.record_function(rec.name)
            self.prof.__enter__()
        stack.append(rec)
        rec.host_start_ns = time.perf_counter_ns()
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.host_end_ns = time.perf_counter_ns()
        _local.stack.pop()
        if self.prof is not None:
            self.prof.__exit__(*exc)
        if self.events is not None:
            self.events[1].record(torch.cuda.current_stream(rec.device))
        _push(rec, self.events, self.anchor)
        return False


def _device_index(device) -> int | None:
    if device is None:
        return torch.cuda.current_device() if torch.cuda.is_initialized() else None
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.current_device() if device.index is None else device.index


def device_span(name: str, device=None):
    """A span of the block on `device`'s current stream (None: the current CUDA device
    once CUDA is initialised; a CPU device records host times only). Off: the shared
    no-op."""
    if not _tracing:
        return _NOOP
    return _Span(name, _device_index(device))


def drain_spans() -> list[SpanRecord]:
    """The closed spans recorded since the last drain, by host start, with device
    times on the host clock; waits for their events. Clears the buffer."""
    with _lock:
        items = list(_records)
        _records.clear()
    out = []
    for rec, events, anchor in items:
        if events is not None:
            start, end = events
            end.synchronize()
            a_ev, a_ns = anchor
            rec.device_start_ns = a_ns + round(a_ev.elapsed_time(start) * 1e6)
            rec.device_end_ns = a_ns + round(a_ev.elapsed_time(end) * 1e6)
            with _lock:
                _pool[rec.device].extend(events)
        out.append(rec)
    out.sort(key=lambda r: r.host_start_ns)
    return out


@contextlib.contextmanager
def span(name: str):
    """Wall-clock span recorded into process-wide stats (and, while tracing is on, as
    a host-only record in the span buffer)."""
    traced = _Span(name, None) if _tracing else _NOOP
    t0 = time.perf_counter()
    try:
        with traced:
            yield
    finally:
        dt = time.perf_counter() - t0
        with _spans_lock:
            s = _spans[name]
            s.count += 1
            s.total += dt
            s.recent.append(dt)


def span_stats() -> dict[str, dict]:
    """Per name: the exact count and total, and p50/p95 over the latest `SAMPLES`."""
    out = {}
    with _spans_lock:
        snapshot = {name: (s.count, s.total, list(s.recent)) for name, s in _spans.items()}
    for name, (n, total, recent) in snapshot.items():
        s = sorted(recent)
        m = len(s)
        out[name] = {
            "count": n,
            "total_ms": round(total * 1e3, 3),
            "p50_ms": round(s[m // 2] * 1e3, 3),
            "p95_ms": round(s[min(m - 1, int(m * 0.95))] * 1e3, 3),
        }
    return out


def reset_spans() -> None:
    with _spans_lock:
        _spans.clear()
