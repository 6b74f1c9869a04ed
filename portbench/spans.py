"""The span window: the program's own device spans, read in a window of the measured
loop's shape, and the numbers the span metrics take from them.

In a `--trace 1` run, after the profiler's traced window, the window runs the cell's
closed loop (`core.Loop.run`, the cell's `in_flight`, on batch indices after the
traced window's) for a quarter of the measured window's seconds with the program's
tracing switched on (`wax_tpu_torch.utils.profiling.set_tracing`) and no profiler,
then drains the spans. The records, the window's seconds and its batch count go onto
the reader's `tracing.Context` as `spans`, `span_window_s` and `span_batches`; the
lead card's longest gaps, the host batch time beside the measured window's, and each
span's median device ms go to the run's log.

The first reader that needs the spans runs the window (`window(ctx)`); the others
find it on the Context. The loop, the entry and the log are `core.run_cell`'s, taken
from its frame: the Context does not carry them. Against a program that has no
tracing switch the window does not run and every reader finds nothing.
"""
from __future__ import annotations

import statistics
import sys

from portbench import core
from portbench.tracing import _union
from wax_tpu_torch.utils import profiling

CALLS = ("flat_scan.call", "sharded_scan.call")  # the program's top-level span, one a batch
GAPS = 10


def _run_cell_frame():
    """`core.run_cell`'s locals while it reads the metrics, else None."""
    f = sys._getframe(1)
    while f is not None and f.f_code is not core.run_cell.__code__:
        f = f.f_back
    return f.f_locals if f is not None else None


def window(ctx):
    """Run the span window once for `ctx`; its records (None where it could not run)."""
    if hasattr(ctx, "spans"):
        return ctx.spans
    ctx.spans = None
    cell = _run_cell_frame()
    if not hasattr(profiling, "set_tracing") or cell is None:
        return None
    loop, log = cell["loop"], cell["log"]
    first = ctx.window["next"] + ctx.traced["batches"]
    seconds = ctx.seconds / 4
    profiling.set_tracing(True)
    try:
        syncs = core.sync_calls(lambda: loop.entry.call(loop.make(-2)), loop.cuda)
        profiling.drain_spans()
        dropped = profiling.counters().get("spans.dropped", 0)
        run = loop.run(first, seconds=seconds)
        records = profiling.drain_spans()
        dropped = profiling.counters().get("spans.dropped", 0) - dropped
    finally:
        profiling.set_tracing(False)
    ctx.spans, ctx.span_window_s, ctx.span_batches = records, seconds, run["dispatched"]
    for line in report(ctx, run, syncs, dropped):
        log(line)
    return records


def report(ctx, run: dict, syncs, dropped: int) -> list:
    """The window's log lines."""
    measured = ctx.seconds / ctx.window["done"] * 1e3 if ctx.window["done"] else float("nan")
    spanned = ctx.span_window_s / run["done"] * 1e3 if run["done"] else float("nan")
    lines = [f"span window: {run['dispatched']} batches, {len(ctx.spans)} spans ({dropped} dropped); host batch "
             f"time {spanned:.4f} ms with tracing on, {measured:.4f} ms in the measured window; synchronising calls "
             f"in one warm call with tracing on: {syncs}"]
    by_name: dict = {}
    for r in on_device(ctx) or []:
        by_name.setdefault(r.name, []).append(r.device_ms)
    lines += [f"span {name}: median {statistics.median(ms):.4f} device ms a call over {len(ms)}"
              for name, ms in sorted(by_name.items())]
    for card in cards(ctx):
        local = device_ms(ctx, "sharded_scan.local", card)
        lines.append(f"span card {card}: {100 * idle_share(ctx, card):.4f}% of its span window idle"
                     + (f", sharded_scan.local median {statistics.median(local):.4f} ms" if local else ""))
    lead = lead_card(ctx)
    if lead is not None:
        for a, b in sorted(_union(intervals(ctx, lead))[1], key=lambda g: g[0] - g[1])[:GAPS]:
            mid = (a + b) / 2
            open_at = [(r.host_end_ns - r.host_start_ns, r.name) for r in ctx.spans
                       if r.host_start_ns <= mid <= r.host_end_ns]
            lines.append(f"span gap on card {lead}: {(b - a) / 1e6:.4f} ms, "
                         f"{min(open_at)[1] if open_at else 'outside the program'}")
    return lines


def on_device(ctx):
    """The window's records that carry device times (None off the card or without a
    window)."""
    recs = window(ctx)
    recs = [r for r in recs or [] if r.device_start_ns is not None]
    return recs or None


def lead_card(ctx):
    """The card of the program's top-level spans."""
    calls = [r for r in on_device(ctx) or [] if r.name in CALLS]
    return calls[0].device if calls else None


def device_ms(ctx, name: str, card=None) -> list:
    """Device ms of each span `name` (on `card`, if given)."""
    return [r.device_ms for r in on_device(ctx) or [] if r.name == name and (card is None or r.device == card)]


def cards(ctx) -> list:
    return sorted({r.device for r in on_device(ctx) or []})


def intervals(ctx, card) -> list:
    """Sorted (start, end) device intervals, host-clock ns, of every span on `card`."""
    return sorted((r.device_start_ns, r.device_end_ns) for r in on_device(ctx) or [] if r.device == card)


def idle_share(ctx, card) -> float:
    """The share of `card`'s span window, its first span's start to its last span's
    end, that none of its spans covers."""
    iv = intervals(ctx, card)
    extent = max(e for _, e in iv) - iv[0][0]
    return 1.0 - _union(iv)[0] / extent if extent > 0 else 0.0
