"""The port's tracing (`wax_tpu_torch.utils.profiling`): the switch, device spans and
their buffer, bounded span stats, and the benchmark's span window over the two
cells' paths. The CPU tests run everywhere; the `cuda` tests hold the spans' event
times and ranges against `torch.profiler` at the flat cell's shapes and need a card:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_tracing.py

This file imports no JAX.
"""
import warnings

import pytest
import torch

from portbench import spans, tracing
from portbench.tests.portbench_tiny import run
from wax_tpu_torch.utils import profiling

SPAN_METRICS = ("call_device_ms", "select_ms", "card_scan_ms", "merge_ms", "span_idle_share")


@pytest.fixture
def clean():
    profiling.set_tracing(False)
    profiling.drain_spans()
    yield
    profiling.set_tracing(False)
    profiling.drain_spans()


def test_off_device_span_is_the_shared_noop(clean, monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("tracing off created an event")

    monkeypatch.setattr(torch.cuda, "Event", no_event)
    a, b = profiling.device_span("a", "cuda:0"), profiling.device_span("b")
    assert a is b and not profiling.tracing_enabled()
    with a, b:
        with profiling.span("host"):
            pass
    assert profiling.drain_spans() == []


def test_on_spans_nest_and_share_the_buffer(clean):
    profiling.set_tracing(True)
    with profiling.device_span("outer", torch.device("cpu")) as outer:
        with profiling.span("host.inner"):
            with profiling.device_span("leaf", "cpu"):
                pass
    with profiling.device_span("second", "cpu"):
        pass
    recs = {r.name: r for r in profiling.drain_spans()}
    assert list(recs) == ["outer", "host.inner", "leaf", "second"]  # by host start
    assert outer is recs["outer"] and recs["outer"].parent is None
    assert recs["host.inner"].parent == recs["outer"].id and recs["leaf"].parent == recs["host.inner"].id
    assert recs["outer"].request == recs["host.inner"].request == recs["leaf"].request != recs["second"].request
    for r in recs.values():
        assert r.device is None and r.device_ms is None and 0 < r.host_start_ns <= r.host_end_ns
    assert recs["outer"].host_start_ns <= recs["leaf"].host_start_ns <= recs["leaf"].host_end_ns \
        <= recs["outer"].host_end_ns
    assert profiling.drain_spans() == []  # drained


def test_full_buffer_drops_the_oldest_and_counts_them(clean, monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_BUFFER", 4)
    dropped = profiling.counters().get("spans.dropped", 0)
    profiling.set_tracing(True)
    for i in range(7):
        with profiling.device_span(f"s{i}", "cpu"):
            pass
    assert [r.name for r in profiling.drain_spans()] == ["s3", "s4", "s5", "s6"]
    assert profiling.counters()["spans.dropped"] - dropped == 3


def test_span_stats_stay_bounded_and_count_exactly(clean):
    name = "test.bounded"
    profiling.reset_spans()
    for _ in range(10_000):
        with profiling.span(name):
            pass
    stats = profiling.span_stats()[name]
    assert stats["count"] == 10_000 and set(stats) == {"count", "total_ms", "p50_ms", "p95_ms"}
    assert len(profiling._spans[name].recent) == profiling.SAMPLES == 4096
    assert 0 <= stats["p50_ms"] <= stats["p95_ms"] and stats["total_ms"] >= 0
    profiling.reset_spans()
    assert name not in profiling.span_stats()


def test_counters_add_and_reset():
    before = profiling.counters().get("test.count", 0)
    profiling.count("test.count")
    profiling.count("test.count", 2)
    assert profiling.counters()["test.count"] == before + 3


@pytest.mark.parametrize("cell,call,children", [
    ("flat_msmarco1.b256", "flat_scan.call", ["chunkmax.k6", "chunkmax.select", "chunkmax.rescore"]),
    ("shard_msmarco2.b64", "sharded_scan.call", ["sharded_scan.local"] * 4 + ["merge.across_mesh"]),
])
def test_span_window_records_each_batch(cell, call, children, monkeypatch):
    """A small traced run: one top-level span a span-window batch, each with the path's
    children under it in one request; off the card the span metrics are left out."""
    seen = []
    read = tracing.read_metrics

    def keep(ctx, per_layer, name):
        seen.append(ctx)
        return read(ctx, per_layer, name)

    monkeypatch.setattr(tracing, "read_metrics", keep)
    r = run(cell, trace=True)
    assert r["correct"] is True and not set(SPAN_METRICS) & set(r["metrics"])
    ctx = seen[0]
    assert ctx.span_window_s == 0.25 and ctx.span_batches > 0 and not profiling.tracing_enabled()
    tops = [s for s in ctx.spans if s.parent is None]
    assert [s.name for s in tops] == [call] * ctx.span_batches
    for top in tops:
        kids = [s for s in ctx.spans if s.parent == top.id]
        assert [s.name for s in kids] == children and {s.request for s in kids} == {top.request}
    assert len(ctx.spans) == ctx.span_batches * (1 + len(children))
    assert spans.on_device(ctx) is None and spans.lead_card(ctx) is None


def test_span_metrics_read_device_records():
    """The readers' arithmetic on two batches over two cards (times in ms on one clock):
    card 0 runs the call, its local scan and the merge; card 1 its local scan."""
    import importlib
    import types

    ms = 1_000_000

    def rec(name, i, parent, card, a, b, host=None):
        h = host or (a, b)
        return profiling.SpanRecord(name, i, parent, 1, card, h[0] * ms, h[1] * ms, a * ms, b * ms)

    recs = [rec("sharded_scan.call", 1, None, 0, 0, 10), rec("sharded_scan.local", 2, 1, 0, 0, 6),
            rec("sharded_scan.local", 3, 1, 1, 1, 7), rec("merge.across_mesh", 4, 1, 0, 6, 10),
            rec("sharded_scan.call", 5, None, 0, 11, 21, host=(10, 12)), rec("sharded_scan.local", 6, 5, 0, 11, 17),
            rec("sharded_scan.local", 7, 5, 1, 12, 19), rec("merge.across_mesh", 8, 5, 0, 17, 21)]
    ctx = types.SimpleNamespace(spans=recs, span_window_s=0.022, seconds=1.0, window={"done": 50})
    read = {m: importlib.import_module(f"portbench.metrics.{m}").read(ctx) for m in SPAN_METRICS}
    assert read["call_device_ms"] == 10 and read["merge_ms"] == 4 and read["select_ms"] is None
    assert read["card_scan_ms"] == 6.5  # card 1's median (6 and 7 ms) over card 0's 6
    assert read["span_idle_share"] == pytest.approx(100 * 5 / 18)  # card 1: 13 ms of spans in 18
    lines = spans.report(ctx, {"dispatched": 2, "done": 2}, 0, 0)
    assert "host batch time 11.0000 ms with tracing on, 20.0000 ms in the measured window" in lines[0]
    assert "span merge.across_mesh: median 4.0000 device ms a call over 2" in lines
    assert any(line.startswith("span card 1: 27.7778% of its span window idle") for line in lines)
    assert lines[-1] == "span gap on card 0: 1.0000 ms, sharded_scan.call"  # 10-11 ms, the second call open


# --- on the card ------------------------------------------------------------------

N_FLAT, D_FLAT, B_FLAT, K = 8_843_264, 768, 256, 10  # flat_msmarco1.b256's index and batch
CALLS = 20


@pytest.fixture(scope="module")
def flat_profile():
    """20 chunkmax calls at the flat cell's shapes under torch.profiler with tracing on:
    (span records, profiler events, the measured range's host start in ns)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from torch.profiler import ProfilerActivity, profile, record_function

    from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk

    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(0)
    emb = torch.randn(N_FLAT, D_FLAT, generator=g, device=dev, dtype=torch.bfloat16)
    q = torch.randn(B_FLAT, D_FLAT, generator=g, device=dev, dtype=torch.bfloat16)
    bias = torch.zeros(N_FLAT, device=dev)
    chunkmax_scan_topk(q, emb, bias, K)
    torch.cuda.synchronize()
    profiling.set_tracing(True)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):  # the profiler records no device event in its first ms
                chunkmax_scan_topk(q, emb, bias, K)
            torch.cuda.synchronize()
            profiling.drain_spans()
            with record_function("measured"):
                for _ in range(CALLS):
                    chunkmax_scan_topk(q, emb, bias, K)
                torch.cuda.synchronize()
        recs = profiling.drain_spans()
    finally:
        profiling.set_tracing(False)
    events = list(prof.profiler.kineto_results.events())
    start = min(e.start_ns() for e in events if e.name() == "measured")
    del emb
    torch.cuda.empty_cache()
    return recs, events, start


def _kernels(events, start):
    from torch.autograd import DeviceType

    return [e for e in events if e.device_type() == DeviceType.CUDA and e.start_ns() >= start
            and not e.name().startswith(("Memcpy", "Memset"))]


def _ranges(events, name, start):
    """The host ranges of `record_function(name)` (the profiler also draws each on the
    device's timeline, on the device's clock: those are left out)."""
    from torch.autograd import DeviceType

    return [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in events
            if e.name() == name and e.device_type() == DeviceType.CPU and e.start_ns() >= start]


def _launched_in(events, ranges, kernels):
    """The kernels whose launch (the host event of the same correlation id) lies in one
    of the host ranges."""
    from torch.autograd import DeviceType

    host = {}
    for e in events:
        if e.device_type() == DeviceType.CPU and e.correlation_id() and "aunch" in e.name():
            host[e.correlation_id()] = e.start_ns()
    return [k for k in kernels if any(a <= host.get(k.correlation_id(), -1) <= b for a, b in ranges)]


@pytest.mark.cuda
def test_span_event_times_agree_with_the_profiler(flat_profile):
    recs, events, start = flat_profile
    kernels = _kernels(events, start)
    k6_spans = sum(r.device_ms for r in recs if r.name == "chunkmax.k6")
    k6_prof = sum(e.duration_ns() for e in kernels if "k6_chunk_maxima" in e.name()) / 1e6
    sel_spans = sum(r.device_ms for r in recs if r.name == "chunkmax.select")
    sel_kernels = _launched_in(events, _ranges(events, "chunkmax.select", start), kernels)
    sel_prof = sum(e.duration_ns() for e in sel_kernels) / 1e6
    print(f"chunkmax.k6: spans {k6_spans:.4f} ms, profiler {k6_prof:.4f} ms; chunkmax.select: spans "
          f"{sel_spans:.4f} ms, profiler {sel_prof:.4f} ms over {len(sel_kernels)} kernels "
          f"({sorted({e.name()[:50] for e in sel_kernels})})")
    assert sum(r.name == "chunkmax.k6" for r in recs) == sum(r.name == "chunkmax.select" for r in recs) == CALLS
    assert k6_prof > 0 and abs(k6_spans - k6_prof) <= 0.05 * k6_prof
    assert sel_prof > 0 and abs(sel_spans - sel_prof) <= 0.05 * sel_prof


@pytest.mark.cuda
def test_k6_range_holds_the_k6_launch(flat_profile):
    _, events, start = flat_profile
    k6 = [e for e in _kernels(events, start) if "k6_chunk_maxima" in e.name()]
    inside = _launched_in(events, _ranges(events, "chunkmax.k6", start), k6)
    assert len(k6) == CALLS and len(inside) == CALLS


@pytest.mark.cuda
def test_traced_call_does_not_synchronise():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from wax_tpu_torch.index.dense import DenseIndex
    from wax_tpu_torch.ops.flat_scan import flat_scan_topk

    dev = torch.device("cuda", 0)
    n = 1 << 20
    emb = torch.randn(n, 64, device=dev, dtype=torch.bfloat16)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    index = DenseIndex(emb=emb, frame_ids=ids, active=ids >= 0, count=torch.tensor(n, dtype=torch.int32, device=dev),
                       contiguous=True)
    q = torch.randn(64, 64, device=dev)
    profiling.set_tracing(True)
    try:
        flat_scan_topk(q, index, K)
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                flat_scan_topk(q, index, K)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        recs = profiling.drain_spans()
    finally:
        profiling.set_tracing(False)
    assert not [w for w in seen if "called a synchronizing" in str(w.message)]
    assert {r.name for r in recs} == {"flat_scan.call", "chunkmax.k6", "chunkmax.select", "chunkmax.rescore"}
    assert all(r.device == 0 and r.device_ms > 0 for r in recs)
