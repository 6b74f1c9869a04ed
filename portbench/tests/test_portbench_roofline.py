"""The yardstick's arithmetic on hand-counted shapes."""
from __future__ import annotations

import math

from portbench.metrics import batch_mfu, idle_share, k6_roofline, launches_per_batch, shard_scan_roofline
from portbench.roofline import HBM_BYTES_PER_S, Work, bound, k6_work, k7_work, short_kernel_name
from portbench.tracing import Context, _union


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert bound(3.35e9, 1.0, "bf16") == (1.0, "bytes")  # 3.35 GB at 3.35 TB/s: 1 ms
    ms, by = bound(1.0, 989e9, "bf16")
    assert by == "operations" and math.isclose(ms, 1.0)
    assert math.isclose(bound(0.0, 67e9, "fp32")[0], 1.0)


def test_work_sums_operations_each_at_its_peak():
    w = Work(0, {"bf16": 989e9}) + Work(0, {"fp32": 67e9})
    assert math.isclose(w.least_ms(), 2.0)
    assert math.isclose(Work(6.7e9).least_ms(chips=2), 1.0)
    assert math.isclose(Work(3.35e9, {"bf16": 1.0}).least_ms(), 1.0)


def test_k6_work_flat_msmarco1_shape():
    # 256 queries over the index's 8,843,264 x 768 bf16: rows, queries, bias, chunk maxima
    w = k6_work(256, 8_843_264, 768, 2)
    assert w.nbytes == 8_843_264 * 768 * 2 + 256 * 768 * 2 + 8_843_264 * 4 + 256 * 69_088 * 4
    assert w.ops == {"bf16": 2 * 256 * 8_843_264 * 768}
    assert math.isclose(w.least_ms(), w.nbytes / HBM_BYTES_PER_S * 1e3)  # bytes-bound: 4.08 ms
    assert 4.07 < w.least_ms() < 4.09


def test_k7_work_by_hand():
    w7 = k7_work(b=2, nprobe=3, n_buckets=10, d=4, el=2, k=3, live_distinct=5 * 128, probed_live=6 * 128)
    assert w7.nbytes == 640 * 4 * 2 + 2 * 4 * 4 + 2 * 3 * 4 + 10 * 4 + 2 * 3 * 8
    assert w7.ops == {"fp32": 2 * 768 * 4}


def test_short_kernel_names():
    assert short_kernel_name("void wax::k6_chunk_maxima_mma<...>") == "K6"
    assert short_kernel_name("k7_bucket_rescore") == "K7"
    assert short_kernel_name("x" * 80) == "x" * 60


def _ctx(ops, busy, window_s=0.1, batches=10, chips=1, work=None, done=100, seconds=1.0):
    traced = {"ops": ops, "busy_by_card": busy, "window_s": window_s, "batches": batches}
    win = {"done": done, "call_s": [0.001]}
    return Context(traced=traced, work=work or {}, window=win, seconds=seconds, syncs=0, chips=chips)


def test_readers_on_a_hand_made_trace():
    ops = {0: [("k6_chunk_maxima", 0.0, 1000.0), ("Memcpy DtoH", 1000.0, 10.0), ("k6_chunk_maxima", 2000.0, 3000.0)]}
    ctx = _ctx(ops, {0: 0.004}, work={"K6": Work(3.35e9), "batch_ms": 5.0})  # a 1 ms bound
    assert math.isclose(k6_roofline.read(ctx), 50.0)  # 2 launches, 2 ms a launch
    assert math.isclose(idle_share.read(ctx), 96.0)
    assert math.isclose(launches_per_batch.read(ctx), 0.2)
    assert math.isclose(batch_mfu.read(ctx), 50.0)  # 5 ms least over 10 ms a batch
    shard = _ctx({0: [], 1: []}, {0: 0.02, 1: 0.05}, batches=10, chips=2, work={"card_bytes_ms": 1.0})
    assert math.isclose(shard_scan_roofline.read(shard), 20.0)  # the busiest card: 5 ms a batch
    assert k6_roofline.read(_ctx({}, {})) is None


def test_union_of_intervals():
    busy, gaps = _union([(0, 2), (1, 3), (5, 6), (6, 7)])
    assert busy == 5 and gaps == [(3, 5)]
