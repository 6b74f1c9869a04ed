"""Spans and the route counter of the fused hybrid program (`sharded_hybrid_topk`).

With tracing on, one call over two corpus shards records `sharded_hybrid.call` once,
each shard's `sharded_hybrid.dense` and `sharded_hybrid.bm25` (the latter holding
`bm25.candidates` and `bm25.rescore`) once, the two merges and `sharded_hybrid.rrf`,
all in the call's request; the counter `sharded_hybrid.lex_route.<backend>` adds one
a call. With tracing off the call records nothing. The `cuda` tests hold the off
switch to no synchronising CUDA call on the card (`syncs_per_batch`'s method), and a
budgeted snapshot without impact chunks (as 2^23 rows a shard and more are built) to
K8's postings walk, counted `k8.walk.postings` once a call:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_hybrid_tracing.py

This file imports no JAX.
"""
import dataclasses
import warnings

import numpy as np
import pytest
import torch

from wax_tpu_torch.parallel import sharded_hybrid as tsh
from wax_tpu_torch.parallel.mesh import data_mesh
from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex
from wax_tpu_torch.utils import profiling

N, D, T = 4096, 16, 300


def _program(device, shards, budget=64):
    """(queries, term ids, dense index, lexical index, mesh) of a small seeded corpus
    on `device`, the lexical index built there."""
    rng = np.random.default_rng(3)
    lens = rng.integers(3, 30, N)
    row = np.repeat(np.arange(N), lens)
    p = 1.0 / np.arange(1, T + 1)
    key, tf = np.unique(row * T + rng.choice(T, size=row.shape[0], p=p / p.sum()), return_counts=True)
    r, t = key // T, key % T
    order = np.argsort(t, kind="stable")
    offsets = np.zeros(T + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(t, minlength=T))
    mesh = data_mesh([device] * shards)
    ids = torch.arange(N, dtype=torch.int32, device=device)
    lex = tsh.shard_lex_postings(
        mesh, N, torch.from_numpy(offsets).to(device), torch.from_numpy(r[order].astype(np.int32)).to(device),
        torch.from_numpy(tf[order].astype(np.int32)).to(device), torch.from_numpy(lens.astype(np.float32)).to(device),
        ids, torch.ones(N, dtype=torch.bool, device=device), postings_budget=budget)
    per = N // shards
    emb = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32)).to(device)
    dense = ShardedDenseIndex(emb=tuple(emb[s * per:(s + 1) * per] for s in range(shards)),
                              frame_ids=tuple(ids[s * per:(s + 1) * per] for s in range(shards)),
                              bias=tuple(torch.zeros(per, device=device) for _ in range(shards)), contiguous=False)
    q = torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32)).to(device)
    tids = torch.full((8, 16), -1, dtype=torch.int32)
    tids[:, :4] = torch.from_numpy(rng.choice(T, size=(8, 4)).astype(np.int32))
    return q, tids.to(device), dense, lex, mesh


@pytest.fixture
def clean():
    profiling.set_tracing(False)
    profiling.drain_spans()
    yield
    profiling.set_tracing(False)
    profiling.drain_spans()


@pytest.mark.parametrize("backend", ["candidates", "candidates_pallas"])
def test_one_call_records_each_span_once_a_shard(clean, backend):
    q, tids, dense, lex, mesh = _program("cpu", 2)
    name = f"sharded_hybrid.lex_route.{backend}"
    before = profiling.counters().get(name, 0)
    profiling.set_tracing(True)
    tsh.sharded_hybrid_topk(q, tids, dense, lex, 5, mesh, lex_backend=backend)
    profiling.set_tracing(False)
    recs = profiling.drain_spans()
    assert profiling.counters().get(name, 0) == before + 1
    tops = [r for r in recs if r.parent is None]
    assert [r.name for r in tops] == ["sharded_hybrid.call"]
    assert {r.request for r in recs} == {tops[0].request}
    kids = [r.name for r in recs if r.parent == tops[0].id]
    assert kids == ["sharded_hybrid.dense"] * 2 + ["sharded_hybrid.bm25"] * 2 + ["merge.across_mesh"] * 2 + \
        ["sharded_hybrid.rrf"]
    for lane in (r for r in recs if r.name == "sharded_hybrid.bm25"):
        assert [r.name for r in recs if r.parent == lane.id] == ["bm25.candidates", "bm25.rescore"]
    assert len(recs) == 1 + len(kids) + 2 * 2


def test_off_records_nothing_and_counts_the_route(clean):
    q, tids, dense, lex, mesh = _program("cpu", 1)
    before = profiling.counters().get("sharded_hybrid.lex_route.candidates", 0)
    tsh.sharded_hybrid_topk(q, tids, dense, lex, 5, mesh)
    assert profiling.drain_spans() == []
    assert profiling.counters()["sharded_hybrid.lex_route.candidates"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("on", [False, True])
def test_call_on_the_card_does_not_synchronise(clean, on):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, tids, dense, lex, mesh = _program(torch.device("cuda", 0), 1)
    assert tsh._resolve_lex_backend(lex, "auto") == "candidates_pallas"
    profiling.set_tracing(on)
    tsh.sharded_hybrid_topk(q, tids, dense, lex, 5, mesh)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            tsh.sharded_hybrid_topk(q, tids, dense, lex, 5, mesh)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    profiling.set_tracing(False)
    recs = profiling.drain_spans()
    assert not [w for w in seen if "called a synchronizing" in str(w.message)]
    assert bool(recs) == on and all(r.device == 0 and r.device_ms >= 0 for r in recs)


@pytest.mark.cuda
def test_card_path_walks_postings_once_a_call(clean):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    q, tids, dense, lex, mesh = _program(torch.device("cuda", 0), 1)
    lex = dataclasses.replace(lex, pk_chunks=None, chunk_base=None, chunk_counts=None)
    assert tsh._resolve_lex_backend(lex, "auto") == "candidates_pallas"
    before = profiling.counters()
    tsh.sharded_hybrid_topk(q, tids, dense, lex, 5, mesh)
    after = profiling.counters()
    assert after.get("k8.walk.postings", 0) == before.get("k8.walk.postings", 0) + 1
    assert after.get("k8.walk.rows", 0) == before.get("k8.walk.rows", 0)
    assert after.get("wax_k8_candidates", 0) == before.get("wax_k8_candidates", 0) + 1
