"""The port's maintenance (orchestrator/maintenance.py) against wax_tpu's on the CPU.

Mirrors tests/test_maintenance.py: surrogates created, then current, then updated on
superseded content; compaction drops tombstones; the live-set rewrite drops dead
frames, remaps ids and keeps chunk links; the scheduled gates; `dead_bytes`. Then
both orchestrators (the port's on `device="cpu"`) go through the same steps with
fixed timestamps, for the flat, auto, IVF and HNSW engines and with structured facts
whose evidence rows remap: their reports (all but `elapsed_ms`), frame counts, index
builders and search responses must be equal. A store rewritten by one package opens
in the other and answers alike.
"""
import dataclasses

import numpy as np
import pytest

import wax_tpu.orchestrator.maintenance as jax_maint
import wax_tpu.storage.store as jax_store
import wax_tpu_torch.orchestrator.maintenance as port_maint
import wax_tpu_torch.storage.store as port_store
from tests.test_torch_orchestrator import (PKGS, REQUESTS, T0, _assert_same_response, _call, _config,
                                           _ingest, _open, _request)
from wax_tpu.search import engine_cache as jax_cache
from wax_tpu_torch.search import engine_cache as port_cache
from wax_tpu_torch.types import FrameKind

ENGINES = ["flat", "auto", "ivf", "hnsw"]
FORGET = (0, 7, 40, 41, 42, 250, 251)  # more documents, one with chunks, after the ingest's
# rendered recalls compared. recall("project alpha milestones") is left out: once
# FORGET's frames are gone (maintenance or not) two of its snippets tie in the BM25
# lane, whose f32 sums differ from the JAX lane's in the last bit, and swap places.
RECALLS = ("Maria Barcelona architect", "cabin password", "project alpha", "travel notes this week")


@pytest.fixture(autouse=True)
def fixed_store_clock(monkeypatch):
    """Frames the maintainer writes (surrogates) take the store's clock: fix it."""
    for mod in (jax_store, port_store):
        monkeypatch.setattr(mod, "now_ms", lambda: T0 + 5 * 10**8)
    yield
    jax_cache.clear()
    port_cache.clear()


def _both(tmp_path, engine="flat", **kw):
    return [_open(pkg, tmp_path / f"{pkg}.mv2s", _config(pkg, vector_engine=engine, **kw))
            for pkg in ("jax", "port")]


def _fields(report) -> dict:
    d = dataclasses.asdict(report)
    d.pop("elapsed_ms", None)
    return d


def _responses(o, text_only: bool = False):
    pkg = "port" if type(o).__module__.startswith("wax_tpu_torch") else "jax"
    out = []
    for spec in REQUESTS.values():
        spec = dict(spec, mode="TEXT_ONLY") if text_only else spec
        out.append(_call(lambda: o.search(_request(pkg, spec))))
    for q in () if text_only else RECALLS:
        out.append(_call(lambda: o.recall(q).render()))
    return out


def _assert_same_answers(jo, po, engine) -> None:
    """Every request answers alike. The IVF buckets differ by design (the port's
    k-means draws), so an IVF store is held on its text lanes (recalls, which fuse
    the vector lane, left out) and builder arrays."""
    assert po.store.frame_count() == jo.store.frame_count()
    for a, b in zip(_responses(jo, engine == "ivf"), _responses(po, engine == "ivf")):
        if isinstance(a, str):
            assert a == b
        else:
            _assert_same_response(a, b)


def _assert_same_builders(jo, po) -> None:
    vj, aj = jo.engine.lex.frozen_or_built_arrays()
    vt, at = po.engine.lex.frozen_or_built_arrays()
    assert vj == vt and all(np.array_equal(aj[k], at[k]) for k in aj)
    sj, st = jo.engine.vector.builder.state_arrays(), po.engine.vector.builder.state_arrays()
    assert set(sj) == set(st)
    for k in sj:
        assert np.array_equal(np.asarray(sj[k]), np.asarray(st[k])), k
    assert type(po.engine.vector.builder).__name__ == type(jo.engine.vector.builder).__name__


def _evidence(o):
    return o.structured.conn.execute("SELECT fact_id, frame_id FROM sm_evidence ORDER BY 1, 2").fetchall()


@pytest.mark.parametrize("engine", ENGINES)
def test_maintenance_equals_jax(tmp_path, engine):
    jo, po = _both(tmp_path, engine)
    remaps = {"jax": [], "port": []}
    try:
        for pkg, o in (("jax", jo), ("port", po)):
            _ingest(o)
            o.flush()
            o.maintainer.remap_listeners.append(remaps[pkg].append)
        # surrogates: created, then all current
        first = [o.maintainer.optimize_surrogates() for o in (jo, po)]
        assert _fields(first[0]) == _fields(first[1]) and first[1].surrogates_created > 0
        again = [o.maintainer.optimize_surrogates() for o in (jo, po)]
        assert _fields(again[0]) == _fields(again[1])
        assert again[1].surrogates_created == 0 and again[1].surrogates_current == first[1].surrogates_created
        _assert_same_answers(jo, po, engine)

        # forget, then compaction drops the tombstones from both indexes
        for o in (jo, po):
            for fid in FORGET:
                o.forget(fid)
        assert po.maintainer.dead_bytes() == jo.maintainer.dead_bytes() > 0
        gens = [o.maintainer.compact_indexes() for o in (jo, po)]
        assert gens[0] == gens[1]
        assert len(po.engine.lex) == len(jo.engine.lex) == len(po.engine.lex._doc_len)
        assert len(po.engine.vector) == len(jo.engine.vector)
        _assert_same_builders(jo, po)
        _assert_same_answers(jo, po, engine)
        assert po.maintainer.dead_bytes() == jo.maintainer.dead_bytes()

        # the live-set rewrite drops dead frames and remaps ids
        reports = [o.maintainer.rewrite_live_set() for o in (jo, po)]
        assert _fields(reports[0]) == _fields(reports[1])
        r = reports[1]
        assert r.executed and r.frames_after < r.frames_before and r.bytes_after < r.bytes_before
        assert remaps["port"] == remaps["jax"] and len(remaps["port"]) == 1
        _assert_same_builders(jo, po)
        _assert_same_answers(jo, po, engine)
        assert _evidence(po) == _evidence(jo) and _evidence(po)
        assert po.access_stats._counts == jo.access_stats._counts
        assert po.store.verify(deep=True)["ok"]
        if engine == "ivf":
            assert po.engine.vector.snapshot().n_clusters > 0
        if engine == "hnsw":
            assert type(po.engine.vector.builder).__name__ == "CppHNSWBuilder"
    finally:
        jo.close()
        po.close()
    # a cold reopen of each rewritten store answers alike
    jax_cache.clear()
    port_cache.clear()
    jo, po = _both(tmp_path, engine)
    try:
        _assert_same_answers(jo, po, engine)
    finally:
        jo.close()
        po.close()


def test_surrogate_updated_on_superseded_content(tmp_path):
    jo, po = _both(tmp_path)
    try:
        out = []
        for o in (jo, po):
            res = o.remember("Original content about topic A. It has a second sentence.")
            o.maintainer.optimize_surrogates()
            o.store.supersede(res.document_id, "Replacement content about topic B.", kind="document")
            out.append(o.maintainer.optimize_surrogates())
        assert _fields(out[0]) == _fields(out[1]) and out[1].surrogates_created >= 1
        _assert_same_answers(jo, po, "flat")
    finally:
        jo.close()
        po.close()


def test_rewrite_keeps_chunk_links_and_answers_match_compaction(tmp_path):
    """After a compaction and a rewrite the answers are the compacted answers under the
    id remap: ids mapped, scores and order unchanged (the remap keeps id order)."""
    po = _open("port", tmp_path / "p.mv2s", _config("port", vector_engine="flat"))
    try:
        dead = po.remember("soon gone").document_id
        po.remember(" ".join(f"Sentence {i} about project delta." for i in range(400)))
        _ingest(po)
        po.flush()
        po.forget(dead)
        po.maintainer.compact_indexes()
        queries = ["project delta sentence", "apple river", "Maria Barcelona", '"project alpha milestones"']
        before = [po.search(q) for q in queries]
        got = []
        po.maintainer.remap_listeners.append(got.append)
        po.maintainer.rewrite_live_set()
        (remap,) = got
        for a, b in zip(before, [po.search(q) for q in queries]):
            assert [remap[h.frame_id] for h in a.hits] == [h.frame_id for h in b.hits]
            assert [h.score for h in a.hits] == [h.score for h in b.hits]
        chunks = [fid for fid in range(po.store.frame_count())
                  if (m := po.store.frame_meta(fid)) and m.kind == FrameKind.CHUNK.value]
        assert chunks
        for fid in chunks:
            assert po.store.frame_meta(po.store.frame_meta(fid).parent_id).kind == FrameKind.DOCUMENT.value
    finally:
        po.close()


def test_scheduled_gates_equal_jax(tmp_path):
    """The gates open in order: disabled, flush count, interval, dead bytes; a flush
    past all of them runs the rewrite, as in the JAX package."""
    jo, po = _both(tmp_path)
    try:
        for o, maint in ((jo, jax_maint), (po, port_maint)):
            assert o.maintainer.maybe_scheduled_rewrite().reason == "disabled"
            assert isinstance(o.maintainer, maint.Maintainer)
    finally:
        jo.close()
        po.close()
    cases = [
        (dict(min_flush_count=5, min_interval_ms=0, min_dead_bytes=0), "flush-count gate"),
        (dict(min_flush_count=0, min_interval_ms=10**15, min_dead_bytes=0), "interval gate"),
        (dict(min_flush_count=0, min_interval_ms=0, min_dead_bytes=10**12), "dead-bytes gate"),
    ]
    for i, (gates, reason) in enumerate(cases):
        pair = []
        for pkg in ("jax", "port"):
            sched = PKGS[pkg][0].RewriteSchedule(enabled=True, **gates)
            pair.append(_open(pkg, tmp_path / f"{pkg}{i}.mv2s", _config(pkg, rewrite_schedule=sched)))
        try:
            for o in pair:
                o.remember("a note")
                o.flush()
            got = [_fields(o.maintainer.maybe_scheduled_rewrite()) for o in pair]
            assert got[0] == got[1] == _fields(port_maint.LiveSetRewriteReport(False, reason))
        finally:
            for o in pair:
                o.close()
    # every gate open: the flush after a forget rewrites the store
    pair = []
    for pkg in ("jax", "port"):
        sched = PKGS[pkg][0].RewriteSchedule(enabled=True, min_flush_count=2, min_interval_ms=0, min_dead_bytes=1)
        pair.append(_open(pkg, tmp_path / f"{pkg}_on.mv2s", _config(pkg, rewrite_schedule=sched)))
    try:
        counts = []
        for o in pair:
            o.remember("alpha memory kept")
            o.forget(o.remember("beta memory doomed " + "word " * 800).document_id)
            o.flush()  # one flush: below the count
            before = o.store.frame_count()
            o.flush()  # the second runs the rewrite
            counts.append((before, o.store.frame_count()))
        assert counts[0] == counts[1] and counts[1][1] < counts[1][0]
        _assert_same_answers(pair[0], pair[1], "flat")
        assert pair[1].maintainer._flushes_since_rewrite == 0
    finally:
        for o in pair:
            o.close()


def test_dead_bytes_counts(tmp_path):
    jo, po = _both(tmp_path)
    try:
        out = []
        for o in (jo, po):
            fid = o.remember("x" * 5000).document_id
            o.flush()
            base = o.maintainer.dead_bytes()
            o.forget(fid)
            out.append((base, o.maintainer.dead_bytes()))
        assert out[0] == out[1] and out[1][1] > out[1][0]
    finally:
        jo.close()
        po.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
@pytest.mark.parametrize("engine", ["flat", "hnsw"])
def test_rewritten_store_crosses_packages(tmp_path, writer, reader, engine):
    w = _open(writer, tmp_path / "m.mv2s", _config(writer, vector_engine=engine))
    _ingest(w)
    for fid in FORGET:
        w.forget(fid)
    w.maintainer.compact_indexes()
    w.maintainer.rewrite_live_set()
    want = _responses(w)
    w.close()
    (jax_cache if writer == "jax" else port_cache).clear()
    r = _open(reader, tmp_path / "m.mv2s", _config(reader, vector_engine=engine))
    try:
        for a, b in zip(want, _responses(r)):
            if isinstance(a, str):
                assert a == b
            else:
                _assert_same_response(a, b)
    finally:
        r.close()


def test_forget_deletes_the_frames_jax_deletes(tmp_path):
    """The port's forget finds children through an index of parents; it must delete
    exactly the frames the JAX module's scan deletes: a document's chunks and
    surrogates, across a live-set rewrite (a new store) and later remembers."""
    jo, po = _both(tmp_path)
    try:
        for step in range(2):
            for o in (jo, po):
                o.remember(" ".join(f"Sentence {i} about lake {step} and boats." for i in range(300)))
                o.remember_batch([f"short note {i} on step {step}" for i in range(20)])
                o.maintainer.optimize_surrogates()
                for fid in (1, 5, o.store.frame_count() - 3):
                    o.forget(fid)
            assert [m.status for m in map(po.store.frame_meta, range(po.store.frame_count()))] == \
                   [m.status for m in map(jo.store.frame_meta, range(jo.store.frame_count()))]
            reports = [o.maintainer.rewrite_live_set() for o in (jo, po)]
            assert _fields(reports[0]) == _fields(reports[1])
        _assert_same_answers(jo, po, "flat")
    finally:
        jo.close()
        po.close()
