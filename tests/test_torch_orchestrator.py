"""The port's MemoryOrchestrator against wax_tpu's on the CPU.

Both orchestrators ingest the same generated documents with the same HashEmbedder and
an injected clock: short and multi-chunk documents, metadata, tags, a session, two
handoffs, a forget, entities and facts (the structured lane), a flush half way. Each
request must give equal `SearchResponse`s (frame ids, scores within rtol 1e-6,
previews, sources, lane counts, warnings) and `recall(...).render()` must be equal as
strings, once with exact postings and once under a manual postings budget (the
candidate lane). Then stores cross between the packages in both directions, a cold
reopen answers as a reclaimed one, a parked engine of another device is not served,
an hnsw config serves and a JAX hnsw store opens, the maintainer serves, files and
PDFs are remembered alike, and the sharded configurations serve over logical CPU
shards (topologies that do not divide the devices raise ValueError).
"""
import itertools
import os
import tempfile

import numpy as np
import pytest
import torch

import wax_tpu.embed.hash_embedder as jax_hash
import wax_tpu.native.build as jax_native
import wax_tpu.orchestrator as jax_orch
import wax_tpu.rag.config as jax_rag
import wax_tpu.search.engine_cache as jax_cache
import wax_tpu.structured.memory as jax_memory
import wax_tpu.text.chunker as jax_chunker
import wax_tpu.types as jax_types
import wax_tpu_torch.embed.hash_embedder as port_hash
import wax_tpu_torch.orchestrator as port_orch
import wax_tpu_torch.rag.config as port_rag
import wax_tpu_torch.search.engine_cache as port_cache
import wax_tpu_torch.structured.memory as port_memory
import wax_tpu_torch.text.chunker as port_chunker
import wax_tpu_torch.types as port_types
from wax_tpu_torch.parallel.mesh import data_mesh
from wax_tpu_torch.search.vector_engines import (AutoVectorEngine, FlatVectorEngine, IVFVectorEngine,
                                                 ShardedFlatVectorEngine)
from wax_tpu_torch.utils.profiling import span_stats

# Each pytest-xdist worker builds and loads the native C++ library (both packages read
# WAX_TPU_NATIVE_DIR at every load) in a directory of its own: the JAX package's build
# is not safe when several processes use it for the first time at once. Workers collect
# every module before they run a test, so this is set before any test's first load. A
# JAX module collected earlier may already have tried the shared directory, lost that
# race and marked the library unavailable for the process; the JAX loader then tries
# again, in the worker's own directory.
if "PYTEST_XDIST_WORKER" in os.environ and "WAX_TPU_NATIVE_DIR" not in os.environ:
    os.environ["WAX_TPU_NATIVE_DIR"] = os.path.join(
        tempfile.gettempdir(), f"wax-tpu-native-{os.environ['PYTEST_XDIST_WORKER']}")
    jax_native._load_failed = False

PKGS = {
    "jax": (jax_orch, jax_hash, jax_rag, jax_chunker, jax_types),
    "port": (port_orch, port_hash, port_rag, port_chunker, port_types),
}
T0 = 1_700_000_000_000
NAMES = ["Maria", "Max", "Sofia", "Chen", "Ravi", "Lena"]
PLACES = ["Barcelona", "Austin", "Lisbon", "the cabin", "Kyoto", "the lake house"]
WORDS = ("apple banana cherry river mountain project alpha milestones password wifi garden "
         "bicycle architect swimming recipe invoice meeting budget travel trip notes").split()


def _corpus(seed: int = 0):
    """(documents, metadatas): short notes plus a few multi-chunk documents."""
    rng = np.random.default_rng(seed)
    docs, metas = [], []
    for i in range(240):
        name, place = rng.choice(NAMES), rng.choice(PLACES)
        filler = " ".join(rng.choice(WORDS, int(rng.integers(3, 18))))
        docs.append(f"{name} went to {place} on day {i} and wrote about {filler}.")
        metas.append({"topic": str(rng.choice(["travel", "work", "home"]))} if i % 5 == 0 else {})
    for i in range(6):
        docs.append(" ".join(f"Sentence {j} about project alpha milestones and {rng.choice(WORDS)} work."
                             for j in range(60 + 10 * i)))
        metas.append({"topic": "work"})
    return docs, metas


def _config(pkg: str, **kw):
    orch, _, rag, chunker, _ = PKGS[pkg]
    clock = itertools.count(T0, 60_000)
    return orch.OrchestratorConfig(
        chunking=chunker.ChunkingStrategy(target_tokens=64, overlap_tokens=8),
        rag=rag.FastRAGConfig(deterministic_now_ms=T0 + 10**9),
        clock_ms=lambda: next(clock),
        **kw,
    )


def _open(pkg: str, path, config=None, **kw):
    orch, hashing, *_ = PKGS[pkg]
    if pkg == "port":
        kw.setdefault("device", "cpu")
    return orch.MemoryOrchestrator(path, hashing.HashEmbedder(64), config or _config(pkg), **kw)


def _ingest(o) -> None:
    docs, metas = _corpus()
    o.remember_batch(docs[:120], metas[:120])
    o.remember_batch(docs[240:], metas[240:])  # the multi-chunk documents
    o.flush()
    for i in range(120, 200):
        o.remember(docs[i], metadata=metas[i], tags=("note", f"batch{i % 3}"),
                   timestamp_ms=T0 + 1000 * i if i % 2 else None)
    o.session_start("s1")
    o.remember_batch(docs[200:220])
    o.remember("Maria works as an architect in Barcelona and loves her bicycle.")
    o.session_end()
    o.handoff("Continue the budget review tomorrow.", session_id="s1", project="alpha",
              pending_tasks=["review invoice", "book travel"])
    o.handoff("Remember the wifi password for the cabin.", project="home")
    o.remember_batch(docs[220:240])
    o.forget(3)
    o.forget(121)  # a document and, for the long ones, its chunks
    o.forget(120 + 1 + 5)
    fact = (port_memory if type(o).__module__.startswith("wax_tpu_torch") else jax_memory).FactValue
    maria = o.entity_upsert("Maria", "person", aliases=("maria",))
    o.fact_assert(maria, "lives_in", fact.text("Barcelona"), evidence_frames=(10, 11, 250))
    city = o.entity_upsert("Barcelona", "place")
    o.fact_assert(city, "country", fact.text("Spain"), evidence_frames=(12,))


REQUESTS = {
    "semantic": {"query": "golden bicycle swimming garden"},
    "factual": {"query": "who lives in Barcelona"},
    "factual_where": {"query": "where does Maria work"},
    "temporal": {"query": "what happened recently"},
    "temporal_week": {"query": "latest travel notes this week"},
    "exploratory": {"query": "tell me about the cabin"},
    "long_query": {"query": "apple banana cherry river mountain project alpha garden bicycle "
                            "architect swimming recipe invoice meeting budget"},
    "and": {"query": "apple AND banana"},
    "or": {"query": "apple OR river"},
    "phrase": {"query": '"project alpha milestones"'},
    "near": {"query": "NEAR(apple river, 4)"},
    "prefix": {"query": "mount*"},
    "not": {"query": "apple NOT banana"},
    "syntax_error": {"query": "apple AND ("},
    "explicit_syntax_error": {"query": '"'},
    "stop_words": {"query": "what is the"},
    "empty": {"query": "   "},
    "repeated_terms": {"query": "apple apple river"},
    "unknown_term": {"query": "zzyzx quuxly"},
    "text_only": {"query": "cabin password", "mode": "TEXT_ONLY"},
    "vector_only": {"query": "cabin password", "mode": "VECTOR_ONLY"},
    "metadata_filter": {"query": "trip travel", "metadata_filter": {"topic": "travel"}},
    "frame_filter": {"query": "apple river", "frame_filter": frozenset(range(0, 100))},
    "time_range": {"query": "notes", "time_range": (T0 + 130_000, T0 + 170_000)},
    "diagnostics": {"query": "Maria Barcelona architect", "include_diagnostics": True},
    "no_structured": {"query": "who lives in Barcelona", "use_structured_memory": False},
    "top_3": {"query": "project alpha", "top_k": 3},
    "top_40": {"query": "project alpha", "top_k": 40},
}


def _request(pkg: str, spec: dict):
    types = PKGS[pkg][4]
    kw = dict(spec)
    if "mode" in kw:
        kw["mode"] = types.SearchMode[kw["mode"]]
    if "time_range" in kw:
        kw["time_range"] = types.TimeRange(*kw["time_range"])
    return types.SearchRequest(**kw)


def _call(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — the two packages must fail alike
        return ("raised", type(e).__name__, str(e))


def _assert_same_response(a, b) -> None:
    if isinstance(a, tuple) or isinstance(b, tuple):
        assert a == b
        return
    assert a.query_type.value == b.query_type.value
    assert a.lane_counts == b.lane_counts and a.warnings == b.warnings
    assert [h.frame_id for h in a.hits] == [h.frame_id for h in b.hits]
    np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits], rtol=1e-6, atol=0)
    assert [h.preview for h in a.hits] == [h.preview for h in b.hits]
    assert [tuple(s.value for s in h.sources) for h in a.hits] == [tuple(s.value for s in h.sources) for h in b.hits]
    for ha, hb in zip(a.hits, b.hits):
        assert (ha.diagnostics is None) == (hb.diagnostics is None)
        if ha.diagnostics is not None:
            da, db = ha.diagnostics, hb.diagnostics
            assert da.lane_ranks == db.lane_ranks and da.tie_break == db.tie_break
            assert set(da.lane_scores) == set(db.lane_scores)
            np.testing.assert_allclose([db.lane_scores[k] for k in sorted(da.lane_scores)],
                                       [da.lane_scores[k] for k in sorted(da.lane_scores)], rtol=1e-5)


@pytest.fixture(scope="module", params=[None, 8], ids=["exact", "budget8"])
def pair(request, tmp_path_factory):
    """The JAX and the port orchestrator over the same ingest, with the postings budget."""
    tmp = tmp_path_factory.mktemp(f"orch_{request.param}")
    jo = _open("jax", tmp / "jax.mv2s", _config("jax", lex_postings_budget=request.param))
    po = _open("port", tmp / "port.mv2s", _config("port", lex_postings_budget=request.param))
    for o in (jo, po):
        _ingest(o)
    yield jo, po
    jo.close()
    po.close()


@pytest.mark.parametrize("name", list(REQUESTS))
def test_search_and_recall_equal_jax(pair, name):
    jo, po = pair
    spec = REQUESTS[name]
    _assert_same_response(_call(lambda: jo.search(_request("jax", spec))),
                          _call(lambda: po.search(_request("port", spec))))
    top_k = spec.get("top_k")
    ra, rb = _call(lambda: jo.recall(spec["query"], top_k)), _call(lambda: po.recall(spec["query"], top_k))
    if isinstance(ra, tuple) or isinstance(rb, tuple):
        assert ra == rb
    else:
        assert ra.render() == rb.render() and ra.total_tokens == rb.total_tokens
        assert [(i.kind.value, i.frame_id, i.sources) for i in ra.items] == \
               [(i.kind.value, i.frame_id, i.sources) for i in rb.items]


def test_ingest_state_equal_jax(pair):
    """Frames, handoffs, facts and the stats the orchestrators report agree."""
    jo, po = pair
    assert jo.store.frame_count() == po.store.frame_count()
    assert [m.frame_id for m in jo.timeline()] == [m.frame_id for m in po.timeline()]
    hj, hp = jo.handoff_latest(project="alpha"), po.handoff_latest(project="alpha")
    assert hj[1] == hp[1] and hj[0].metadata == hp[0].metadata
    assert [(f.value.kind, f.value.value) for f in jo.facts_query()] == \
           [(f.value.kind, f.value.value) for f in po.facts_query()]
    sj, sp = jo.runtime_stats(), po.runtime_stats()
    for key in ("lex_docs", "vector_count", "vector_engine", "access_stats_entries", "flush_count"):
        assert sj[key] == sp[key], key
    assert po.engine.device == torch.device("cpu")


def _answers(o, queries=("apple river", "Maria Barcelona", '"project alpha milestones"', "who lives in Barcelona")):
    return [o.search(q) for q in queries]


def _reopened_answers(pkg, path, **cfg):
    """Answers of a cold reopen in `pkg` (its engine cache cleared): the state another
    package's open rebuilds from the same segments and WAL."""
    (jax_cache if pkg == "jax" else port_cache).clear()
    o = _open(pkg, path, _config(pkg, **cfg))
    try:
        return _answers(o)
    finally:
        o.close()


def _write(pkg, path, **cfg):
    o = _open(pkg, path, _config(pkg, **cfg))
    _ingest(o)
    o.flush()
    o.remember("A late note about the river cabin, left in the WAL.")
    return o


@pytest.mark.parametrize("engine", ["flat", "auto"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_store_crosses_packages(tmp_path, engine, writer, reader):
    """A store one package writes (segments plus a WAL tail) opens in the other with
    equal answers."""
    _write(writer, tmp_path / "m.mv2s", vector_engine=engine).close()
    want = _reopened_answers(writer, tmp_path / "m.mv2s", vector_engine=engine)
    r = _open(reader, tmp_path / "m.mv2s", _config(reader, vector_engine=engine))
    try:
        for a, b in zip(want, _answers(r)):
            _assert_same_response(a, b)
        if reader == "port":
            assert type(r.engine.vector) is {"flat": FlatVectorEngine, "auto": AutoVectorEngine}[engine]
    finally:
        r.close()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_ivf_store_crosses_packages(tmp_path, writer, reader):
    """An IVF segment crosses with equal parameters and builder arrays (the buckets
    themselves are rebuilt: the port's k-means draws differ by design)."""
    w = _write(writer, tmp_path / "m.mv2s", vector_engine="ivf")
    w.flush()
    want = w.engine.vector
    want_state = {k: v.copy() for k, v in want.builder.state_arrays().items()}
    w.close()
    r = _open(reader, tmp_path / "m.mv2s", _config(reader, vector_engine="ivf"))
    try:
        got = r.engine.vector
        assert got.kind == "ivf" and (reader == "jax" or isinstance(got, IVFVectorEngine))
        for attr in ("nprobe", "seed", "n_clusters", "spill", "dim"):
            assert getattr(got, attr) == getattr(want, attr), attr
        for k, v in got.builder.state_arrays().items():
            assert np.array_equal(v, want_state[k]), k
        assert len(r.search("apple river").hits) > 0
    finally:
        r.close()


def test_sharded_segment_loads_as_flat(tmp_path):
    """A JAX store served by the mesh-sharded engine (sharded_lanes on the 8-device CPU
    mesh) opens in the port's default config as the mesh-sharded flat engine on a
    one-device mesh of the reader's device, with equal answers."""
    w = _write("jax", tmp_path / "m.mv2s", sharded_lanes=True)
    assert w.engine.vector.kind == "sharded"
    w.close()
    want = _reopened_answers("jax", tmp_path / "m.mv2s", sharded_lanes=True)
    r = _open("port", tmp_path / "m.mv2s")
    try:
        assert type(r.engine.vector) is ShardedFlatVectorEngine and r.engine.vector.mesh == data_mesh("cpu")
        for a, b in zip(want, _answers(r)):
            _assert_same_response(a, b)
    finally:
        r.close()


def test_sharded_lanes_flat_on_one_device(tmp_path):
    """sharded_lanes with the flat engine serves on the one-device mesh and answers as
    the unsharded orchestrator does."""
    a = _write("port", tmp_path / "a.mv2s", vector_engine="flat")
    b = _write("port", tmp_path / "b.mv2s", vector_engine="flat", sharded_lanes=True)
    try:
        assert b.engine.lex_sharded and not a.engine.lex_sharded
        for x, y in zip(_answers(a), _answers(b)):
            _assert_same_response(x, y)
    finally:
        a.close()
        b.close()


def test_cold_reopen_answers_as_reclaimed(tmp_path):
    """A reopen that deserializes the segments (engine cache cleared) answers as one
    that reclaims the parked builders."""
    path = tmp_path / "m.mv2s"
    w = _write("port", path)
    w.close()
    warm = _open("port", path)
    warm_answers = _answers(warm)
    warm.close()
    port_cache.clear()
    before = span_stats().get("open.vec_decode", {}).get("count", 0)
    cold = _open("port", path)
    try:
        assert span_stats()["open.vec_decode"]["count"] == before + 1
        for a, b in zip(warm_answers, _answers(cold)):
            _assert_same_response(a, b)
        cold.warmup(background=False)
        assert cold.wait_for_warmup()
    finally:
        cold.close()


class _OtherDeviceEngine:
    """A parked vector engine that reports another device than the opener's."""

    kind = "auto"
    device = torch.device("meta")

    def __len__(self):
        return 0


def test_parked_engine_of_another_device_is_not_served(tmp_path):
    path = tmp_path / "m.mv2s"
    w = _write("port", path)
    w.flush()
    lex_sha, vec_sha = (w.store.toc.manifests[k].sha for k in ("lex", "vec"))
    n = len(w.engine.vector)
    w.close()
    parked_lex = port_cache.reclaim(path, lex_sha, vec_sha)[0]
    port_cache.park(path, lex_sha, vec_sha, parked_lex, _OtherDeviceEngine())
    before = span_stats().get("open.vec_decode", {}).get("count", 0)
    r = _open("port", path)
    try:
        assert isinstance(r.engine.vector, AutoVectorEngine) and len(r.engine.vector) == n
        assert r.engine.vector.device == torch.device("cpu")
        assert span_stats()["open.vec_decode"]["count"] == before + 1
    finally:
        r.close()
        port_cache.clear()


@pytest.mark.parametrize("config,devices", [
    ({"sharded_lanes": True}, ["cpu"] * 4),
    ({"sharded_lanes": True, "vector_engine": "flat", "mesh_slices": 2}, ["cpu"] * 4),
    ({"sharded_lanes": True, "vector_engine": "ivf", "mesh_tp": 2}, ["cpu"] * 4),
], ids=["sharded_auto", "mesh_slices", "mesh_tp"])
def test_later_slices_serve(tmp_path, config, devices):
    """The sharded configurations serve over a mesh of logical CPU shards: the
    `auto` engine becomes the mesh-sharded flat engine, `mesh_slices` and `mesh_tp`
    give the two-level mesh, and both lanes share the mesh (an IVF engine is not
    sharded: it serves on the lead device); answers equal the unsharded
    orchestrator's."""
    a = _write("port", tmp_path / "a.mv2s", vector_engine=config.get("vector_engine", "auto"))
    b = _open("port", tmp_path / "b.mv2s", _config("port", **config), device=devices)
    try:
        _ingest(b)
        b.flush()
        b.remember("A late note about the river cabin, left in the WAL.")
        assert b.engine.lex_sharded and b.engine.device == torch.device("cpu")
        assert b.engine.mesh.devices == (torch.device("cpu"),) * 4
        assert b.engine.mesh.axis_names == (("slice", "data", "tp") if config.get("mesh_tp") else
                                            ("slice", "data") if config.get("mesh_slices") else ("data",))
        assert b.engine.vector.kind == {"auto": "sharded"}.get(config.get("vector_engine", "auto"),
                                                               config.get("vector_engine"))
        if b.engine.vector.kind == "sharded":
            assert b.engine.vector.mesh is b.engine.mesh
        for x, y in zip(_answers(a), _answers(b)):
            assert x.hits
            _assert_same_response(x, y)
    finally:
        a.close()
        b.close()
    _open("port", tmp_path / "m.mv2s").close()  # no lease left behind


@pytest.mark.parametrize("config,devices,match", [
    ({"sharded_lanes": True, "mesh_slices": 3}, ["cpu"] * 4, "does not divide"),
    ({}, ["cpu"] * 4, "sharded_lanes"),
], ids=["slices_do_not_divide", "devices_without_sharded_lanes"])
def test_bad_topologies_raise(tmp_path, config, devices, match):
    with pytest.raises(ValueError, match=match):
        _open("port", tmp_path / "m.mv2s", _config("port", **config), device=devices)
    _open("port", tmp_path / "m.mv2s").close()  # no lease left behind


def test_hnsw_config_serves(tmp_path):
    """OrchestratorConfig(vector_engine="hnsw") opens and serves: remember, search,
    recall, flush, warmup and a cold reopen, on an hnsw engine throughout."""
    path = tmp_path / "m.mv2s"
    o = _open("port", path, _config("port", vector_engine="hnsw"))
    try:
        fid = o.remember("an hnsw-served note about the river").frame_ids[0]
        o.remember_batch(["the lighthouse keeper logs the tides", "a river cabin with a green door"])
        assert o.runtime_stats()["vector_engine"] == "hnsw" and o.engine.vector.device == torch.device("cpu")
        hits = o.search("hnsw served river note").hits
        assert hits and hits[0].frame_id == fid
        assert o.recall("river cabin").render()
        o.flush()
        o.warmup(background=False)
        want = _answers(o)
    finally:
        o.close()
    port_cache.clear()
    r = _open("port", path, _config("port", vector_engine="hnsw"))
    try:
        assert r.engine.vector.kind == "hnsw" and len(r.engine.vector) == 3
        for a, b in zip(want, _answers(r)):
            _assert_same_response(a, b)
    finally:
        r.close()
        port_cache.clear()


def test_maintainer_raises(tmp_path):
    """The maintainer serves (built once, lazily; the scheduled rewrite is off by
    default); a multi-slice mesh config still raises."""
    from wax_tpu_torch.orchestrator.maintenance import Maintainer

    o = _open("port", tmp_path / "p.mv2s")
    try:
        m = o.maintainer
        assert isinstance(m, Maintainer) and o.maintainer is m
        o.remember("a note to compact")
        assert o.maintainer.compact_indexes() >= 1
        assert o.maintainer.maybe_scheduled_rewrite().reason == "disabled"
    finally:
        o.close()
    with pytest.raises(ValueError, match="sharded_lanes"):
        _config("port", mesh_slices=2)


def test_jax_hnsw_store_opens_in_port(tmp_path):
    """A store the JAX package wrote with an hnsw vector segment opens in the port (the
    default config: the segment decides the engine) and answers as JAX does."""
    w = _open("jax", tmp_path / "h.mv2s", _config("jax", vector_engine="hnsw"))
    w.remember("an hnsw-served note about the river")
    w.remember_batch(["the lighthouse keeper logs the tides", "a river cabin with a green door"])
    w.flush()
    w.close()
    want = _reopened_answers("jax", tmp_path / "h.mv2s", vector_engine="hnsw")
    jax_cache.clear()
    r = _open("port", tmp_path / "h.mv2s")
    try:
        assert r.engine.vector.kind == "hnsw"
        for a, b in zip(want, _answers(r)):
            _assert_same_response(a, b)
    finally:
        r.close()
        port_cache.clear()


def test_remember_file_text_and_pdf(tmp_path):
    """A text file and a PDF are remembered as the JAX orchestrator remembers them; a
    PDF without text raises alike."""
    from tests.test_pdf import _make_pdf

    note = tmp_path / "note.txt"
    note.write_text("The spare key hangs behind the garden shed door.")
    (tmp_path / "scan.pdf").write_bytes(_make_pdf(["The ladder leans on the boathouse wall"], compress=True))
    (tmp_path / "blank.pdf").write_bytes(b"%PDF-1.4 not really a pdf")
    jo, po = _open("jax", tmp_path / "j.mv2s"), _open("port", tmp_path / "p.mv2s")
    try:
        for o in (jo, po):
            o.remember_file(note)
            o.remember_file(tmp_path / "scan.pdf")
            with pytest.raises(ValueError, match="no extractable text"):
                o.remember_file(tmp_path / "blank.pdf")
        for q in ("garden shed key", "ladder boathouse"):
            _assert_same_response(jo.search(q), po.search(q))
        assert po.store.frame_content(1) == jo.store.frame_content(1)
        assert b"boathouse" in po.store.frame_content(1)
        assert po.store.frame_meta(1).metadata == jo.store.frame_meta(1).metadata
    finally:
        jo.close()
        po.close()
