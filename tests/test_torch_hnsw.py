"""The port's HNSW path against wax_tpu's on the CPU.

Both packages get the same numpy inputs. The graph builders (the numpy one and the
native C++ one) must give equal state arrays and equal snapshot arrays from the same
adds; `hnsw_search` runs on one graph carried across with `graph_index_from_numpy` and
must equal JAX's bit for bit where the products are exact (entries on the 1/8 grid,
`normalize=False`), and within the stated tolerances on random unit vectors. Then the
engine, the vector segment (v2 raw arrays and the legacy v1 npz) across packages both
ways, and the two orchestrators over one ingest with `vector_engine="hnsw"`.
"""
import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import wax_tpu.index.graph as jgraph
import wax_tpu.index.graph_cpp as jgraph_cpp
import wax_tpu.ops.beam_search as jbeam
import wax_tpu.orchestrator.serialization as jser
import wax_tpu.search.engine_cache as jax_cache
import wax_tpu.search.vector_engines as jve
import wax_tpu_torch.index.graph as tgraph
import wax_tpu_torch.index.graph_cpp as tgraph_cpp
import wax_tpu_torch.ops.beam_search as tbeam
import wax_tpu_torch.orchestrator.serialization as tser
import wax_tpu_torch.search.engine_cache as port_cache
import wax_tpu_torch.search.vector_engines as tve
from tests.test_torch_orchestrator import (REQUESTS, _assert_same_response, _call, _config, _ingest, _open,
                                           _request)

FIELDS = ("adjacency", "emb", "frame_ids", "bias", "entries")
BUILDERS = {"py": (jgraph.HNSWBuilder, tgraph.HNSWBuilder), "cpp": (jgraph_cpp.CppHNSWBuilder, tgraph_cpp.CppHNSWBuilder)}


def _unit(rng, n, d):
    v = rng.standard_normal((n, d)).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _clustered(rng, n, d, centres=20):
    c = rng.standard_normal((centres, d)) * 2.0
    v = (c[rng.integers(0, centres, n)] + rng.standard_normal((n, d))).astype(np.float32)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _grid(rng, shape):
    """Entries k/8 in [-1, 1]: every product is exact in f32, ties are common."""
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


def _assert_state_equal(a: dict, b: dict) -> None:
    assert set(a) == set(b)
    for key in a:
        assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key


def _assert_graph_equal(jg, tg) -> None:
    """A JAX GraphIndex and a port GraphIndex (on the CPU) hold equal arrays."""
    for f in FIELDS:
        a, b = np.asarray(getattr(jg, f)), getattr(tg, f).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), f
    assert (tg.capacity, tg.dim, tg.max_degree) == (jg.capacity, jg.dim, jg.max_degree)


def _pair(kind, d, **kw):
    jcls, tcls = BUILDERS[kind]
    return jcls(dim=d, **kw), tcls(dim=d, **kw)


def _carry(jg, device="cpu"):
    return tgraph.graph_index_from_numpy(*(np.asarray(getattr(jg, f)) for f in FIELDS), device=device)


# ----------------------------------------------------------------------------- builders


@pytest.mark.parametrize("kind,n", [("py", 240), ("cpp", 2000)])
@pytest.mark.parametrize("extend", [True, False])
@pytest.mark.parametrize("m", [4, 8, 16])
def test_builders_equal_jax(kind, n, m, extend):
    """The same adds (with a remove and an upsert between them) give equal state
    arrays and equal snapshot arrays in both packages."""
    rng = np.random.default_rng(m * 10 + extend)
    vecs = _clustered(rng, n, 16)
    j, t = _pair(kind, 16, m=m, ef_construction=40, extend_candidates=extend, seed=3)
    for b in (j, t):
        b.add_batch(np.arange(n // 2), vecs[: n // 2])
        b.remove(5)
        b.add(7, vecs[-1])  # upsert: remove, then add as a new row
        b.add_batch(np.arange(n // 2, n - 1), vecs[n // 2 : n - 1])
    assert type(t).__name__ == type(j).__name__
    assert (len(t), t.generation, 5 in t, 7 in t) == (len(j), j.generation, 5 in j, 7 in j)
    _assert_state_equal(j.state_arrays(), t.state_arrays())
    _assert_graph_equal(j.snapshot(), t.snapshot(device="cpu"))
    np.testing.assert_array_equal(t.vector(7), j.vector(7))


@pytest.mark.parametrize("kind", ["py", "cpp"])
def test_empty_and_single_node_graphs(kind):
    j, t = _pair(kind, 8, normalize=False)
    _assert_state_equal(j.state_arrays(), t.state_arrays())
    _assert_graph_equal(j.snapshot(), t.snapshot(device="cpu"))
    v = np.full(8, 0.5, np.float32)
    for b in (j, t):
        b.add(0, v)
    _assert_state_equal(j.state_arrays(), t.state_arrays())
    jg, tg = j.snapshot(), t.snapshot(device="cpu")
    _assert_graph_equal(jg, tg)
    q = v[None, :]
    jv, jf = jbeam.hnsw_search(jnp.asarray(q), jg, k=3, ef=8)
    tv, tf = tbeam.hnsw_search(torch.from_numpy(q), tg, k=3, ef=8)
    assert np.array_equal(np.asarray(jf), tf.numpy()) and np.array_equal(np.asarray(jv), tv.numpy())
    assert tf[0, 0] == 0 and (tf[0, 1:] == -1).all()
    for b in (j, t):
        b.remove(0)  # the last live node: the entry moves to none
    _assert_graph_equal(j.snapshot(), t.snapshot(device="cpu"))


@pytest.mark.parametrize("kind", ["py", "cpp"])
def test_snapshot_seed_cap_exact(kind):
    """The seed sampling of `test_snapshot_seed_cap_exact` (wax_tpu's tests/test_hnsw.py)
    gives equal entries in both packages at every cap."""
    rng = np.random.default_rng(0)
    n = 3000 if kind == "cpp" else 600
    j, t = _pair(kind, 16, m=4, ef_construction=30)
    vecs = rng.standard_normal((n, 16), dtype=np.float32)
    for b in (j, t):
        b.add_batch(np.arange(n), vecs)
    levels = t.state_arrays()["levels"]
    n1 = int((levels >= 1).sum())
    for cap in (1, 8, 64, 512, n1 - n1 // 3, 8192):
        jg, tg = j.snapshot(seed_cap=cap), t.snapshot(seed_cap=cap, device="cpu")
        _assert_graph_equal(jg, tg)
        want = min(cap, n)
        assert want - 8 <= len(np.unique(tg.entries.numpy())) <= want + 8, cap
        assert tg.entries.shape[0] % 8 == 0


@pytest.mark.parametrize("src,dst", [("py", "py"), ("py", "cpp"), ("cpp", "py"), ("cpp", "cpp")])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_from_state_arrays_crosses_packages(src, dst, direction):
    """State arrays of one package's builder restore in the other's (either builder
    kind) to the same state and the same graph, and building continues alike."""
    rng = np.random.default_rng(11)
    vecs = _unit(rng, 300, 16)
    js, ts = _pair(src, 16, m=8, ef_construction=40)
    writer = js if direction == "jax_to_port" else ts
    writer.add_batch(np.arange(299), vecs[:299])
    writer.remove(17)
    state = writer.state_arrays()
    jd, td = BUILDERS[dst]
    j2, t2 = jd.from_state_arrays(state, dim=16), td.from_state_arrays(state, dim=16)
    _assert_state_equal(j2.state_arrays(), t2.state_arrays())
    _assert_graph_equal(j2.snapshot(), t2.snapshot(device="cpu"))
    for b in (j2, t2):
        b.add(999, vecs[299])
    _assert_state_equal(j2.state_arrays(), t2.state_arrays())
    assert 999 in t2 and 17 not in t2


# ------------------------------------------------------------------------- beam search


@pytest.fixture(scope="module")
def grid_graph():
    """A JAX numpy-builder graph on grid rows (normalize=False), with dead rows."""
    rng = np.random.default_rng(5)
    vecs = _grid(rng, (400, 16))
    b = jgraph.HNSWBuilder(dim=16, m=8, ef_construction=40, normalize=False)
    b.add_batch(np.arange(400), vecs)
    for fid in (0, 3, 50, 77, 200, 399):
        b.remove(fid)
    return b, _grid(rng, (48, 16))


@pytest.mark.parametrize("seed_cap", [8, 8192], ids=["8_seeds", "all_seeds"])
@pytest.mark.parametrize("k", [1, 10])
@pytest.mark.parametrize("ef", [8, 16, 64])
def test_search_bit_equal_on_grid(grid_graph, seed_cap, ef, k):
    """Ids and scores equal JAX's bit for bit on exact-arithmetic data, dead rows
    included; with 8 seeds ef 16 and 64 exceed the seed count."""
    b, q = grid_graph
    jg = b.snapshot(seed_cap=seed_cap)
    tg = _carry(jg)
    jv, jf = jbeam.hnsw_search(jnp.asarray(q), jg, k=k, ef=ef)
    tv, tf = tbeam.hnsw_search(torch.from_numpy(q), tg, k=k, ef=ef)
    assert tf.dtype == torch.int32 and tv.dtype == torch.float32 and tf.shape == (len(q), min(k, ef))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    live = set(b._row_of)
    assert all(int(f) in live for f in tf.numpy().ravel() if f >= 0)


def test_search_iters_and_bf16_rows(grid_graph):
    """A short beam (iters < ef) equals JAX's, and bf16 rows (exact for grid data)
    give the f32 graph's answers."""
    b, q = grid_graph
    jg = b.snapshot()
    tg = _carry(jg)
    jv, jf = jbeam.hnsw_search(jnp.asarray(q), jg, k=10, ef=32, iters=5)
    tv, tf = tbeam.hnsw_search(torch.from_numpy(q), tg, k=10, ef=32, iters=5)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    port = tgraph.HNSWBuilder.from_state_arrays(b.state_arrays(), dim=16, normalize=False)
    tb = port.snapshot(device_dtype=torch.bfloat16, device="cpu")
    assert tb.emb.dtype == torch.bfloat16
    bv, bf = tbeam.hnsw_search(torch.from_numpy(q), tb, k=10, ef=32)
    fv, ff = tbeam.hnsw_search(torch.from_numpy(q), tg, k=10, ef=32)
    assert torch.equal(bf, ff) and torch.equal(bv, fv)


def _recall(found, truth, k=10) -> float:
    return sum(len(set(f[:k].tolist()) & set(t[:k].tolist())) for f, t in zip(found, truth)) / (len(found) * k)


def test_search_near_jax_on_random_unit_vectors():
    """On clustered unit vectors the products differ from JAX's in the last bits:
    ids are equal on >= 99% of query rows and recall@10 against the exact top-10 is
    within 0.01 of JAX's at each ef."""
    rng = np.random.default_rng(7)
    vecs, q = _clustered(rng, 3000, 64), _clustered(rng, 96, 64)
    b = jgraph_cpp.CppHNSWBuilder(dim=64, m=16, ef_construction=100)
    b.add_batch(np.arange(3000), vecs)
    jg = b.snapshot()
    tg = _carry(jg)
    truth = np.argsort(-(q.astype(np.float64) @ vecs.T.astype(np.float64)), axis=1)[:, :10]
    for ef in (16, 64, 128):
        jv, jf = jbeam.hnsw_search(jnp.asarray(q), jg, k=10, ef=ef)
        tv, tf = tbeam.hnsw_search(torch.from_numpy(q), tg, k=10, ef=ef)
        jf, tf = np.asarray(jf), tf.numpy()
        same = (jf == tf).all(axis=1).mean()
        assert same >= 0.99, (ef, same)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=0, atol=1e-6)
        assert abs(_recall(tf, truth) - _recall(jf, truth)) <= 0.01, ef
    assert _recall(tf, truth) >= 0.9


@pytest.mark.parametrize("width,span", [(40, 8), (304, 50), (304, 400)])
def test_dedup_by_id_equals_jax(width, span):
    """`_dedup_by_id` on random ids with duplicates, -1s and expanded flags."""
    rng = np.random.default_rng(width + span)
    ids = rng.integers(-1, span, (32, width)).astype(np.int32)
    scores = rng.standard_normal((32, width)).astype(np.float32)
    exp = rng.random((32, width)) < 0.3
    want = jbeam._dedup_by_id(jnp.asarray(ids), jnp.asarray(scores), jnp.asarray(exp))
    got = tbeam._dedup_by_id(torch.from_numpy(ids), torch.from_numpy(scores), torch.from_numpy(exp))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


# ------------------------------------------------------------------------------ engine


def _engines(**kw):
    return jve.HNSWVectorEngine(dim=32, **kw), tve.HNSWVectorEngine(dim=32, device="cpu", **kw)


def _assert_search_equal(je, te, q, k) -> None:
    jv, jf = je.search(q, k)
    tv, tf = te.search(q, k)
    assert tf.shape == jf.shape == (np.atleast_2d(q).shape[0], min(k, tve.MAX_TOP_K))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=0, atol=1e-6)


def test_engine_mutation_and_edges_as_jax(monkeypatch):
    """Adds, an upsert and removes; an empty engine; k > ef_search; the MAX_TOP_K clamp
    (lowered to 96 in both packages, so the beam stays short)."""
    rng = np.random.default_rng(3)
    vecs = _unit(rng, 400, 32)
    je, te = _engines(m=8, ef_construction=60, ef_search=24)
    assert te.kind == "hnsw" and isinstance(te.builder, tgraph_cpp.CppHNSWBuilder)
    for e in (je, te):
        v, f = e.search(vecs[:3], 5)
        assert f.shape == (3, 5) and (f == -1).all() and (v == -np.inf).all()
    for e in (je, te):
        e.add_batch(np.arange(300), vecs[:300])
        e.add(10, vecs[350])  # upsert
        assert e.remove(20) and not e.remove(20)
        e.add(301, vecs[301])
    assert (len(te), 20 in te, 10 in te) == (len(je), False, True)
    _assert_search_equal(je, te, vecs[:16], 10)
    _assert_search_equal(je, te, vecs[350], 1)
    _assert_search_equal(je, te, vecs[:4], 40)  # k > ef_search: ef = k
    for mod in (jve, tve):
        monkeypatch.setattr(mod, "MAX_TOP_K", 96)
    _assert_search_equal(je, te, vecs[:2], 500)
    snap = te.snapshot()
    assert te.snapshot() is snap and te.snapshot_count == 1
    te.trace(snap)
    te.add(302, vecs[302])
    assert te.snapshot() is not snap and te.snapshot_count == 2
    assert snap.device == torch.device("cpu")


@pytest.mark.parametrize("fmt", ["v2", "v1_npz"])
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_vector_segment_crosses_packages(writer, fmt):
    """An hnsw vector segment written by one package (the v2 raw arrays, or the legacy
    v1 npz of the same state) loads in both with equal state and answers."""
    rng = np.random.default_rng(9)
    vecs = _unit(rng, 200, 32)
    je, te = _engines(m=8, ef_construction=60, ef_search=40)
    src = je if writer == "jax" else te
    src.add_batch(np.arange(200), vecs)
    src.remove(4)
    blob, attrs = (jser if writer == "jax" else tser).serialize_vector_engine(src, embedder_identity="hash-32")
    assert attrs["format"] == tser.HNSW_FORMAT_V2 == jser.HNSW_FORMAT_V2
    assert (attrs["engine"], attrs["dim"], attrs["count"], attrs["ef_search"]) == ("hnsw", "32", "199", "40")
    if fmt == "v1_npz":
        buf = io.BytesIO()
        np.savez(buf, **src.builder.state_arrays())
        blob, attrs = buf.getvalue(), dict(attrs, format=tser.HNSW_FORMAT)
    jl, tl = jser.deserialize_vector_engine(blob, attrs), tser.deserialize_vector_engine(blob, attrs, device="cpu")
    assert tl.kind == "hnsw" and tl.ef_search == 40 and tl.device == torch.device("cpu")
    _assert_state_equal(jl.builder.state_arrays(), tl.builder.state_arrays())
    _assert_state_equal(src.builder.state_arrays(), tl.builder.state_arrays())
    _assert_search_equal(jl, tl, vecs[:12], 10)
    # both packages write the loaded state back as the same bytes and attrs
    assert tser.serialize_vector_engine(tl) == jser.serialize_vector_engine(jl)


# ------------------------------------------------------------------------ orchestrator


@pytest.fixture(scope="module")
def hnsw_pair(tmp_path_factory):
    """The JAX and the port orchestrator over the same ingest, vector_engine="hnsw"."""
    tmp = tmp_path_factory.mktemp("orch_hnsw")
    jo = _open("jax", tmp / "jax.mv2s", _config("jax", vector_engine="hnsw"))
    po = _open("port", tmp / "port.mv2s", _config("port", vector_engine="hnsw"))
    for o in (jo, po):
        _ingest(o)
    yield jo, po
    jo.close()
    po.close()


@pytest.mark.parametrize("name", ["semantic", "factual", "exploratory", "long_query", "vector_only", "near",
                                  "metadata_filter", "diagnostics", "top_40"])
def test_orchestrators_on_hnsw_answer_alike(hnsw_pair, name):
    jo, po = hnsw_pair
    assert po.engine.vector.kind == jo.engine.vector.kind == "hnsw"
    spec = REQUESTS[name]
    _assert_same_response(_call(lambda: jo.search(_request("jax", spec))),
                          _call(lambda: po.search(_request("port", spec))))
    top_k = spec.get("top_k")
    ra, rb = jo.recall(spec["query"], top_k), po.recall(spec["query"], top_k)
    assert ra.render() == rb.render() and ra.total_tokens == rb.total_tokens


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_hnsw_store_crosses_packages(tmp_path, writer, reader):
    """A store whose vector segment is hnsw (plus a WAL tail) opens in the other package
    with equal answers and an hnsw engine."""
    path = tmp_path / "m.mv2s"
    w = _open(writer, path, _config(writer, vector_engine="hnsw"))
    _ingest(w)
    w.flush()
    w.remember("A late note about the river cabin, left in the WAL.")
    w.close()
    (jax_cache if writer == "jax" else port_cache).clear()
    queries = ("apple river", "Maria Barcelona", "cabin password", "who lives in Barcelona")
    want_o = _open(writer, path, _config(writer, vector_engine="hnsw"))
    want = [want_o.search(q) for q in queries]
    want_o.close()
    (jax_cache if writer == "jax" else port_cache).clear()
    r = _open(reader, path, _config(reader, vector_engine="hnsw"))
    try:
        assert r.engine.vector.kind == "hnsw" and r.runtime_stats()["vector_engine"] == "hnsw"
        for a, b in zip(want, [r.search(q) for q in queries]):
            _assert_same_response(a, b)
    finally:
        r.close()
        jax_cache.clear()
        port_cache.clear()
