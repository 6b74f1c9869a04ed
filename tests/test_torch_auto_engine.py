"""The IVF and auto vector engines, make_vector_engine and HybridSearchEngine's
vector_preference against wax_tpu's, on the CPU (JAX's IVF kernel in interpret mode,
the port's K7 wrapper on its plain twin).

The engines' k-means draws differ by design (torch generator against jax.random), so
the port's own builds are held to JAX's recall, not to its buckets; placement is held
exactly by carrying a JAX snapshot across (`ivf_index_from_numpy`) and adding to both.
Seeds come from crc32 of a name, never hash().
"""
import zlib

import numpy as np
import pytest
import torch

from wax_tpu.search import vector_engines as jve
from wax_tpu.search.engine import HybridSearchEngine as JaxHybrid
from wax_tpu_torch.index.ivf import ivf_index_from_numpy
from wax_tpu_torch.search import vector_engines as tve
from wax_tpu_torch.search.engine import HybridSearchEngine

N, D, K = 6000, 64, 10


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def _normalize(x):
    return (x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-9)).astype(np.float32)


def _geometry(kind: str, rng):
    """The three geometries of tests/test_auto_engine.py."""
    if kind == "uniform":
        return _normalize(rng.normal(size=(N, D)).astype(np.float32))
    n_centers, sigma = (40, 0.3) if kind == "clustered" else (20, 0.05)
    centers = _normalize(rng.normal(size=(n_centers, D)).astype(np.float32))
    pts = centers[rng.integers(0, n_centers, N)] + sigma * rng.normal(size=(N, D)).astype(np.float32)
    return _normalize(pts)


def _recall(got, ref):
    return tve.AutoVectorEngine._recall(ref, got)


def _carry_snapshot(jeng, teng):
    """Give the port engine the JAX engine's current snapshot as its own, as if it had
    built it: the adds it holds are in that snapshot."""
    snap = jeng.snapshot()
    teng._pending_adds.clear()
    teng._snap = ivf_index_from_numpy(*(np.asarray(x) for x in (snap.centroids, snap.emb, snap.ids, snap.bias)),
                                      snap.spilled, device="cpu")
    teng._snap_gen = teng.builder.generation
    teng._trained_count = jeng._trained_count


def _pair(n0=512, dim=32, name="pair", n_clusters=8, **kw):
    """A JAX and a port IVF engine over the same vectors, the port's snapshot carried
    across from JAX's."""
    rng = _rng(name)
    v = rng.standard_normal((n0, dim)).astype(np.float32)
    je = jve.IVFVectorEngine(dim=dim, n_clusters=n_clusters, **kw)
    te = tve.IVFVectorEngine(dim=dim, n_clusters=n_clusters, device="cpu", **kw)
    for e in (je, te):
        e.add_batch(np.arange(n0), v)
    _carry_snapshot(je, te)
    return je, te, rng


def _snap_equal(je, te):
    js, ts = je.snapshot(), te.snapshot()
    np.testing.assert_array_equal(ts.ids.numpy(), np.asarray(js.ids))
    np.testing.assert_array_equal(ts.bias.numpy(), np.asarray(js.bias))
    np.testing.assert_allclose(ts.emb.numpy(), np.asarray(js.emb), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("batches", [1, 3])
def test_incremental_adds_place_as_jax(batches):
    """Adds to a carried-across snapshot land in JAX's buckets and slots (the first of
    8 preferred centroids with room; live rows stay a bucket prefix)."""
    je, te, rng = _pair(name=f"incremental-{batches}")
    for b in range(batches):
        new = rng.standard_normal((16, 32)).astype(np.float32)
        fids = np.arange(1000 + 16 * b, 1016 + 16 * b)
        for e in (je, te):
            e.add_batch(fids, new)
        _snap_equal(je, te)
    assert te.incremental_count == je.incremental_count == batches
    assert te._trained_count == je._trained_count == 512
    q = rng.standard_normal((4, 32)).astype(np.float32)
    (jv, jf), (tv, tf) = je.search(q, 5), te.search(q, 5)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=1e-6)


def test_incremental_adds_past_full_preferred_buckets_go_to_the_emptiest():
    """Adds crowding one direction fill their 8 preferred buckets; the rest go to the
    emptiest bucket, one at a time, as in JAX."""
    je, te, rng = _pair(n0=2000, name="full", n_clusters=16)
    js = je.snapshot()
    assert (js.n_clusters, js.bucket_size) == (16, 256)
    new = np.asarray(js.centroids)[0] + 0.01 * rng.standard_normal((2000, 32)).astype(np.float32)
    fids = np.arange(5000, 7000)
    for e in (je, te):
        e.add_batch(fids, new)
    _snap_equal(je, te)
    assert te.incremental_count == je.incremental_count == 1
    ids = te.snapshot().ids.numpy()
    assert len({int(b) for b in np.nonzero(np.isin(ids, fids))[0]}) > 8


@pytest.mark.parametrize("op", ["remove", "upsert", "intra_batch_upsert", "growth", "spill"])
def test_full_rebuild_rules_as_jax(op):
    """Remove, upsert (against the index or within a batch), more than 2x growth since
    training and a spilled engine force a full rebuild, as in JAX."""
    je, te, rng = _pair(n0=128 if op == "growth" else 512, name=f"rebuild-{op}",
                        **({"spill": "auto"} if op == "spill" else {}))
    for e in (je, te):
        if op == "remove":
            assert e.remove(5)
            e.add(2000, np.ones(32, np.float32))
        elif op == "upsert":
            e.add(5, np.ones(32, np.float32))
        elif op == "intra_batch_upsert":
            e.add_batch(np.asarray([4000, 4000]), np.eye(2, 32, dtype=np.float32))
        elif op == "growth":
            e.add_batch(np.arange(5000, 5512), np.tile(np.eye(32, dtype=np.float32), (16, 1)))
        else:
            e.add_batch(np.arange(512, 520), np.eye(8, 32, dtype=np.float32))
        e.search(np.ones((1, 32), np.float32), k=4)
    assert te.incremental_count == je.incremental_count == 0
    assert te._trained_count == je._trained_count
    ids = te.snapshot().ids.numpy()
    assert te._snap.spilled == (op == "spill")
    if op in ("upsert", "intra_batch_upsert"):
        assert (ids == (5 if op == "upsert" else 4000)).sum() == 1


def test_ivf_engine_recall_near_jax():
    """End-to-end recall@10 of the port's IVF engine (its own build) within 0.03 of
    the JAX engine's on the same clustered data, and self-queries find themselves."""
    rng = _rng("ivf-recall")
    vecs = _geometry("clustered", rng)
    q = _normalize(vecs[rng.choice(N, 32, replace=False)] + 0.05 * rng.normal(size=(32, D)).astype(np.float32))
    exact = np.argsort(-(q @ vecs.T), axis=1)[:, :K]
    je, te = jve.IVFVectorEngine(dim=D), tve.IVFVectorEngine(dim=D, device="cpu")
    for e in (je, te):
        e.add_batch(np.arange(N), vecs)
    (_, jf), (_, tf) = je.search(q, K), te.search(q, K)
    rj, rt = _recall(jf, exact), _recall(tf, exact)
    assert abs(rt - rj) <= 0.03, (rt, rj)
    _, self_f = te.search(vecs[:8], 1)
    assert self_f[:, 0].tolist() == list(range(8))
    snap = te.snapshot()
    assert (snap.n_clusters, snap.bucket_size) == (154, 128)


def test_ivf_engine_random_interleaving_full_probe_exact():
    """After any interleaving of adds, removes, upserts and searches, a full-probe
    search equals the brute-force oracle over the live set (as tests/test_vector_engines.py)."""
    rng = _rng("interleave")
    e = tve.IVFVectorEngine(dim=16, n_clusters=4, device="cpu")
    live: dict[int, np.ndarray] = {}
    next_fid = 0
    for step in range(60):
        op = rng.random()
        if op < 0.55 or not live:
            v = rng.standard_normal(16).astype(np.float32)
            e.add(next_fid, v)
            live[next_fid] = v / np.linalg.norm(v)
            next_fid += 1
        elif op < 0.75:
            fid = int(rng.choice(list(live)))
            assert e.remove(fid)
            del live[fid]
        elif op < 0.85:
            fid = int(rng.choice(list(live)))
            v = rng.standard_normal(16).astype(np.float32)
            e.add(fid, v)
            live[fid] = v / np.linalg.norm(v)
        else:
            q = rng.standard_normal((2, 16)).astype(np.float32)
            e.nprobe = 4
            k = min(5, len(live))
            _, fids = e.search(q, k=k)
            ids = np.asarray(sorted(live))
            qn = q / np.linalg.norm(q, axis=1, keepdims=True)
            oracle = ids[np.argsort(-(qn @ np.stack([live[f] for f in ids]).T), axis=1)[:, :k]]
            for r in range(2):
                assert set(fids[r, :k].tolist()) == set(oracle[r].tolist()), step
    assert e.incremental_count > 0


def test_spilled_ivf_engine_dedups():
    rng = _rng("spilled-engine")
    centers = rng.standard_normal((16, 32)).astype(np.float32) * 3
    vecs = centers[rng.integers(0, 16, 4096)] + rng.standard_normal((4096, 32)).astype(np.float32)
    eng = tve.IVFVectorEngine(dim=32, n_clusters=16, spill="auto", device="cpu")
    eng.add_batch(np.arange(4096), vecs)
    _, fids = eng.search(vecs[:4], k=5)
    assert eng._snap.spilled
    for r in range(4):
        assert fids[r][0] == r
        live = fids[r][fids[r] >= 0]
        assert len(live) == len(set(live.tolist()))


@pytest.mark.parametrize("geometry", ["uniform", "clustered", "hard-clustered"])
def test_auto_routes_as_jax(geometry):
    """The same engine as JAX on each geometry, nprobe within one rung of JAX's, and
    end-to-end recall@10 >= 0.95 against the exact scan."""
    rng = _rng(geometry)
    vecs = _geometry(geometry, rng)
    ja = jve.AutoVectorEngine(dim=D, ann_rows=4000)
    ta = tve.AutoVectorEngine(dim=D, ann_rows=4000, device="cpu")
    exact = tve.FlatVectorEngine(dim=D, device="cpu")
    for e in (ja, ta, exact):
        e.add_batch(np.arange(N, dtype=np.int64), vecs)
    q = _normalize(vecs[rng.choice(N, 32, replace=False)] + 0.05 * rng.normal(size=(32, D)).astype(np.float32))
    ja.search(q, K)
    _, got = ta.search(q, K)
    _, ref = exact.search(q, K)
    js, ts = ja.stats(), ta.stats()
    assert ts["engine"] == js["engine"], (ts, js)
    if ts["engine"] == "ivf":
        ladder = list(tve._AUTO_NPROBE_LADDER)
        assert abs(ladder.index(ts["nprobe"]) - ladder.index(js["nprobe"])) <= 1, (ts, js)
        assert isinstance(ta._route(), tve.IVFVectorEngine)
    assert ts["measured_recall"] is not None and "reason" in ts
    assert _recall(got, ref) >= 0.95, (geometry, ts)


def test_auto_small_corpus_routes_to_flat():
    rng = _rng("small")
    auto = tve.AutoVectorEngine(dim=D, device="cpu")
    vecs = _normalize(rng.normal(size=(100, D)).astype(np.float32))
    auto.add_batch(np.arange(100), vecs)
    q = _normalize(rng.normal(size=(2, D)).astype(np.float32))
    _, got = auto.search(q, 5)
    stats = auto.stats()
    assert stats["engine"] == "flat" and "exact fused scan" in stats["reason"] and stats["measured_recall"] == 1.0
    flat = tve.FlatVectorEngine(dim=D, device="cpu")
    flat.add_batch(np.arange(100), vecs)
    np.testing.assert_array_equal(got, flat.search(q, 5)[1])
    assert auto.snapshot().capacity == flat.snapshot().capacity
    assert auto.snapshot_count == 1 and len(auto) == 100 and 5 in auto


def test_auto_unreachable_target_falls_back_to_exact():
    rng = _rng("unreachable")
    auto = tve.AutoVectorEngine(dim=D, ann_rows=1000, recall_target=1.5, device="cpu")
    vecs = _geometry("uniform", rng)[:2000]
    auto.add_batch(np.arange(2000), vecs)
    q = _normalize(rng.normal(size=(4, D)).astype(np.float32))
    _, got = auto.search(q, K)
    stats = auto.stats()
    assert stats["engine"] == "flat" and "serving the exact scan" in stats["reason"]
    exact = tve.FlatVectorEngine(dim=D, device="cpu")
    exact.add_batch(np.arange(2000), vecs)
    np.testing.assert_array_equal(got, exact.search(q, K)[1])


def test_auto_decision_taken_again_per_generation():
    rng = _rng("generation")
    auto = tve.AutoVectorEngine(dim=D, ann_rows=1000, device="cpu")
    auto.add_batch(np.arange(500), _normalize(rng.normal(size=(500, D)).astype(np.float32)))
    auto.search(_normalize(rng.normal(size=(1, D)).astype(np.float32)), 5)
    assert auto.stats()["engine"] == "flat"
    gen0 = auto._route_gen
    auto.add_batch(500 + np.arange(1500), _normalize(rng.normal(size=(1500, D)).astype(np.float32)))
    auto.search(_normalize(rng.normal(size=(1, D)).astype(np.float32)), 5)
    assert auto._route_gen != gen0
    assert auto.stats()["engine"] in ("ivf", "flat") and auto.stats()["measured_recall"] is not None


def test_auto_sample_queries_equal_jax():
    """The recall probe's queries: numpy draws on the builder's state, as JAX's."""
    rng = _rng("sample")
    vecs = _normalize(rng.normal(size=(300, D)).astype(np.float32))
    ja, ta = jve.AutoVectorEngine(dim=D), tve.AutoVectorEngine(dim=D, device="cpu")
    for e in (ja, ta):
        e.add_batch(np.arange(300), vecs)
        e.remove(7)
    np.testing.assert_array_equal(ta._sample_queries(np.random.default_rng(9)),
                                  ja._sample_queries(np.random.default_rng(9)))


def test_make_vector_engine():
    assert isinstance(tve.make_vector_engine("auto", dim=8, device="cpu"), tve.AutoVectorEngine)
    assert isinstance(tve.make_vector_engine("flat", dim=8, device="cpu"), tve.FlatVectorEngine)
    eng = tve.make_vector_engine("ivf", dim=8, device="cpu", nprobe=3, bucket_dtype=torch.bfloat16)
    assert isinstance(eng, tve.IVFVectorEngine) and eng.nprobe == 3 and eng.kind == "ivf"
    eng = tve.make_vector_engine("hnsw", dim=8, device="cpu", m=4, ef_search=24)
    assert isinstance(eng, tve.HNSWVectorEngine) and eng.kind == "hnsw" and eng.ef_search == 24
    assert eng.builder.m == 4 and eng.device == torch.device("cpu")
    with pytest.raises(NotImplementedError, match="queue 1, item 5"):
        tve.make_vector_engine("sharded", dim=8, device="cpu")
    with pytest.raises(ValueError, match="unknown"):
        tve.make_vector_engine("metal", dim=8, device="cpu")
    assert tve.AUTO_ANN_ROWS == jve.AUTO_ANN_ROWS and tve.AUTO_RECALL_TARGET == jve.AUTO_RECALL_TARGET
    assert tve._AUTO_NPROBE_LADDER == jve._AUTO_NPROBE_LADDER
    assert (tve._AUTO_SAMPLE_Q, tve._AUTO_SAMPLE_K) == (jve._AUTO_SAMPLE_Q, jve._AUTO_SAMPLE_K)


def test_hybrid_engine_vector_preference():
    """HybridSearchEngine's default is "auto"; below ann_rows it serves the flat
    engine's results; "ivf" and "hnsw" build their engines on the engine's device;
    "sharded" is not ported yet."""
    rng = _rng("hybrid")
    vecs = _normalize(rng.normal(size=(700, D)).astype(np.float32))
    q = _normalize(rng.normal(size=(5, D)).astype(np.float32))
    engines = {p: HybridSearchEngine(None, dim=D, device="cpu", vector_preference=p) for p in ("auto", "flat")}
    engines["default"] = HybridSearchEngine(None, dim=D, device="cpu")
    engines["ivf"] = HybridSearchEngine(None, dim=D, device="cpu", vector_preference="ivf",
                                        vector_kwargs={"n_clusters": 4, "nprobe": 4})
    engines["hnsw"] = HybridSearchEngine(None, dim=D, device="cpu", vector_preference="hnsw",
                                         vector_kwargs={"m": 8, "ef_construction": 60})
    for e in engines.values():
        e.index_embedding_batch(np.arange(700), vecs)
    assert isinstance(engines["default"].vector, tve.AutoVectorEngine)
    fv, ff = engines["flat"].vector.search(q, K)
    for p in ("auto", "default"):
        av, af = engines[p].vector.search(q, K)
        np.testing.assert_array_equal(af, ff)
        np.testing.assert_array_equal(av, fv)
        assert engines[p].vector.stats()["engine"] == "flat"
    iv, if_ = engines["ivf"].vector.search(q, K)  # 4 of 4 buckets probed: exact
    np.testing.assert_array_equal(if_, ff)
    assert engines["ivf"].vector.device == torch.device("cpu")
    hv, hf = engines["hnsw"].vector.search(q, K)  # a 700-row graph at ef 64: the exact top-k
    assert engines["hnsw"].vector.kind == "hnsw" and engines["hnsw"].vector.snapshot().device == torch.device("cpu")
    np.testing.assert_array_equal(hf, ff)
    np.testing.assert_allclose(hv, fv, rtol=1e-6)
    with pytest.raises(NotImplementedError, match="item 5"):
        HybridSearchEngine(None, dim=D, device="cpu", vector_preference="sharded")
    jeng = JaxHybrid(None, dim=D)
    jeng.vector.add_batch(np.arange(700), vecs)
    jv, jf = jeng.vector.search(q, K)
    assert jeng.vector.kind == engines["default"].vector.kind == "auto"
    np.testing.assert_array_equal(ff, jf)
    np.testing.assert_allclose(fv, jv, rtol=1e-6)
