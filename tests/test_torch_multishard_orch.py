"""The orchestrator's sharded lanes over many corpus shards, against wax_tpu's.

JAX's `OrchestratorConfig(sharded_lanes=True)` serves both device lanes over its
eight virtual CPU devices (the BM25 lane by the sharded program, the vector lane by
the mesh-sharded flat engine); the port's over eight logical CPU shards
(`device=["cpu"] * 8`). Both ingest the same notes with the same HashEmbedder and
clock, and each search must give equal `SearchResponse`s (frame ids, scores within
rtol 1e-6, previews, sources, lane counts) on the flat mesh, the two-level 2 x 4 mesh
(`mesh_slices=2`, which answers as the flat mesh) and 2 x 2 x 2 (`mesh_tp=2`).
A reopen under another topology does not reclaim the old engine, and a `sharded`
vector segment crosses between the packages both ways.
"""
import itertools

import numpy as np
import pytest
import torch

import wax_tpu.embed.hash_embedder as jax_hash
import wax_tpu.orchestrator as jax_orch
import wax_tpu.search.engine_cache as jax_cache
import wax_tpu_torch.embed.hash_embedder as port_hash
import wax_tpu_torch.orchestrator as port_orch
import wax_tpu_torch.search.engine_cache as port_cache
from wax_tpu_torch.parallel.mesh import data_mesh, make_two_level_mesh
from wax_tpu_torch.search.vector_engines import ShardedFlatVectorEngine

CPU8 = ["cpu"] * 8
T0 = 1_700_000_000_000
PKGS = {"jax": (jax_orch, jax_hash, jax_cache), "port": (port_orch, port_hash, port_cache)}
QUERIES = ["document about topic 3", "color 2 document", "topic 6 color 4", "river cabin", "topic 1 OR color 3"]
TOPOLOGIES = {
    "unsharded": {},
    "flat": {"sharded_lanes": True},
    "2slices": {"sharded_lanes": True, "mesh_slices": 2},
    "2x2xtp2": {"sharded_lanes": True, "mesh_slices": 2, "mesh_tp": 2},
}


def _config(pkg, **kw):
    clock = itertools.count(T0, 60_000)
    return PKGS[pkg][0].OrchestratorConfig(clock_ms=lambda: next(clock), **kw)


def _open(pkg, path, **cfg):
    orch, hashing, _ = PKGS[pkg]
    kw = {}
    if pkg == "port":
        kw["device"] = CPU8 if cfg.get("sharded_lanes") else "cpu"
    return orch.MemoryOrchestrator(path, hashing.HashEmbedder(64), _config(pkg, **cfg), **kw)


def _build(pkg, path, **cfg):
    o = _open(pkg, path, **cfg)
    for i in range(60):
        o.remember(f"document {i} about topic {i % 7} and color {i % 5}" + (" near the river cabin" if i % 9 == 0 else ""))
    o.flush()
    o.remember("a late note about the river cabin, left in the WAL")
    return o


def _assert_same(a, b) -> None:
    assert a.query_type.value == b.query_type.value and a.lane_counts == b.lane_counts
    assert [h.frame_id for h in a.hits] == [h.frame_id for h in b.hits]
    np.testing.assert_allclose([h.score for h in b.hits], [h.score for h in a.hits], rtol=1e-6, atol=0)
    assert [h.preview for h in a.hits] == [h.preview for h in b.hits]
    assert [tuple(s.value for s in h.sources) for h in a.hits] == [tuple(s.value for s in h.sources) for h in b.hits]


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    """Both packages' orchestrators in every topology, over the same ingest."""
    tmp = tmp_path_factory.mktemp("topo")
    out = {}
    for name, cfg in TOPOLOGIES.items():
        out[name] = {pkg: _build(pkg, tmp / f"{pkg}-{name}.mv2s", **cfg) for pkg in PKGS}
    yield out
    for pair in out.values():
        for o in pair.values():
            o.close()
    jax_cache.clear()
    port_cache.clear()


@pytest.mark.parametrize("name", list(TOPOLOGIES))
def test_topology_answers_equal_jax(served, name):
    """Each topology's search and recall equal JAX's same config; the two-level mesh
    answers as the flat mesh of the same eight shards."""
    jo, po = served[name]["jax"], served[name]["port"]
    for q in QUERIES:
        got = po.search(q)
        _assert_same(jo.search(q), got)
        if name == "2slices":
            _assert_same(served["flat"]["port"].search(q), got)
        assert po.recall(q).render() == jo.recall(q).render()
    if name != "unsharded":
        assert po.engine.vector.kind == jo.engine.vector.kind == "sharded"
        assert isinstance(po.engine.vector, ShardedFlatVectorEngine)
        assert po.engine.lex_sharded and po.engine.vector.mesh is po.engine.mesh
        assert po.engine.mesh.axis_names == tuple(jo.engine.mesh.axis_names)
        assert po.engine.mesh.corpus_shards == {"flat": 8, "2slices": 8, "2x2xtp2": 4}[name]
        assert po.engine.device == torch.device("cpu")


def test_reclaim_rejects_topology_change(tmp_path):
    """Closing under the flat mesh and reopening with mesh_slices=2 must not serve the
    parked engine's layout from the engine cache."""
    p = tmp_path / "m.mv2s"
    o1 = _build("port", p, sharded_lanes=True)
    flat_mesh = o1.engine.vector.mesh
    want = [o1.search(q) for q in QUERIES]
    o1.close()
    o2 = _open("port", p, sharded_lanes=True, mesh_slices=2)
    try:
        assert o2.engine.vector.mesh != flat_mesh and "slice" in o2.engine.vector.mesh.axis_names
        assert o2.engine.vector.mesh == make_two_level_mesh(2, devices=CPU8)
        for a, q in zip(want, QUERIES):
            _assert_same(a, o2.search(q))
    finally:
        o2.close()
        port_cache.clear()


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")])
def test_sharded_segment_crosses_packages(tmp_path, writer, reader):
    """A store served by the mesh-sharded engine (a `sharded` vector segment plus a WAL
    tail) opens in the other package under the same config as a sharded engine on the
    reader's mesh, with equal answers."""
    w = _build(writer, tmp_path / "m.mv2s", sharded_lanes=True, mesh_slices=2)
    w.flush()
    assert w.store.toc.manifests["vec"].attrs["engine"] == "sharded"
    want = [w.search(q) for q in QUERIES]
    w.close()
    PKGS[writer][2].clear()
    r = _open(reader, tmp_path / "m.mv2s", sharded_lanes=True)
    try:
        assert r.engine.vector.kind == "sharded"
        if reader == "port":
            assert isinstance(r.engine.vector, ShardedFlatVectorEngine) and r.engine.vector.mesh == data_mesh(CPU8)
        for a, q in zip(want, QUERIES):
            _assert_same(a, r.search(q))
    finally:
        r.close()
        PKGS[reader][2].clear()
