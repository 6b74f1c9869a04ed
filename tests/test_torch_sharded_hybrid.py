"""The one-device sharded programs and the engine's BM25 lane dispatch against wax_tpu.

Both packages index the same 2,048 documents (a budget of 40 postings per term
truncates the frequent terms, so the forward index, the exact rescore and the impact
chunks are in play) and the same exact-arithmetic vectors (entries k/4 in [-1, 1], so
every dot product is exact in f32). On a one-device mesh:

* `shard_lex_index`: every array EQUAL (postings over the JAX shard's live prefix).
* `sharded_bm25_topk`: in tests/test_torch_sharded_hybrid_bm25.py, on this file's
  stores (the `built` fixture).
* `sharded_hybrid_topk` with the thresholds lowered so that each dense branch runs
  (blockmax, the packed-key select kernel K1, chunkmax K6 + K7), with both BM25
  backends: fused frame ids EQUAL and fused scores EQUAL (RRF of equal rankings).
* `search.unified._bm25_run` over `HybridSearchEngine`s with the same budget, in each
  of its three lanes (scatter, budgeted candidates, sharded), and the engine path as a
  whole (vector lane + BM25 lane + host RRF).
"""
import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index.dense import DenseIndexBuilder as JaxDense
from wax_tpu.index.dense import Similarity
from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu.ops.bm25 import pad_term_ids
from wax_tpu.parallel import sharded_hybrid as jsh
from wax_tpu.parallel.mesh import data_mesh as jax_mesh
from wax_tpu.parallel.sharded_scan import shard_dense_index as jax_shard_dense
from wax_tpu_torch.index.dense import DenseIndexBuilder as TorchDense
from wax_tpu_torch.index.lex import LexIndexBuilder as TorchLex
from wax_tpu_torch.parallel import sharded_hybrid as tsh
from wax_tpu_torch.parallel.mesh import data_mesh as torch_mesh
from wax_tpu_torch.parallel.sharded_scan import shard_dense_index as torch_shard_dense

TOPICS = ["fox", "quantum", "market", "recipe", "rover", "cat", "river", "music"]
N, D, BUDGET = 2048, 32, 40
QUERIES = ["quantum domain detail", "fox river", "market 3", "music rover cat detail", "recipe",
           "nothing here", "cat fox quantum market river", "detail 5 domain"]


def _docs():
    rng = np.random.default_rng(5)
    out = []
    for i in range(N):
        words = [TOPICS[i % 8], TOPICS[(i * 7) % 8], "domain" if i % 3 else "detail", str(i % 11)]
        words += list(rng.choice(TOPICS, int(rng.integers(0, 4))))
        out.append((i, " ".join(words)))
    return out


def _vecs(n, seed):
    return (np.random.default_rng(seed).integers(-4, 5, (n, D)) / 4.0).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    docs = _docs()
    out = {}
    for budget in (None, BUDGET):
        jl, tl = JaxLex(postings_budget=budget), TorchLex(postings_budget=budget)
        jl.add_batch(docs)
        tl.add_batch(docs)
        out[budget] = (jl, tl)
    jd, td = JaxDense(D, Similarity.DOT), TorchDense(D, Similarity.DOT)
    vecs = _vecs(N, 1)
    jd.add_batch(np.arange(N), vecs)
    td.add_batch(np.arange(N), vecs)
    return out, (jd, td)


def _term_ids(lex, queries=QUERIES):
    return np.stack([pad_term_ids(lex.query_term_ids(q), max_terms=16) for q in queries])


@pytest.mark.parametrize("budget", [None, BUDGET])
def test_shard_lex_index_arrays_equal(built, budget):
    jl, tl = built[0][budget]
    js = jsh.shard_lex_index(jl, jax_mesh(1), N)
    ts = tsh.shard_lex_index(tl, torch_mesh("cpu"), N)
    p = int(np.asarray(js.offsets)[0, -1])

    def stacked(x):  # the port's per-shard tuple as JAX's [S, ...] array
        return torch.stack(x).numpy() if isinstance(x, tuple) else x.numpy()

    for f in ("doc_rows", "tfs", "wnorm"):
        np.testing.assert_array_equal(stacked(getattr(ts, f))[:, :p], np.asarray(getattr(js, f))[:, :p], err_msg=f)
        assert stacked(getattr(ts, f)).shape[1] >= p
    for f in ("offsets", "idf", "doc_len", "frame_ids", "live", "row_base", "avgdl", "fwd_tids", "fwd_wnorm",
              "fwd_fused", "pk_chunks", "chunk_base", "chunk_counts"):
        j, t = getattr(js, f), getattr(ts, f)
        assert (j is None) == (t is None), f
        if j is not None:
            np.testing.assert_array_equal(stacked(t), np.asarray(j), err_msg=f)
    for f in ("max_df", "pk_qb", "pk_max_chunks", "fwd_width"):
        assert getattr(ts, f) == getattr(js, f), f
    assert (ts.fwd_fused is not None) == (budget is not None)


def test_unchunked_kernel_lane_raises_naming_k8(built):
    """An unbudgeted snapshot has no impact chunks: its kernel lane is K8 (the plain
    twin here), which once raised naming K8 and now equals the JAX package's K8 lane,
    candidates and whole planes alike; an unknown backend still raises."""
    jl, tl = built[0][None]
    js, ts = jsh.shard_lex_index(jl, jax_mesh(1), N), tsh.shard_lex_index(tl, torch_mesh("cpu"), N)
    tids = _term_ids(tl)
    jr, jsc = jsh.candidate_scores_pallas(jnp.asarray(tids), js.doc_rows[0], js.wnorm[0], js.offsets[0],
                                          js.idf[0], js.doc_rows_rev[0], js.wnorm_rev[0], max_df=js.max_df)
    tr, tsc = tsh.candidate_scores_pallas(torch.from_numpy(tids), ts.doc_rows[0], ts.wnorm[0], ts.offsets[0],
                                          ts.idf[0], max_df=ts.max_df)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tsc.numpy(), np.asarray(jsc), rtol=1e-6, atol=0)
    with pytest.raises(ValueError, match="unknown BM25 backend"):
        tsh.sharded_bm25_topk(torch.zeros((1, 16), dtype=torch.int32), ts, 5, torch_mesh("cpu"),
                              backend="scatter")


def test_resolve_lex_backend_decides_on_the_device(built):
    """CPU postings take the plain harness; CUDA postings resolve as the TPU does,
    including its plane guard (the tensor's device is all the rule reads)."""
    ts = tsh.shard_lex_index(built[0][BUDGET][1], torch_mesh("cpu"), N)
    assert tsh._resolve_lex_backend(ts, "auto") == "candidates"
    on_card = dataclasses.replace(ts, doc_rows=(types.SimpleNamespace(device=torch.device("cuda")),))
    assert tsh._resolve_lex_backend(on_card, "auto", q2=16) == "candidates_pallas"
    assert tsh._resolve_lex_backend(dataclasses.replace(on_card, max_df=200_000), "auto", q2=16) == "candidates"
    assert tsh._resolve_lex_backend(on_card, "auto", q2=16 * 1024) == "candidates"
    assert tsh._resolve_lex_backend(ts, "candidates_pallas") == "candidates_pallas"
    assert tsh._PALLAS_MAX_PLANE_ELEMS == jsh._PALLAS_MAX_PLANE_ELEMS
    assert (tsh._CHUNKMAX_MIN_LOCAL_ROWS, tsh._SELKERNEL_MIN_LOCAL_ROWS) == (
        jsh._CHUNKMAX_MIN_LOCAL_ROWS, jsh._SELKERNEL_MIN_LOCAL_ROWS)


@pytest.mark.parametrize("budget,lex_backend", [pytest.param(BUDGET, "auto", id="auto"),
                                                pytest.param(BUDGET, "candidates_pallas", id="candidates_pallas"),
                                                pytest.param(None, "candidates_pallas", id="exact-candidates_pallas")])
@pytest.mark.parametrize("branch", ["blockmax", "selkernel", "chunkmax"])
def test_sharded_hybrid_topk_equal(built, monkeypatch, branch, budget, lex_backend):
    jl, tl = built[0][budget]
    jd, td = built[1]
    if branch == "chunkmax":
        for mod in (jsh, tsh):
            monkeypatch.setattr(mod, "_CHUNKMAX_MIN_LOCAL_ROWS", 1024)
    if branch == "selkernel":
        for mod in (jsh, tsh):
            monkeypatch.setattr(mod, "_SELKERNEL_MIN_LOCAL_ROWS", 1024)
    jm, tm = jax_mesh(1), torch_mesh("cpu")
    jdsnap, tdsnap = jd.snapshot(), td.snapshot(device="cpu")
    assert tdsnap.capacity == N and tdsnap.contiguous
    jdn, tdn = jax_shard_dense(jdsnap, jm), torch_shard_dense(tdsnap, tm)
    jls, tls = jsh.shard_lex_index(jl, jm, N), tsh.shard_lex_index(tl, tm, N)
    q = _vecs(len(QUERIES), 2)
    tids = _term_ids(tl)
    for k in (5, 10):
        jv, jf = jsh.sharded_hybrid_topk(jnp.asarray(q), jnp.asarray(tids), jdn, jls, k, jm,
                                         lex_backend=lex_backend)
        tv, tf = tsh.sharded_hybrid_topk(torch.from_numpy(q), torch.from_numpy(tids), tdn, tls, k, tm,
                                         lex_backend=lex_backend)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tf.numpy()[:, 0] >= 0).all()


# ----------------------------------------------------------------------- the engine


@pytest.fixture(scope="module")
def engines(built, tmp_path_factory):
    import os

    from wax_tpu.search.engine import HybridSearchEngine as JaxEngine
    from wax_tpu_torch.search.engine import HybridSearchEngine

    # the JAX lanes would persist executables: keep them out of the suite's cache
    before = os.environ.get("WAX_TPU_DISABLE_AOT")
    os.environ["WAX_TPU_DISABLE_AOT"] = "1"
    docs, vecs = _docs(), _vecs(N, 1)
    out = {}
    for name, budget, sharded in (("scatter", None, False), ("candidates", BUDGET, False),
                                  ("sharded", BUDGET, True)):
        je = JaxEngine(None, dim=D, similarity=Similarity.DOT, vector_preference="flat", lex_sharded=sharded,
                       mesh=jax_mesh(1) if sharded else None, lex_postings_budget=budget)
        te = HybridSearchEngine(None, dim=D, similarity=Similarity.DOT, device="cpu", lex_sharded=sharded,
                                lex_postings_budget=budget)
        for e in (je, te):
            for fid, text in docs:
                e.index_text(fid, text)
            e.index_embedding_batch(np.arange(N), vecs)
        out[name] = (je, te)
    yield out
    if before is None:
        os.environ.pop("WAX_TPU_DISABLE_AOT", None)
    else:
        os.environ["WAX_TPU_DISABLE_AOT"] = before


@pytest.mark.parametrize("mode", ["any", "all"])
@pytest.mark.parametrize("lane", ["scatter", "candidates", "sharded"])
def test_bm25_run_lanes_equal(engines, lane, mode):
    from wax_tpu.search.unified import _bm25_run as jax_run
    from wax_tpu_torch.search.unified import _bm25_run

    je, te = engines[lane]
    tids = _term_ids(te.lex)
    jv, jf = jax_run(je, jnp.asarray(tids), 24, mode)
    tv, tf = _bm25_run(te, torch.from_numpy(tids), 24, mode)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert (te.lex_snapshot().fwd_fused is not None) == (lane != "scatter")


def test_engine_path_fused_lists_equal(engines):
    """The whole path at small size: vector lane, budgeted BM25 lane and host RRF
    give the same fused frame ids and scores in both packages."""
    from wax_tpu.ops.fusion import rrf_fuse as jax_rrf
    from wax_tpu.search.unified import _bm25_run as jax_run
    from wax_tpu_torch.ops.fusion import rrf_fuse
    from wax_tpu_torch.search.unified import _bm25_run

    je, te = engines["candidates"]
    q = _vecs(len(QUERIES), 3)
    tids = _term_ids(te.lex)
    jvv, jvf = je.vector.search(q, 24)
    tvv, tvf = te.vector.search(q, 24)
    np.testing.assert_array_equal(tvf, jvf)
    np.testing.assert_array_equal(tvv, jvv)
    jbv, jbf = (np.asarray(x) for x in jax_run(je, jnp.asarray(tids), 24, "any"))
    tbv, tbf = (x.numpy() for x in _bm25_run(te, torch.from_numpy(tids), 24, "any"))
    weights = {"bm25": 0.5, "vector": 0.5}
    for i in range(len(QUERIES)):
        def lanes(vv, vf, bv, bf):
            return {"bm25": [(int(f), float(v)) for f, v in zip(bf[i], bv[i]) if f >= 0],
                    "vector": [(int(f), float(v)) for f, v in zip(vf[i], vv[i]) if f >= 0]}
        want = [(h.frame_id, h.score) for h in jax_rrf(lanes(jvv, jvf, jbv, jbf), weights)]
        got = [(h.frame_id, h.score) for h in rrf_fuse(lanes(tvv, tvf, tbv, tbf), weights)]
        assert got == want and got
