"""The sharded BM25 lane and the fused hybrid program over many corpus shards.

Both packages index the same 2,048 documents (exact postings, and a budget of 40
postings per term, so the forward index, the rescore and the impact chunks are in
play) and the same exact-arithmetic vectors (entries k/4, every product exact in f32).
The port runs on eight logical CPU shards (`["cpu"] * 8`), JAX on its eight virtual
CPU devices, over the flat 8, 2 x 4, 4 x 2 and 2 x 2 x 2 meshes:

* `shard_lex_index`: every shard's arrays EQUAL to JAX's shard's;
* `sharded_bm25_topk` in `any` and `all` modes, exact and budgeted, through the plain
  harness ("candidates") and the kernels' lane ("candidates_pallas": K4 then K3 on a
  budgeted store, K8 on an exact one; their plain twins here, JAX's kernels in
  interpret mode): frame ids equal, scores within rtol 1e-6;
* `sharded_hybrid_topk` with each dense branch a shard's local rows select (blockmax,
  K1's select, chunkmax K6 + K7 with the thresholds lowered): fused frame ids and
  scores EQUAL to JAX's;
* every mesh shape: the port's answer equals its flat mesh's bit for bit (JAX's
  interpret-mode kernels are slow on eight shards, so they run on the flat mesh).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index.dense import DenseIndexBuilder as JaxDense
from wax_tpu.index.dense import Similarity
from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu.ops.bm25 import pad_term_ids
from wax_tpu.parallel import mesh as jmesh
from wax_tpu.parallel import sharded_hybrid as jsh
from wax_tpu.parallel.sharded_scan import shard_dense_index as jax_shard_dense
from wax_tpu_torch.index.dense import DenseIndexBuilder as TorchDense
from wax_tpu_torch.index.lex import LexIndexBuilder as TorchLex
from wax_tpu_torch.ops import chunkmax_scan
from wax_tpu_torch.parallel import mesh as tmesh
from wax_tpu_torch.parallel import sharded_hybrid as tsh
from wax_tpu_torch.parallel.sharded_scan import shard_dense_index as torch_shard_dense

TOPICS = ["fox", "quantum", "market", "recipe", "rover", "cat", "river", "music"]
N, D, BUDGET = 2048, 32, 40
QUERIES = ["quantum domain detail", "fox river", "market 3", "music rover cat detail", "recipe",
           "nothing here", "cat fox quantum market river", "detail 5 domain"]
CPU8 = ["cpu"] * 8
MESHES = {
    "flat8": (lambda: jmesh.data_mesh(8), lambda: tmesh.data_mesh(CPU8)),
    "2x4": (lambda: jmesh.make_two_level_mesh(2, 4), lambda: tmesh.make_two_level_mesh(2, 4, devices=CPU8)),
    "4x2": (lambda: jmesh.make_two_level_mesh(4, 2), lambda: tmesh.make_two_level_mesh(4, 2, devices=CPU8)),
    "2x2x2": (lambda: jmesh.make_two_level_mesh(2, 4, tp=2),
              lambda: tmesh.make_two_level_mesh(2, 4, tp=2, devices=CPU8)),
}


def _docs(n=N):
    rng = np.random.default_rng(5)
    out = []
    for i in range(n):
        words = [TOPICS[i % 8], TOPICS[(i * 7) % 8], "domain" if i % 3 else "detail", str(i % 11)]
        words += list(rng.choice(TOPICS, int(rng.integers(0, 4))))
        out.append((i, " ".join(words)))
    return out


def _vecs(n, seed):
    return (np.random.default_rng(seed).integers(-4, 5, (n, D)) / 4.0).astype(np.float32)


@pytest.fixture(scope="module")
def built():
    out = {}
    for budget in (None, BUDGET):
        jl, tl = JaxLex(postings_budget=budget), TorchLex(postings_budget=budget)
        jl.add_batch(_docs())
        tl.add_batch(_docs())
        out[budget] = (jl, tl)
    return out


def _term_ids(lex):
    return np.stack([pad_term_ids(lex.query_term_ids(q), max_terms=16) for q in QUERIES])


@pytest.mark.parametrize("budget", [None, BUDGET], ids=["exact", "budgeted"])
def test_shard_lex_index_every_shard_equal(built, budget):
    jl, tl = built[budget]
    jm, tm = MESHES["2x4"][0](), MESHES["2x4"][1]()
    js, ts = jsh.shard_lex_index(jl, jm, N), tsh.shard_lex_index(tl, tm, N)
    assert len(ts.doc_len) == 8 and ts.n_local == N // 8
    offs = np.asarray(js.offsets)
    for s in range(8):
        p = int(offs[s, -1])
        for f in ("doc_rows", "tfs", "wnorm"):
            np.testing.assert_array_equal(getattr(ts, f)[s].numpy()[:p], np.asarray(getattr(js, f))[s, :p],
                                          err_msg=f"{f} shard {s}")
        for f in ("offsets", "idf", "doc_len", "frame_ids", "live", "row_base", "fwd_tids", "fwd_wnorm",
                  "fwd_fused", "pk_chunks", "chunk_base", "chunk_counts"):
            j, t = getattr(js, f), getattr(ts, f)
            assert (j is None) == (t is None), f
            if j is not None:
                np.testing.assert_array_equal(t[s].numpy(), np.asarray(j)[s], err_msg=f"{f} shard {s}")
    for f in ("max_df", "pk_qb", "pk_max_chunks", "fwd_width"):
        assert getattr(ts, f) == getattr(js, f), f


def _same_as_flat(run, name, want):
    """The port's answer on mesh `name` equals its flat mesh's of as many corpus
    shards (8; 4 for 2 x 2 x 2, whose tp planes replicate) bit for bit."""
    tm = MESHES[name][1]()
    flat = tmesh.data_mesh(["cpu"] * tm.corpus_shards)
    got, ref = run(tm), (want if tm.corpus_shards == 8 else run(flat))
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1]), name


@pytest.mark.parametrize("mode", ["any", "all"])
@pytest.mark.parametrize("budget,backend,name,nq", [(None, "candidates", "flat8", 8), (BUDGET, "candidates", "2x4", 8),
                                                    (None, "candidates_pallas", "flat8", 4),
                                                    (BUDGET, "candidates_pallas", "flat8", 4)],
                         ids=["exact", "budgeted", "exact-kernels", "budgeted-kernels"])
def test_sharded_bm25_equals_jax(built, mode, budget, backend, name, nq):
    """Scores within rtol 1e-6 at k 24 (more than a shard's hits for several queries:
    the merge pads) and frame ids equal. K8 sums a row in query-slot order, the TPU
    kernel in merge-network order, so on the exact store with the kernels the ids are
    held to JAX's deeper list with scores within rtol 1e-6 taken as one tie, broken by
    the lowest id. JAX's kernels run in interpret mode, slowly on eight shards: their
    cases take the first 4 queries. Every mesh shape answers as its flat mesh."""
    jl, tl = built[budget]
    jm, tm = MESHES[name][0](), MESHES[name][1]()
    js, ts = jsh.shard_lex_index(jl, jm, N), tsh.shard_lex_index(tl, tm, N)
    tids = _term_ids(tl)[:nq]
    k = 24
    tied = budget is None and backend == "candidates_pallas"
    jv, jf = jsh.sharded_bm25_topk(jnp.asarray(tids), js, k + 64 if tied else k, jm, mode=mode, backend=backend)
    tv, tf = tsh.sharded_bm25_topk(torch.from_numpy(tids), ts, k, tm, mode=mode, backend=backend)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv)[:, :k], rtol=1e-6, atol=0)
    np.testing.assert_array_equal(tf.numpy(), _lowest_row_on_ties(jv, jf, k) if tied else np.asarray(jf))
    assert (tf.numpy() >= 0).any()

    def run(m):
        return tsh.sharded_bm25_topk(torch.from_numpy(tids), tsh.shard_lex_index(tl, m, N), k, m, mode=mode,
                                     backend=backend)

    want = (tv, tf) if name == "flat8" else run(tmesh.data_mesh(CPU8))
    for other in MESHES:
        _same_as_flat(run, other, want)


def _lowest_row_on_ties(vals, fids, k, rtol=1e-6):
    """The first k of a ranked list once scores within `rtol` of their neighbour are
    taken as one tie, broken by the lowest id (frame id == row in these stores)."""
    vals, fids = np.asarray(vals), np.asarray(fids)
    out = np.full((vals.shape[0], k), -1, np.int32)
    for i in range(vals.shape[0]):
        group, key = 0, []
        for j in range(vals.shape[1]):
            if fids[i, j] < 0:
                break
            if j and abs(vals[i, j] - vals[i, j - 1]) > rtol * abs(vals[i, j - 1]):
                group += 1
            key.append((group, fids[i, j]))
        ranked = [f for _, f in sorted(key)][:k]
        out[i, : len(ranked)] = ranked
    return out


def _dense(n, mesh_pair):
    """The same exact-arithmetic rows laid out on (JAX mesh, port mesh); None skips
    a side."""
    jm, tm = mesh_pair
    vecs = _vecs(n, 1)
    out = []
    for m, builder, shard in ((jm, JaxDense, jax_shard_dense), (tm, TorchDense, torch_shard_dense)):
        if m is None:
            out.append(None)
            continue
        b = builder(D, Similarity.DOT)
        b.add_batch(np.arange(n), vecs)
        out.append(shard(b.snapshot() if builder is JaxDense else b.snapshot(device="cpu"), m))
    return tuple(out)


@pytest.mark.parametrize("budget,lex_backend,branch,jax_meshes", [
    (BUDGET, "auto", "blockmax", ("flat8", "2x4")), (None, "auto", "blockmax", ("flat8",)),
    (BUDGET, "auto", "selkernel", ("flat8",)), (BUDGET, "candidates_pallas", "blockmax", ("flat8",))],
    ids=["budgeted", "exact", "budgeted-selkernel", "budgeted-kernels"])
def test_sharded_hybrid_equals_jax(built, monkeypatch, budget, lex_backend, branch, jax_meshes):
    """256 local rows a shard: blockmax, or K1's select with its threshold at 256.
    Fused ids and scores equal to JAX's on the meshes named (JAX's interpret-mode
    kernels are slow on eight shards); on every mesh the port answers as its flat
    mesh of as many shards, bit for bit."""
    jl, tl = built[budget]
    if branch == "selkernel":
        for mod in (jsh, tsh):
            monkeypatch.setattr(mod, "_SELKERNEL_MIN_LOCAL_ROWS", 256)
    q, tids = _vecs(len(QUERIES), 2), _term_ids(tl)

    def run(tm):
        _, tdn = _dense(N, (None, tm))
        return tsh.sharded_hybrid_topk(torch.from_numpy(q), torch.from_numpy(tids), tdn,
                                       tsh.shard_lex_index(tl, tm, N), 10, tm, lex_backend=lex_backend)

    for name in jax_meshes:
        jm, tm = MESHES[name][0](), MESHES[name][1]()
        jdn, _ = _dense(N, (jm, None))
        jv, jf = jsh.sharded_hybrid_topk(jnp.asarray(q), jnp.asarray(tids), jdn, jsh.shard_lex_index(jl, jm, N), 10,
                                         jm, lex_backend=lex_backend)
        tv, tf = run(tm)
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf), err_msg=name)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv), err_msg=name)
    want = run(tmesh.data_mesh(CPU8))
    assert (want[1].numpy()[:, 0] >= 0).all()
    for name in MESHES:
        _same_as_flat(run, name, want)


def test_sharded_hybrid_chunkmax_on_two_shards(built, monkeypatch):
    """The chunkmax branch (K6 + K7's twins) needs 2,048-row-aligned local rows: two
    shards of 2,048 rows over 4,096 documents, thresholds at 2,048. Fused ids and
    scores equal to JAX's on its 2-device mesh."""
    jl, tl = JaxLex(postings_budget=BUDGET), TorchLex(postings_budget=BUDGET)
    docs = _docs(4096)
    jl.add_batch(docs)
    tl.add_batch(docs)
    monkeypatch.setattr(jsh, "_CHUNKMAX_MIN_LOCAL_ROWS", 2048)
    monkeypatch.setattr(chunkmax_scan, "_MIN_ROWS", 2048)
    jm, tm = jmesh.data_mesh(2), tmesh.data_mesh(["cpu"] * 2)
    jdn, tdn = _dense(4096, (jm, tm))
    assert tdn.contiguous and tdn.local_rows == 2048
    q, tids = _vecs(len(QUERIES), 3), _term_ids(tl)
    jv, jf = jsh.sharded_hybrid_topk(jnp.asarray(q), jnp.asarray(tids), jdn, jsh.shard_lex_index(jl, jm, 4096), 10, jm)
    tv, tf = tsh.sharded_hybrid_topk(torch.from_numpy(q), torch.from_numpy(tids), tdn,
                                     tsh.shard_lex_index(tl, tm, 4096), 10, tm)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
