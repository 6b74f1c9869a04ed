"""Corpus-sharded serving over device meshes against wax_tpu's 8-device CPU mesh.

The port's meshes here are eight logical shards on the CPU (`["cpu"] * 8`), laid out
as JAX's are on its eight virtual CPU devices (tests/conftest.py): flat ("data",) 8,
("slice", "data") 2 x 4 and 4 x 2, and ("slice", "data", "tp") 2 x 2 x 2. The same
numpy inputs go through both packages:

* meshes: axes, shard counts and the ValueErrors of shapes that do not divide;
* the merge: JAX's tie order (slice, data shard, local order), two-level = flat;
* `sharded_flat_scan_topk`: frame ids equal and scores within rtol 1e-6 on random
  data, bit-equal on exact-arithmetic data (entries k/4), uneven row counts included;
  its chunkmax route (K6 + K7's twins, the row floor lowered) on every mesh, and the
  shards it leaves on the blockmax body (tombstones, unaligned rows, k > 100);
* `sharded_ivf_search_topk` on JAX's own `IVFIndex` arrays, spilled and not: scores
  within rtol 1e-6 of JAX's, frame ids equal on exact-arithmetic data.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index.dense import DenseIndexBuilder as JaxDense
from wax_tpu.index.dense import Similarity
from wax_tpu.index.ivf import build_ivf as jax_build_ivf
from wax_tpu.parallel import mesh as jmesh
from wax_tpu.parallel.merge import merge_topk_across_mesh as jax_merge
from wax_tpu.parallel.sharded_ivf import shard_ivf_index as jax_shard_ivf
from wax_tpu.parallel.sharded_ivf import sharded_ivf_search_topk as jax_ivf_search
from wax_tpu.parallel.sharded_scan import shard_dense_index as jax_shard_dense
from wax_tpu.parallel.sharded_scan import sharded_flat_scan_topk as jax_scan
from wax_tpu_torch.index.dense import DenseIndex
from wax_tpu_torch.index.dense import DenseIndexBuilder as TorchDense
from wax_tpu_torch.index.lex import LexIndexBuilder as TorchLex
from wax_tpu_torch.index.ivf import ivf_index_from_numpy, ivf_search_topk
from wax_tpu_torch.parallel import mesh as tmesh
from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
from wax_tpu_torch.parallel.sharded_ivf import shard_ivf_index, sharded_ivf_search_topk
from wax_tpu_torch.ops import chunkmax_scan
from wax_tpu_torch.ops.flat_scan import flat_scan_topk
from wax_tpu_torch.parallel import sharded_hybrid
from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex, shard_dense_index, sharded_flat_scan_topk
from wax_tpu_torch.utils.profiling import counters

CPU8 = ["cpu"] * 8
MESHES = {
    "flat8": (lambda: jmesh.data_mesh(8), lambda: tmesh.data_mesh(CPU8)),
    "2x4": (lambda: jmesh.make_two_level_mesh(2, 4), lambda: tmesh.make_two_level_mesh(2, 4, devices=CPU8)),
    "4x2": (lambda: jmesh.make_two_level_mesh(4, 2), lambda: tmesh.make_two_level_mesh(4, 2, devices=CPU8)),
    "2x2x2": (lambda: jmesh.make_two_level_mesh(2, 4, tp=2),
              lambda: tmesh.make_two_level_mesh(2, 4, tp=2, devices=CPU8)),
}
D, K = 64, 10


def _meshes(name):
    jm, tm = MESHES[name]
    return jm(), tm()


# ---------------------------------------------------------------------------- meshes


def test_mesh_shapes_match_jax():
    for name in MESHES:
        jm, tm = _meshes(name)
        assert tm.axis_names == tuple(jm.axis_names), name
        assert tm.shape == dict(jm.shape), name
        assert tmesh.corpus_axes(tm) == jmesh.corpus_axes(jm), name
        assert tmesh.corpus_shards(tm) == jmesh.corpus_shards(jm), name
        assert tm.device == torch.device("cpu") and set(tm.shard_devices) == {torch.device("cpu")}
    m = tmesh.make_mesh(CPU8, tp=2)
    assert m.axis_names == ("data", "tp") and m.shape == {"data": 4, "tp": 2} and m.corpus_shards == 4
    assert tmesh.data_mesh("cpu").corpus_shards == 1 and tmesh.data_mesh(["cpu"] * 3).corpus_shards == 3
    assert tmesh.make_two_level_mesh(2, 4, devices=CPU8) == tmesh.make_two_level_mesh(2, 4, devices=CPU8)
    assert tmesh.make_two_level_mesh(2, 4, devices=CPU8) != tmesh.data_mesh(CPU8)


@pytest.mark.parametrize("args", [dict(n_slices=3), dict(n_slices=2, per_slice=8), dict(n_slices=2, per_slice=4, tp=3)],
                         ids=["slices_do_not_divide", "too_few_devices", "tp_does_not_divide"])
def test_bad_mesh_shapes_raise(args):
    with pytest.raises(ValueError):
        jmesh.make_two_level_mesh(**args)
    with pytest.raises(ValueError):
        tmesh.make_two_level_mesh(**args, devices=CPU8)


def test_make_mesh_tp_must_divide():
    with pytest.raises(ValueError, match="tp=3"):
        tmesh.make_mesh(CPU8, tp=3)


def test_shard_rows_and_replicate():
    m = tmesh.data_mesh(["cpu"] * 4)
    x = torch.arange(12).reshape(6, 2)
    with pytest.raises(ValueError, match="do not split"):
        tmesh.shard_rows(m, x)
    blocks = tmesh.shard_rows(m, torch.arange(8))
    assert [b.tolist() for b in blocks] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    reps = tmesh.replicate(m, x)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one copy per distinct device
    src = torch.arange(8)
    views = tmesh.shard_rows(m, src)  # shards sharing a device hold views of one tensor
    assert all(b.untyped_storage().data_ptr() == src.untyped_storage().data_ptr() for b in views)


# ----------------------------------------------------------------------------- merge


@pytest.mark.parametrize("name", ["flat8", "2x4", "4x2", "2x2x2"])
def test_merge_tie_order_matches_jax(name):
    """Eight shards' lists full of exact ties: the merged ids equal JAX's all-gather
    merge on the same mesh, whose order is (slice, data shard, local order)."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    jm, tm = _meshes(name)
    s = tmesh.corpus_shards(tm)
    rng = np.random.default_rng(4)
    vals = -np.sort(-rng.integers(0, 3, (s, 3, 4)).astype(np.float32), axis=2)
    vals[:, 2, 2:] = -3.0e38  # dead slots
    fids = (np.arange(s)[:, None, None] * 100 + np.arange(4)[None, None, :] + np.zeros((1, 3, 1))).astype(np.int32)

    def body(v, f):
        return jax_merge(v[0], f[0], K, jm)

    spec = P(jmesh.corpus_axes(jm))
    jv, jf = shard_map(body, mesh=jm, in_specs=(spec, spec), out_specs=(P(), P()), check_vma=False)(
        jnp.asarray(vals), jnp.asarray(fids))
    tv, tf = merge_topk_across_mesh([torch.from_numpy(v) for v in vals], [torch.from_numpy(f) for f in fids], K, tm)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    flat_v, flat_f = merge_topk_across_mesh([torch.from_numpy(v) for v in vals],
                                            [torch.from_numpy(f) for f in fids], K, tmesh.data_mesh(["cpu"] * s))
    np.testing.assert_array_equal(tf.numpy(), flat_f.numpy())


def test_merge_pads_narrow_lists_and_checks_count():
    m = tmesh.data_mesh(["cpu"] * 2)
    v, f = merge_topk_across_mesh([torch.tensor([[3.0]]), torch.tensor([[5.0]])],
                                  [torch.tensor([[7]]), torch.tensor([[9]])], 4, m)
    assert f.tolist() == [[9, 7, -1, -1]] and v[0, 2].item() == torch.tensor(-3.0e38).item()
    with pytest.raises(ValueError, match="2 corpus shards"):
        merge_topk_across_mesh([torch.zeros(1, 1)], [torch.zeros(1, 1, dtype=torch.int32)], 4, m)


# ------------------------------------------------------------------------- flat scan


def _dense_pair(vecs, remove=(), similarity=Similarity.COSINE):
    jb, tb = JaxDense(vecs.shape[1], similarity), TorchDense(vecs.shape[1], similarity)
    fids = np.arange(1, len(vecs) + 1)
    for b in (jb, tb):
        b.add_batch(fids, vecs)
        for f in remove:
            b.remove(f)
    return jb.snapshot(), tb.snapshot(device="cpu")


def _exact(n, seed, d=D):
    """Entries k/4 in [-1, 1]: every product and sum below is exact in f32."""
    return (np.random.default_rng(seed).integers(-4, 5, (n, d)) / 4.0).astype(np.float32)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("data", ["random", "exact", "uneven"])
def test_sharded_flat_scan_equals_jax(name, data):
    """Random rows (cosine): ids equal, scores within rtol 1e-6. Exact-arithmetic rows
    (dot product, no normalisation; many exact ties): ids and scores bit-equal. 1,000
    rows do not split over 8 shards: the padding rows stay dead. Two tombstones."""
    rng = np.random.default_rng(1)
    n = 1000 if data == "uneven" else 4096
    vecs = _exact(n, 2) if data == "exact" else rng.standard_normal((n, D)).astype(np.float32)
    q = _exact(16, 3) if data == "exact" else rng.standard_normal((16, D)).astype(np.float32)
    sim = Similarity.DOT if data == "exact" else Similarity.COSINE
    jsnap, tsnap = _dense_pair(vecs, remove=(5, 17), similarity=sim)
    jm, tm = _meshes(name)
    jv, jf = jax_scan(jnp.asarray(q), jax_shard_dense(jsnap, jm), K, jm)
    tsh = shard_dense_index(tsnap, tm)
    assert tsh.n_shards == tmesh.corpus_shards(tm) and tsh.local_rows * tsh.n_shards >= n
    tv, tf = sharded_flat_scan_topk(torch.from_numpy(q), tsh, K, tm)
    assert tf.dtype == torch.int32 and tv.shape == (16, K)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    if data == "exact":
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    else:
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert 5 not in tf.numpy() and 17 not in tf.numpy()


def test_two_level_scan_bit_equal_to_flat():
    vecs = np.random.default_rng(8).standard_normal((2048, D)).astype(np.float32)
    _, tsnap = _dense_pair(vecs)
    q = torch.from_numpy(np.random.default_rng(9).standard_normal((8, D)).astype(np.float32))
    out = {}
    for name in MESHES:
        tm = MESHES[name][1]()
        out[name] = sharded_flat_scan_topk(q, shard_dense_index(tsnap, tm), K, tm)
    for name in ("2x4", "4x2"):
        assert torch.equal(out[name][0], out["flat8"][0]) and torch.equal(out[name][1], out["flat8"][1])


def test_sharded_scan_k_beyond_shard_rows():
    """k larger than a shard's rows: each shard returns all it has, the merge pads."""
    vecs = np.random.default_rng(5).standard_normal((24, D)).astype(np.float32)
    jsnap, tsnap = _dense_pair(vecs)
    jm, tm = _meshes("flat8")
    jv, jf = jax_scan(jnp.zeros((2, D)) + 0.1, jax_shard_dense(jsnap, jm), 40, jm)
    tv, tf = sharded_flat_scan_topk(torch.zeros((2, D)) + 0.1, shard_dense_index(tsnap, tm), 40, tm)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    assert (tf.numpy()[:, 24:] == -1).all()


def _chunkmax_shards() -> int:
    return counters().get("sharded_scan.chunkmax_shards", 0)


def _scan_pair(vecs, q, k, name, remove=(), similarity=Similarity.COSINE):
    """JAX's sharded scan and the port's on mesh `name`, and the port's chunkmax
    shards in its call."""
    jsnap, tsnap = _dense_pair(vecs, remove=remove, similarity=similarity)
    jm, tm = _meshes(name)
    jv, jf = jax_scan(jnp.asarray(q), jax_shard_dense(jsnap, jm), k, jm)
    tsh = shard_dense_index(tsnap, tm)
    before = _chunkmax_shards()
    tv, tf = sharded_flat_scan_topk(torch.from_numpy(q), tsh, k, tm)
    return (np.asarray(jv), np.asarray(jf)), (tv.numpy(), tf.numpy()), tsh, _chunkmax_shards() - before


def _assert_equal_up_to_exact_ties(vecs, q, got, want):
    """Exact-arithmetic rows: scores bit-equal; every id returned scores exactly its
    listed score; each run of equal scores holds the same ids, save the run at the k-th
    score, whose rows may be any of those tied there. (K7 ranks tied rows by their
    chunk's rank, JAX's blockmax by row.)"""
    (tv, tf), (jv, jf) = got, want
    np.testing.assert_array_equal(tv, jv)
    assert (tf >= 1).all() and all(len(set(r)) == len(r) for r in tf)
    np.testing.assert_array_equal(np.einsum("bd,bkd->bk", q.astype(np.float64), vecs[tf - 1].astype(np.float64)), tv)
    for b in range(len(tv)):
        for s in set(tv[b]) - {tv[b, -1]}:
            assert set(tf[b][tv[b] == s]) == set(jf[b][jv[b] == s]), (b, s)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("data", ["random", "exact"])
def test_sharded_scan_chunkmax_route_equals_jax(name, data, monkeypatch):
    """16,384 contiguous rows with the row floor lowered to 2,048: every shard (2,048 or
    4,096 local rows) takes K6 + K7's twins, one count a shard. Random rows (cosine): ids
    equal to JAX's XLA scan, scores within rtol 1e-6. Exact-arithmetic rows (dot
    product, many exact ties): scores bit-equal, ids equal up to the order of exact
    ties and the choice among rows tied at the k-th score."""
    monkeypatch.setattr(chunkmax_scan, "_MIN_ROWS", 2048)
    rng = np.random.default_rng(11)
    vecs = _exact(16384, 12) if data == "exact" else rng.standard_normal((16384, D)).astype(np.float32)
    q = _exact(16, 13) if data == "exact" else rng.standard_normal((16, D)).astype(np.float32)
    sim = Similarity.DOT if data == "exact" else Similarity.COSINE
    (jv, jf), (tv, tf), tsh, routed = _scan_pair(vecs, q, K, name, similarity=sim)
    assert tsh.contiguous and tsh.local_rows % 2048 == 0 and routed == tsh.n_shards
    if data == "exact":
        _assert_equal_up_to_exact_ties(vecs, q, (tv, tf), (jv, jf))
    else:
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)


@pytest.mark.parametrize("case", ["tombstoned", "unaligned", "k101"])
def test_sharded_scan_blockmax_shards_unchanged(case, monkeypatch):
    """Shards the chunkmax route does not take keep the blockmax body: a tombstoned
    index, 1,024 local rows (the floor lowered to 1,024, rows not a multiple of 2,048),
    and k 101. No shard is counted; ids equal to JAX's, scores within rtol 1e-6."""
    monkeypatch.setattr(chunkmax_scan, "_MIN_ROWS", 1024)
    rng = np.random.default_rng(21)
    n = 8192 if case == "unaligned" else 16384
    vecs, q = rng.standard_normal((n, D)).astype(np.float32), rng.standard_normal((16, D)).astype(np.float32)
    k = 101 if case == "k101" else K
    (jv, jf), (tv, tf), tsh, routed = _scan_pair(vecs, q, k, "flat8", remove=(5, 17) if case == "tombstoned" else ())
    assert routed == 0 and tsh.contiguous == (case != "tombstoned")
    assert tsh.local_rows == (1024 if case == "unaligned" else 2048)
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)


# (rows, k, contiguous) against the floor lowered to 135,168 rows (66 x 2,048, past
# flat_scan's K1 regime): below the floor, at it, not contiguous, not a multiple of
# 2,048, and k 51 (the hybrid lane's fetch, max(2k, 16), is then 102)
CHUNKMAX_CASES = [(133_120, 10, True), (135_168, 10, True), (135_168, 10, False), (135_680, 10, True),
                  (135_168, 51, True)]


@pytest.mark.parametrize("route", ["flat_scan", "sharded_scan", "sharded_hybrid"])
def test_sharded_scan_chunkmax_floor_pinned_to_the_hybrid_lane(route, monkeypatch):
    """flat_scan's "auto", the sharded scan and the sharded hybrid program's dense lane
    send a row block to chunkmax (K6's twin runs) exactly where the one predicate,
    `chunkmax_scan.takes_chunkmax`, says for the k each hands its lane."""
    monkeypatch.setattr(chunkmax_scan, "_MIN_ROWS", 135_168)
    calls = []
    real = chunkmax_scan.chunk_maxima
    monkeypatch.setattr(chunkmax_scan, "chunk_maxima", lambda *a: calls.append(a) or real(*a))
    mesh = tmesh.data_mesh(["cpu"])
    lex = TorchLex()
    lex.add_batch([(i, f"fox river {i % 7}") for i in range(64)])
    tids = torch.tensor([lex.term_ids(["fox", "river"])] * 2, dtype=torch.int32)
    rng = np.random.default_rng(5)
    seen = set()
    for rows, k, contiguous in CHUNKMAX_CASES:
        emb = torch.from_numpy(rng.standard_normal((rows, 4)).astype(np.float32))
        q = torch.from_numpy(rng.standard_normal((2, 4)).astype(np.float32))
        ids = torch.arange(rows, dtype=torch.int32)
        dense = ShardedDenseIndex(emb=(emb,), frame_ids=(ids,), bias=(torch.zeros(rows),), contiguous=contiguous)
        calls.clear()
        if route == "flat_scan":
            flat_scan_topk(q, DenseIndex(emb=emb, frame_ids=ids, active=ids >= 0, count=torch.tensor(rows),
                                         contiguous=contiguous), k)
        elif route == "sharded_scan":
            sharded_flat_scan_topk(q, dense, k, mesh)
        else:
            sharded_hybrid.sharded_hybrid_topk(q, tids, dense, sharded_hybrid.shard_lex_index(lex, mesh, 64), k, mesh)
        want = chunkmax_scan.takes_chunkmax(rows, max(2 * k, 16) if route == "sharded_hybrid" else k, contiguous)
        assert bool(calls) == want, (route, rows, k, contiguous)
        seen.add(want)
    assert seen == {True, False}


# --------------------------------------------------------------------------------- IVF


@pytest.fixture(scope="module")
def ivf_pair():
    """JAX-built IVF indexes (plain and spilled) and the same arrays in the port."""
    rng = np.random.default_rng(7)
    centers = rng.standard_normal((32, 48)).astype(np.float32) * 4
    vecs = (centers[rng.integers(0, 32, 6000)] + rng.standard_normal((6000, 48))).astype(np.float32)
    out = {}
    for spill in (0.0, "auto"):
        j = jax_build_ivf(vecs, np.arange(6000), n_clusters=32, iters=4, seed=0, spill=spill)
        t = ivf_index_from_numpy(np.asarray(j.centroids), np.asarray(j.emb), np.asarray(j.ids), np.asarray(j.bias),
                                 j.spilled, device="cpu")
        out[spill] = (j, t)
    assert out["auto"][0].spilled and not out[0.0][0].spilled
    q = rng.standard_normal((12, 48)).astype(np.float32)
    return out, q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("spill", [0.0, "auto"], ids=["plain", "spilled"])
def test_sharded_ivf_equals_jax(ivf_pair, name, spill):
    """Scores within rtol 1e-6 of JAX's sharded search on the same mesh shape and of
    the port's one-device probe loop; no frame id twice on a spilled index."""
    out, q = ivf_pair
    j, t = out[spill]
    jm, tm = _meshes(name)
    jv, jf = jax_ivf_search(jnp.asarray(q), jax_shard_ivf(j, jm), K, jm, nprobe=6)
    sh = shard_ivf_index(t, tm)
    assert sh.bucket_size % tmesh.corpus_shards(tm) == 0 and sh.spilled == t.spilled
    tv, tf = sharded_ivf_search_topk(torch.from_numpy(q), sh, K, tm, nprobe=6)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert (tf.numpy() == np.asarray(jf)).mean() > 0.99
    v1, _ = ivf_search_topk(torch.from_numpy(q), t, K, nprobe=6)
    np.testing.assert_allclose(tv.numpy(), v1.numpy(), rtol=1e-6, atol=0)
    for row in tf.numpy():
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


@pytest.mark.parametrize("spill", [0.0, "auto"], ids=["plain", "spilled"])
def test_sharded_ivf_exact_data_ids_equal(spill):
    """Exact arithmetic: a JAX-built index whose bucket rows are rounded to the
    1/4 grid (build_ivf normalises them) and queries on it, so every score is exact:
    frame ids and scores equal to JAX's bit for bit on the flat and the 2 x 4 mesh."""
    import dataclasses

    vecs = _exact(3000, 11, d=32)
    rng = np.random.default_rng(12)
    j = jax_build_ivf(vecs, np.arange(3000), n_clusters=16, iters=3, seed=0, spill=spill)
    j = dataclasses.replace(j, emb=jnp.round(j.emb * 4) / 4)
    t = ivf_index_from_numpy(np.asarray(j.centroids), np.asarray(j.emb), np.asarray(j.ids), np.asarray(j.bias),
                             j.spilled, device="cpu")
    q = vecs[rng.integers(0, 3000, 6)]
    for name in ("flat8", "2x4"):
        jm, tm = _meshes(name)
        jv, jf = jax_ivf_search(jnp.asarray(q), jax_shard_ivf(j, jm), K, jm, nprobe=4)
        tv, tf = sharded_ivf_search_topk(torch.from_numpy(q), shard_ivf_index(t, tm), K, tm, nprobe=4)
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))


def test_sharded_ivf_k_beyond_candidates(ivf_pair):
    out, q = ivf_pair
    t = out[0.0][1]
    tm = tmesh.data_mesh(["cpu"] * 4)
    v, f = sharded_ivf_search_topk(torch.from_numpy(q[:2]), shard_ivf_index(t, tm), 4096, tm, nprobe=1)
    live = (f.numpy() >= 0).sum(axis=1)
    assert (live <= t.bucket_size).all() and (live > 0).all() and (f.numpy()[:, -1] == -1).all()
