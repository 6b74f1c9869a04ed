"""Corpus-sharded serving over device meshes against wax_tpu's 8-device CPU mesh.

The port's meshes here are eight logical shards on the CPU (`["cpu"] * 8`), laid out
as JAX's are on its eight virtual CPU devices (tests/conftest.py): flat ("data",) 8,
("slice", "data") 2 x 4 and 4 x 2, and ("slice", "data", "tp") 2 x 2 x 2. The same
numpy inputs go through both packages:

* meshes: axes, shard counts and the ValueErrors of shapes that do not divide;
* the merge: JAX's tie order (slice, data shard, local order), two-level = flat;
* `sharded_flat_scan_topk`: frame ids equal and scores within rtol 1e-6 on random
  data, bit-equal on exact-arithmetic data (entries k/4), uneven row counts included;
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
from wax_tpu_torch.index.dense import DenseIndexBuilder as TorchDense
from wax_tpu_torch.index.ivf import ivf_index_from_numpy, ivf_search_topk
from wax_tpu_torch.parallel import mesh as tmesh
from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
from wax_tpu_torch.parallel.sharded_ivf import shard_ivf_index, sharded_ivf_search_topk
from wax_tpu_torch.parallel.sharded_scan import shard_dense_index, sharded_flat_scan_topk

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
