"""The IVF index (index/ivf.py) and its K7 search entry against wax_tpu's, on the CPU.

The JAX package's Pallas IVF kernel runs in interpret mode here; the port's K7 wrapper
runs its plain twin on CPU tensors. k-means' random draws differ by design (a seeded
torch generator against jax.random), so the Lloyd iterations are held against JAX from
JAX's own initial rows, and packing and spill from JAX's own centroids.

Search is held on two kinds of index carried across from JAX (`ivf_index_from_numpy`):
one on exact-arithmetic data (entries k/8, centroids on a 1/64 grid: every product is
exact in f32, ties are common), where ids and scores must be equal; and one on random
unit vectors, where scores agree within rtol 1e-6 and ids are equal at k 10.
"""
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index import ivf as jivf
from wax_tpu.ops.ivf_kernel import ivf_search_topk_pallas as jax_pallas
from wax_tpu_torch.index import ivf as tivf
from wax_tpu_torch.ops import ivf_kernel as tk

D = 64
NEG_INF = -3.0e38


def _rng(name: str) -> np.random.Generator:
    return np.random.default_rng(zlib.crc32(name.encode()))


def _unit(x):
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.fixture(scope="module")
def clustered():
    """8,000 x 64 unit vectors round 50 centres (as tests/test_ivf.py), 32 queries."""
    rng = _rng("clustered")
    centers = rng.standard_normal((50, D)).astype(np.float32) * 3.0
    vecs = _unit(centers[rng.integers(0, 50, 8000)] + rng.standard_normal((8000, D)))
    queries = _unit(centers[rng.integers(0, 50, 32)] + rng.standard_normal((32, D)))
    return vecs, queries


def _margins(vecs, cent):
    """Top-1 minus top-2 centroid score of each row (float64)."""
    s = np.sort(vecs.astype(np.float64) @ np.asarray(cent, np.float64).T, axis=1)
    return s[:, -1] - s[:, -2]


def _assert_assign_equal(got, want, vecs, cent):
    """Assignments equal on every row whose margin exceeds 1e-4 or is an exact tie
    (duplicate centroids): f32 products of another summation order may break a closer
    tie the other way."""
    m = _margins(vecs, cent)
    clear = (m > 1e-4) | (m == 0)
    assert clear.mean() >= 0.9
    np.testing.assert_array_equal(np.asarray(got)[clear], np.asarray(want)[clear])


def test_assign_and_update_centroids_equal(clustered):
    vecs, _ = clustered
    rows = np.asarray(jax.random.choice(jax.random.PRNGKey(3), len(vecs), (64,), replace=False))
    cent = vecs[rows]
    ja = np.asarray(jivf._assign(jnp.asarray(vecs), jnp.asarray(cent)))
    ta = tivf._assign(torch.from_numpy(vecs), torch.from_numpy(cent))
    assert ta.dtype == torch.int64
    _assert_assign_equal(ta.numpy(), ja, vecs, cent)
    jc, jn = jivf._update_centroids(jnp.asarray(vecs), jnp.asarray(ja), jnp.zeros((64,), jnp.float32))
    tc, tn = tivf._update_centroids(torch.from_numpy(vecs), torch.tensor(ja).long(), 64)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)


def test_update_centroids_keeps_an_empty_cluster_at_zero():
    vecs = _unit(_rng("empty").standard_normal((100, D)))
    assign = np.zeros(100, np.int32)
    assign[50:] = 2  # cluster 1 gets no row
    jc, jn = jivf._update_centroids(jnp.asarray(vecs), jnp.asarray(assign), jnp.zeros((3,), jnp.float32))
    tc, tn = tivf._update_centroids(torch.from_numpy(vecs), torch.from_numpy(assign).long(), 3)
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-7)
    assert not tc[1].any()


@pytest.mark.parametrize("n,c,iters,seed", [(8000, 64, 8, 0), (8000, 32, 4, 1), (2000, 48, 3, 7), (40, 64, 2, 2)])
def test_lloyd_from_jax_initial_rows(clustered, n, c, iters, seed):
    """JAX's kmeans against the port's Lloyd iterations started from the rows JAX drew
    (jax.random.choice with the same key; with replacement when n < c)."""
    vecs = clustered[0][:n]
    jc, ja = jivf.kmeans(jnp.asarray(vecs), c, iters=iters, seed=seed)
    init = np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (c,), replace=n < c))
    tv = torch.from_numpy(vecs)
    tc, ta = tivf.lloyd(tv, tv[torch.tensor(init).long()], iters)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-6)
    _assert_assign_equal(ta.numpy(), ja, vecs, np.asarray(jc))


def test_kmeans_draws_from_a_seeded_torch_generator(clustered):
    vecs = torch.from_numpy(clustered[0][:2000])
    c1, a1 = tivf.kmeans(vecs, 32, iters=3, seed=5)
    c2, a2 = tivf.kmeans(vecs, 32, iters=3, seed=5)
    assert torch.equal(c1, c2) and torch.equal(a1, a2)
    init = torch.randperm(2000, generator=torch.Generator().manual_seed(5))[:32]
    c3, _ = tivf.lloyd(vecs, vecs[init], 3)
    assert torch.equal(c1, c3)
    assert not torch.equal(c1, tivf.kmeans(vecs, 32, iters=3, seed=6)[0])


def _grid_clustered(name: str, n: int = 6000):
    """Exact-arithmetic clustered rows: entries k/8 (k in -8..8) round 40 grid centres."""
    rng = _rng(name)
    centers = rng.integers(-6, 7, (40, D))
    return (np.clip(centers[rng.integers(0, 40, n)] + rng.integers(-2, 3, (n, D)), -8, 8) / 8.0).astype(np.float32)


PACK_CASES = {
    "plain": dict(), "spill_quarter": dict(spill=0.25), "spill_auto": dict(spill="auto"),
    "overflow": dict(bucket_size=128), "overflow_spill": dict(bucket_size=128, spill="auto"),
    "bf16": dict(n_clusters=48, spill="auto", bf16=True),
}


@pytest.mark.parametrize("data,case", [("random", c) for c in PACK_CASES if c != "bf16"]
                         + [("exact", c) for c in PACK_CASES])
def test_packing_and_spill_from_jax_centroids(clustered, monkeypatch, data, case):
    """The port's packing (buckets, overflow to preferred clusters, spill copies) from
    the centroids JAX packed with: ids, bias, spilled flag and buckets equal.

    On random unit vectors ("random") the centroids are JAX's own k-means result. Spill
    ranks rows by a difference of two f32 products, and rows whose margins lie within
    the two packages' rounding of each other (about 2e-7) may swap slots; on bf16
    buckets such a pair occurs at these sizes, so bf16 is held on exact data only. On
    exact-arithmetic data ("exact": rows k/8, centroids on a 1/64 grid, injected into
    JAX's build through its k-means) every product and margin is exact, ties are
    common, and all six cases must match."""
    kw = dict(n_clusters=64, bucket_size=None, spill=0.0, bf16=False) | PACK_CASES[case]
    if data == "random":
        vecs = clustered[0]
    else:
        vecs = _grid_clustered(f"pack-{case}")
        grid = np.round(vecs[_rng(f"init-{case}").choice(len(vecs), kw["n_clusters"], replace=False)] * 8.0) / 64.0

        def grid_kmeans(v, n_clusters, iters=8, seed=0):
            cent = jnp.asarray(grid)
            return cent, jivf._assign(v, cent)

        monkeypatch.setattr(jivf, "kmeans", grid_kmeans)
    fids = np.arange(len(vecs), dtype=np.int64) * 3 + 7
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if kw["bf16"] else (None, None)
    ji = jivf.build_ivf(vecs, fids, n_clusters=kw["n_clusters"], bucket_size=kw["bucket_size"], iters=4, seed=1,
                        normalize=False, bucket_dtype=jdt, spill=kw["spill"])
    cent = torch.tensor(np.asarray(ji.centroids))
    tv = torch.from_numpy(vecs)
    ti = tivf._pack(tv, fids, cent, tivf._assign(tv, cent).numpy(), ji.bucket_size, tdt, kw["spill"])
    assert ti.spilled == ji.spilled == (kw["spill"] != 0.0)
    np.testing.assert_array_equal(ti.ids.numpy(), np.asarray(ji.ids))
    np.testing.assert_array_equal(ti.bias.numpy(), np.asarray(ji.bias))
    assert ti.emb.dtype == (tdt or torch.float32)
    np.testing.assert_array_equal(ti.emb.float().numpy(), np.asarray(ji.emb.astype(jnp.float32)))
    live = ti.ids.numpy() >= 0
    counts = live.sum(axis=1)
    assert all(live[c, : counts[c]].all() and not live[c, counts[c]:].any() for c in range(live.shape[0]))
    assert set(ti.ids.numpy()[live].tolist()) == set(fids.tolist())
    if case.startswith("overflow"):  # some cluster held more rows than a bucket
        assert np.bincount(tivf._assign(tv, cent).numpy()).max() > ji.bucket_size


def test_build_ivf_defaults_and_sampled_training(clustered):
    """build_ivf's default cluster count and bucket size, the train_rows sample, and
    a repeat build with the same seed that is bit for bit the same."""
    vecs, _ = clustered
    ti = tivf.build_ivf(vecs, np.arange(len(vecs)), device="cpu")
    ji = jivf.build_ivf(vecs, np.arange(len(vecs)))
    assert (ti.n_clusters, ti.bucket_size, ti.dim) == (ji.n_clusters, ji.bucket_size, D) == (178, 128, D)
    assert int((ti.ids >= 0).sum()) == len(vecs)
    a = tivf.build_ivf(vecs, np.arange(len(vecs)), n_clusters=64, train_rows=2000, spill="auto", device="cpu")
    b = tivf.build_ivf(vecs, np.arange(len(vecs)), n_clusters=64, train_rows=2000, spill="auto", device="cpu")
    for f in ("centroids", "emb", "ids", "bias"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    ids = a.ids.numpy()
    assert set(ids[ids >= 0].tolist()) == set(range(len(vecs)))


def test_build_ivf_recall_near_jax(clustered):
    """The port's build (torch draws) serves recall@10 within 0.03 of JAX's build."""
    vecs, queries = clustered
    exact = np.argsort(-(queries @ vecs.T), axis=1)[:, :10]

    def recall(f):
        return np.mean([len(set(f[i].tolist()) & set(exact[i].tolist())) / 10 for i in range(len(f))])

    ji = jivf.build_ivf(vecs, np.arange(len(vecs)), n_clusters=64, seed=1)
    ti = tivf.build_ivf(vecs, np.arange(len(vecs)), n_clusters=64, seed=1, device="cpu")
    _, jf = jivf.ivf_search_topk(jnp.asarray(queries), ji, k=10, nprobe=4)
    _, tf = tivf.ivf_search_topk(torch.from_numpy(queries), ti, k=10, nprobe=4)
    rj, rt = recall(np.asarray(jf)), recall(tf.numpy())
    assert rj >= 0.85 and abs(rt - rj) <= 0.03, (rt, rj)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("k", [1, 5, 12])
def test_dedup_topk_equal(seed, k):
    """Windows with duplicate frame ids, exact score ties and NEG_INF / -1 slots."""
    rng = np.random.default_rng(seed)
    vals = (rng.integers(-4, 5, (6, 16)) / 4.0).astype(np.float32)
    fids = rng.integers(0, 9, (6, 16)).astype(np.int32)
    dead = rng.random((6, 16)) < 0.2
    vals[dead], fids[dead] = NEG_INF, -1
    jv, jf = jivf.dedup_topk(jnp.asarray(vals), jnp.asarray(fids), k)
    tv, tf = tivf.dedup_topk(torch.from_numpy(vals), torch.from_numpy(fids), k)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    for row in tf.numpy():
        live = row[row >= 0]
        assert len(live) == len(set(live.tolist()))


def _exact_jax_index(spill):
    """A JAX index on exact-arithmetic data: rows k/8 (k in -8..8) round 40 grid
    centres, 6,000 x 64, 48 clusters (S 256), and centroids rounded to a 1/64 grid."""
    rng = _rng(f"exact-{spill}")
    centers = rng.integers(-6, 7, (40, D))
    vecs = (np.clip(centers[rng.integers(0, 40, 6000)] + rng.integers(-2, 3, (6000, D)), -8, 8) / 8.0)
    vecs = vecs.astype(np.float32)
    q = (np.clip(centers[rng.integers(0, 40, 24)] + rng.integers(-2, 3, (24, D)), -8, 8) / 8.0).astype(np.float32)
    ji = jivf.build_ivf(vecs, np.arange(6000) * 2 + 1, n_clusters=48, iters=4, seed=3, normalize=False, spill=spill)
    cent = jnp.round(ji.centroids * 64.0) / 64.0
    return jivf.IVFIndex(centroids=cent, emb=ji.emb, ids=ji.ids, bias=ji.bias, spilled=ji.spilled), q


def _random_jax_index(clustered, spill):
    vecs, q = clustered
    return jivf.build_ivf(vecs, np.arange(len(vecs)), n_clusters=48, iters=4, seed=2, spill=spill), q


def _carry(ji):
    return tivf.ivf_index_from_numpy(np.asarray(ji.centroids), np.asarray(ji.emb), np.asarray(ji.ids),
                                     np.asarray(ji.bias), ji.spilled, device="cpu")


@pytest.fixture(scope="module")
def exact_indexes():
    return {spill: _exact_jax_index(spill) for spill in (0.0, "auto")}


@pytest.mark.parametrize("spill", [0.0, "auto"])
@pytest.mark.parametrize("nprobe", [1, 4, 48])
@pytest.mark.parametrize("k", [1, 10, 64, 200])
def test_search_equal_on_exact_data(exact_indexes, spill, nprobe, k):
    """ivf_search_topk and ivf_search_topk_pallas (K7's plain twin here) against JAX's
    (the Pallas kernel in interpret mode) on a carried-across index: ids equal, scores
    within rtol 1e-6 (here equal), output shapes equal, the k > 128 shape included."""
    ji, q = exact_indexes[spill]
    assert ji.spilled == (spill == "auto") and ji.bucket_size == 256
    ti = _carry(ji)
    tq = torch.from_numpy(q)
    for jfn, tfn in ((jivf.ivf_search_topk, tivf.ivf_search_topk), (jax_pallas, tk.ivf_search_topk_pallas)):
        jv, jf = (np.asarray(x) for x in jfn(jnp.asarray(q), ji, k=k, nprobe=nprobe))
        tv, tf = tfn(tq, ti, k=k, nprobe=nprobe)
        assert tf.shape == jf.shape and tf.dtype == torch.int32
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=0)
        for row in tf.numpy():
            live = row[row >= 0]
            assert len(live) == len(set(live.tolist()))
    pallas_cols = min(k, 128) if spill == 0.0 else k  # JAX's kernel writes at most 128 lanes
    assert tuple(tf.shape) == (len(q), pallas_cols)


@pytest.mark.parametrize("spill", [0.0, "auto"])
@pytest.mark.parametrize("nprobe", [1, 4, 48])
def test_search_near_jax_on_random_unit_vectors(clustered, spill, nprobe):
    ji, q = _random_jax_index(clustered, spill)
    ti = _carry(ji)
    for jfn, tfn in ((jivf.ivf_search_topk, tivf.ivf_search_topk), (jax_pallas, tk.ivf_search_topk_pallas)):
        jv, jf = (np.asarray(x) for x in jfn(jnp.asarray(q), ji, k=10, nprobe=nprobe))
        tv, tf = tfn(torch.from_numpy(q), ti, k=10, nprobe=nprobe)
        np.testing.assert_array_equal(tf.numpy(), jf)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=0)


def test_pallas_entry_guards(exact_indexes):
    """A bucket size that is not a multiple of 128 raises; a spilled index with 2k >
    128 gives the plain path's answer (JAX's entry answers through that path there);
    bf16 buckets carry across."""
    ji, q = exact_indexes["auto"]
    ti = _carry(ji)
    tq = torch.from_numpy(q)
    for fn in (tk.ivf_search_topk_pallas, tivf.ivf_search_topk):
        v, f = fn(tq, ti, k=100, nprobe=4)
        assert f.shape == (len(q), 100)
    assert torch.equal(tk.ivf_search_topk_pallas(tq, ti, k=100, nprobe=4)[1],
                       tivf.ivf_search_topk(tq, ti, k=100, nprobe=4)[1])
    odd = jivf.build_ivf(q, np.arange(len(q)), n_clusters=2, bucket_size=88)
    with pytest.raises(ValueError, match="128-aligned"):
        tk.ivf_search_topk_pallas(tq, _carry(odd), k=3, nprobe=2)
    bf = jivf.IVFIndex(centroids=ji.centroids, emb=ji.emb.astype(jnp.bfloat16), ids=ji.ids, bias=ji.bias,
                       spilled=False)
    tb = _carry(bf)
    assert tb.emb.dtype == torch.bfloat16
    jv, jf = jax_pallas(jnp.asarray(q), bf, k=10, nprobe=4)
    tv, tf = tk.ivf_search_topk_pallas(tq, tb, k=10, nprobe=4)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pallas_entry_launches_k7_wrapper_once(exact_indexes, monkeypatch):
    """One search is one K7 call at min(k, 128) (k 200 on an index without spill)."""
    ji, q = exact_indexes[0.0]
    seen = []
    real = tk.bucket_rescore

    def spy(q_, probes, counts, emb3, k):
        seen.append((tuple(probes.shape), k, counts.tolist()))
        return real(q_, probes, counts, emb3, k)

    monkeypatch.setattr(tk, "bucket_rescore", spy)
    tk.ivf_search_topk_pallas(torch.from_numpy(q), _carry(ji), k=200, nprobe=4)
    assert len(seen) == 1 and seen[0][:2] == ((len(q), 4), 128)
    assert seen[0][2] == (np.asarray(ji.ids) >= 0).sum(axis=1).tolist()


@pytest.mark.parametrize("smem_max", [227 * 1024, 1024])
@pytest.mark.parametrize("k,nprobe", [(100, 4), (100, 48), (70, 1)])
def test_pallas_entry_spilled_wide_window(exact_indexes, monkeypatch, smem_max, k, nprobe):
    """On a spilled index with 2k > 128 the entry calls K7 once at the window min(2k,
    nprobe * S) where the arg-max body's key plane fits shared memory, and the plain
    path where it does not (a shared memory limit of 1 KiB forces that here); either
    way the result equals JAX's (its entry takes the plain path) and the port's plain
    path."""
    ji, q = exact_indexes["auto"]
    ti = _carry(ji)
    tq = torch.from_numpy(q)
    monkeypatch.setattr(tk, "_SMEM_MAX", smem_max)
    seen = []
    real = tk.bucket_rescore

    def spy(q_, probes, counts, emb3, kk):
        seen.append((tuple(probes.shape), kk))
        return real(q_, probes, counts, emb3, kk)

    monkeypatch.setattr(tk, "bucket_rescore", spy)
    tv, tf = tk.ivf_search_topk_pallas(tq, ti, k=k, nprobe=nprobe)
    fits = tk.argmax_fits(D, ti.bucket_size, nprobe)
    assert fits == (smem_max > 1024)
    assert seen == ([((len(q), nprobe), min(2 * k, nprobe * ti.bucket_size))] if fits else [])
    jv, jf = (np.asarray(x) for x in jax_pallas(jnp.asarray(q), ji, k=k, nprobe=nprobe))
    np.testing.assert_array_equal(tf.numpy(), jf)
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=0)
    pv, pf = tivf.ivf_search_topk(tq, ti, k=k, nprobe=nprobe)
    assert torch.equal(pf, tf) and torch.equal(pv, tv)


@pytest.mark.parametrize("d,s,nprobe,fits", [(64, 256, 48, True), (768, 384, 64, True), (768, 384, 76, False),
                                             (768, 1152, 64, False), (768, 1152, 8, True)])
def test_argmax_fits(d, s, nprobe, fits):
    """The arg-max body's shared memory: nprobe * S 8-byte keys, the f32 query row and
    64 static bytes within the 227 KiB a CTA may hold."""
    assert tk.argmax_fits(d, s, nprobe) == fits
