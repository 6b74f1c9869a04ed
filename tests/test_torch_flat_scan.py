"""wax_tpu_torch flat scan against wax_tpu's, backend by backend, on the same data.

On the CPU the port's kernel wrappers run their plain torch twins (K1:
`_packed_sel_topk_plain`, K2: `_scan_topk_plain`); the JAX package's Pallas kernels
run in interpret mode. Capacities 4,096 and 6,144 make `auto` pick the packed-key
kernel with 2,048-row tiles.

* Exact-arithmetic DOT data (entries k/8 in [-1, 1], so every dot product is exact in
  f32 whatever the summation order; ties are common): ids, scores and frame ids must be
  EQUAL. The port's `pallas_packed_sel` is the exact per-tile top-k over packed keys,
  i.e. what JAX's `pallas_packed` computes; JAX's `pallas_packed_sel` may lose an
  element to its lane-slot lookahead, so against it top-k overlap must be >= 0.999.
* Random cosine data: scores within 1e-5 (summation order), ids equal except
  near-ties within 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index.dense import DenseIndexBuilder as JaxBuilder
from wax_tpu.index.dense import Similarity
from wax_tpu.ops.flat_scan import flat_scan_topk as jax_scan
from wax_tpu_torch.index.dense import DenseIndexBuilder as TorchBuilder
from wax_tpu_torch.ops import flat_scan as fs

D = 64
REMOVED = (5, 77, 2000, 2047, 2048)  # tombstones, two of them at a tile edge


def _pair(cap, similarity, vecs, tombstoned):
    jb = JaxBuilder(D, similarity, capacity=cap)
    tb = TorchBuilder(D, similarity, capacity=cap)
    ids = np.arange(len(vecs)) + 100
    jb.add_batch(ids, vecs)
    tb.add_batch(ids, vecs)
    if tombstoned:
        for r in REMOVED:
            assert jb.remove(r + 100) and tb.remove(r + 100)
    return jb.snapshot(), tb.snapshot(device="cpu")


def _grid(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


@pytest.fixture(scope="module")
def exact_snaps():
    rng = np.random.default_rng(1)
    return {
        (cap, tomb): _pair(cap, Similarity.DOT, _grid(rng, (cap - 1000, D)), tomb)
        for cap in (4096, 6144)
        for tomb in (False, True)
    }


@pytest.fixture(scope="module")
def random_snaps():
    rng = np.random.default_rng(2)
    return {
        cap: _pair(cap, Similarity.COSINE, rng.standard_normal((cap - 1000, D)).astype(np.float32), True)
        for cap in (4096, 6144)
    }


def _run(scan, q, snap, k, backend):
    if scan is jax_scan:
        return [np.asarray(x) for x in jax_scan(jnp.asarray(q), snap, k, backend=backend)]
    return [x.numpy() for x in fs.flat_scan_topk(torch.from_numpy(q), snap, k, backend=backend)]


def _overlap(a, b):
    return np.mean([len(set(x) & set(y)) / len(x) for x, y in zip(a, b)])


def test_snapshot_fields_equal(exact_snaps):
    for js, ts in exact_snaps.values():
        for f in ("emb", "frame_ids", "active", "count"):
            np.testing.assert_array_equal(np.asarray(getattr(js, f)), getattr(ts, f).numpy())
        assert (js.contiguous, js.similarity, js.capacity) == (ts.contiguous, ts.similarity, ts.capacity)


@pytest.mark.parametrize("cap", [4096, 6144])
@pytest.mark.parametrize("b", [8, 13])
@pytest.mark.parametrize("k", [1, 10, 20, 100])
def test_exact_data_equal(exact_snaps, cap, b, k):
    js, ts = exact_snaps[(cap, b == 13)]  # the ragged batch runs on the tombstoned index
    q = _grid(np.random.default_rng(cap + b + k), (b, D))
    for jb, tb in (("xla", "xla"), ("pallas", "pallas"), ("blockmax", "blockmax"),
                   ("blockmax16", "blockmax16"), ("pallas_packed", "pallas_packed"),
                   ("pallas_packed", "pallas_packed_sel")):
        want, got = _run(jax_scan, q, js, k, jb), _run(fs.flat_scan_topk, q, ts, k, tb)
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g, err_msg=f"{jb} vs {tb}")
    # the port's pallas_packed_sel is auto's pick; JAX's may lose to its lookahead
    auto = _run(fs.flat_scan_topk, q, ts, k, "auto")
    np.testing.assert_array_equal(auto[1], got[1])
    sel = _run(jax_scan, q, js, k, "pallas_packed_sel")
    assert _overlap(sel[1], got[1]) >= 0.999


@pytest.mark.parametrize("cap", [4096, 6144])
@pytest.mark.parametrize("backend", ["xla", "pallas", "blockmax"])
def test_random_cosine_exact_backends(random_snaps, cap, backend):
    js, ts = random_snaps[cap]
    rng = np.random.default_rng(cap)
    q = np.asarray(fs.normalize_rows(torch.from_numpy(rng.standard_normal((13, D)).astype(np.float32))))
    k = 20
    jv, jr, jf = _run(jax_scan, q, js, k, backend)
    tv, tr, tf = _run(fs.flat_scan_topk, q, ts, k, backend)
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    exact = q @ np.asarray(js.emb).T
    for i in range(len(q)):
        for r in set(jr[i]) ^ set(tr[i]):  # every id mismatch is a near-tie at the boundary
            assert abs(exact[i, r] - jv[i, -1]) <= 1e-5
    assert _overlap(jf, tf) >= 0.99


@pytest.mark.parametrize("cap", [4096, 6144])
def test_random_cosine_packed_and_blockmax16(random_snaps, cap):
    js, ts = random_snaps[cap]
    rng = np.random.default_rng(cap + 1)
    q = np.asarray(fs.normalize_rows(torch.from_numpy(rng.standard_normal((8, D)).astype(np.float32))))
    k = 10
    exact = _run(jax_scan, q, js, k, "xla")
    packed = _run(fs.flat_scan_topk, q, ts, k, "pallas_packed_sel")
    jsel = _run(jax_scan, q, js, k, "pallas_packed_sel")
    assert _overlap(packed[1], jsel[1]) >= 0.999
    # packed scores are truncated to 2^-12 relative
    np.testing.assert_allclose(packed[0], exact[0], rtol=2.0**-11, atol=1e-6)
    b16 = _run(fs.flat_scan_topk, q, ts, k, "blockmax16")
    assert _overlap(b16[1], exact[1]) >= 0.999
    jb16 = _run(jax_scan, q, js, k, "blockmax16")
    assert _overlap(b16[1], jb16[1]) >= 0.999
    np.testing.assert_allclose(b16[0], jb16[0], atol=1e-5, rtol=0)


def test_flat_vector_engine_matches_jax(rng, tmp_path, monkeypatch):
    from wax_tpu.search.vector_engines import FlatVectorEngine as JaxEngine
    from wax_tpu_torch.search.vector_engines import MAX_TOP_K, FlatVectorEngine

    # the JAX engine persists executables: keep them out of the suite's shared cache
    monkeypatch.setenv("WAX_TPU_AOT_DIR", str(tmp_path))

    je, te = JaxEngine(D, similarity=Similarity.DOT), FlatVectorEngine(D, similarity=Similarity.DOT, device="cpu")
    q = _grid(rng, (5, D))
    for e in (je, te):  # empty engine: -inf / -1 slots
        v, f = e.search(q, 4)
        assert v.shape == f.shape == (5, 4) and np.isneginf(v).all() and (f == -1).all()
    vecs = _grid(rng, (1500, D))
    je.add_batch(np.arange(1500) + 7, vecs)
    te.add_batch(np.arange(1500) + 7, vecs)
    je.remove(9)
    te.remove(9)
    te.add(3000, vecs[0])
    je.add(3000, vecs[0])
    for k in (10, 2100):  # k beyond capacity pads with -inf / -1
        jv, jf = je.search(q, k)
        tv, tf = te.search(q, k)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_array_equal(tv, jv)
    assert len(te) == len(je) == 1500 and 9 not in te and 3000 in te
    assert te.snapshot_count == 1 and MAX_TOP_K == 10_000
    # a tensor query is accepted too, and the snapshot is reused
    tv2, _ = te.search(torch.from_numpy(q), 10)
    np.testing.assert_array_equal(tv2, te.search(q, 10)[0])
    assert te.snapshot_count == 1


def test_euclidean_xla_and_auto(rng):
    vecs = rng.standard_normal((3000, D)).astype(np.float32)
    js, ts = _pair(4096, Similarity.EUCLIDEAN, vecs, False)
    q = rng.standard_normal((5, D)).astype(np.float32)
    jv, jr, _ = _run(jax_scan, q, js, 7, "auto")
    tv, tr, _ = _run(fs.flat_scan_topk, q, ts, 7, "auto")
    np.testing.assert_array_equal(jr, tr)
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        fs.flat_scan_topk(torch.from_numpy(q), ts, 7, backend="pallas")


@pytest.mark.parametrize("backend", ["chunkmax", "pallas_packed"])
def test_unported_backends_raise(exact_snaps, backend):
    """pallas_packed (K9), once unported and raising, is ported: its results equal the
    JAX package's pallas_packed on random cosine data, scores truncated alike. chunkmax
    (K6 + K7) raises only where the JAX package's does, on a tombstoned index
    (tests/test_torch_chunkmax.py holds its results against the JAX package's)."""
    if backend == "chunkmax":
        _, ts = exact_snaps[(4096, True)]
        with pytest.raises(ValueError, match="contiguous"):
            fs.flat_scan_topk(torch.zeros(2, D), ts, 5, backend=backend)
        return
    rng = np.random.default_rng(6)
    js, ts = _pair(4096, Similarity.COSINE, rng.standard_normal((3000, D)).astype(np.float32), True)
    q = np.asarray(fs.normalize_rows(torch.from_numpy(rng.standard_normal((9, D)).astype(np.float32))))
    before = fs.K9_LAUNCHES
    jv, jr, jf = _run(jax_scan, q, js, 12, backend)
    tv, tr, tf = _run(fs.flat_scan_topk, q, ts, 12, backend)
    assert fs.K9_LAUNCHES == before  # the plain twin ran on the CPU
    # scores differ in the last f32 bits (summation order); the 2^-12 truncation keeps
    # them equal unless one straddles a truncation step
    np.testing.assert_allclose(tv, jv, rtol=2.0**-11, atol=1e-6)
    assert _overlap(tr, jr) >= 0.99 and _overlap(tf, jf) >= 0.99
    sel = _run(fs.flat_scan_topk, q, ts, 12, "pallas_packed_sel")
    for a, b in zip(sel, (tv, tr, tf)):
        np.testing.assert_array_equal(a, b)


def test_auto_policy_matches_jax_thresholds(exact_snaps):
    """auto -> xla for k > 128 and small capacities; the k clamp to capacity."""
    js, ts = exact_snaps[(4096, False)]
    q = _grid(np.random.default_rng(3), (3, D))
    for k in (129, 5000):
        want, got = _run(jax_scan, q, js, k, "auto"), _run(fs.flat_scan_topk, q, ts, k, "auto")
        for w, g in zip(want, got):
            np.testing.assert_array_equal(w, g)
    js2, ts2 = _pair(1024, Similarity.DOT, _grid(np.random.default_rng(4), (900, D)), False)
    want, got = _run(jax_scan, q, js2, 10, "auto"), _run(fs.flat_scan_topk, q, ts2, 10, "auto")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(w, g)


def test_kernel_wrappers_cpu_use_plain_twin_and_do_not_count(exact_snaps):
    _, ts = exact_snaps[(4096, True)]
    q = torch.from_numpy(_grid(np.random.default_rng(5), (4, D)))
    bias = fs._index_bias(ts)
    k1, k2 = fs.K1_LAUNCHES, fs.K2_LAUNCHES
    keys = fs.packed_sel_tiles(q, ts.emb, bias, 10, 2048)
    vals, rows = fs.scan_topk_tiles(q, ts.emb, bias, 10, 2048)
    assert (fs.K1_LAUNCHES, fs.K2_LAUNCHES) == (k1, k2)
    assert keys.shape == vals.shape == rows.shape == (4, 2 * 10)
    torch.testing.assert_close(keys, fs._packed_sel_topk_plain(q, ts.emb, bias, 10, 2048), rtol=0, atol=0)
    # each tile's list is sorted by (score desc, column asc)
    v3 = vals.reshape(4, 2, 10)
    assert bool((v3[..., :-1] >= v3[..., 1:]).all())


def test_packed_key_roundtrip():
    """Decoded packed keys give the score truncated toward -inf and the global row;
    NEG_INF rows decode below NEG_INF / 2."""
    s = torch.tensor([[0.5, -0.25, 1e-3, -3.0e38, 0.0, 7.0, -7.0, 2.0]], dtype=torch.float32)
    keys = fs._packed_keys(s, 4)
    vals, rows = fs._decode_packed(keys, 4, 4)
    assert rows.tolist() == [[0, 1, 2, 3, 4, 5, 6, 7]]
    assert bool((vals <= s).all()) and bool(((s - vals).abs() <= s.abs() * 2.0**-12).all())
    assert float(vals[0, 3]) <= fs.NEG_INF * 0.5


def test_kernel_arguments_are_validated():
    q, emb, bias = torch.zeros(4, 8), torch.zeros(1024, 8), torch.zeros(1024)
    fs._check_kernel_args(q, emb, bias, 10, 512)
    bad = [
        (q, emb.double(), bias, 10, 512),  # dtype mismatch
        (q, emb, bias[:-1], 10, 512),  # bias length
        (q, emb.t().contiguous().t(), bias, 10, 512),  # non-contiguous
        (q, emb, bias, 0, 512),  # k < 1
        (q, emb, bias, 129, 512),  # k > 128
        (q, emb, bias, 10, 4096),  # tile wider than the 11 column bits
        (q, emb[:1000], bias[:1000], 10, 512),  # tile does not divide N
        (q[:, :4], emb, bias, 10, 512),  # dim mismatch
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fs._check_kernel_args(*args)
    with pytest.raises(ValueError, match="CPU or on one CUDA device"):
        fs.packed_sel_tiles(q.to("meta"), emb.to("meta"), bias.to("meta"), 10, 512)
