"""The chunk-max scan (kernels K6 + K7) against wax_tpu's, whose Pallas kernels run in
interpret mode here; the port's wrappers run their plain twins on CPU tensors.

Exact-arithmetic data (entries k/8 in [-1, 1]: every dot product is exact in f32 and
in bf16 storage, ties are common): chunk maxima, top-k scores and ids must be EQUAL,
on f32 and bf16 corpora, with a dead tail (the live rows form a prefix) and with k
larger than the corpus' chunk count. K7 breaks ties by the lowest flat position in
PROBE-RANK order, not by the lowest row: duplicate vectors in differently ranked
buckets show which wins.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index.dense import DenseIndexBuilder as JaxBuilder
from wax_tpu.index.dense import Similarity
from wax_tpu.ops import chunkmax_scan as jcm
from wax_tpu.ops import ivf_kernel as jivf
from wax_tpu.ops.flat_scan import flat_scan_topk as jax_scan
from wax_tpu_torch.index.dense import DenseIndexBuilder as TorchBuilder
from wax_tpu_torch.ops import chunkmax_scan as tcm
from wax_tpu_torch.ops import flat_scan as fs
from wax_tpu_torch.ops import ivf_kernel as tivf
from wax_tpu_torch.utils.profiling import counters

D = 64
NEG_INF = -3.0e38
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _grid(rng, shape):
    return (rng.integers(-8, 9, shape) / 8.0).astype(np.float32)


def _inputs(seed, n, live, b=5):
    rng = np.random.default_rng(seed)
    emb, q = _grid(rng, (n, D)), _grid(rng, (b, D))
    bias = np.where(np.arange(n) < live, 0.0, NEG_INF).astype(np.float32)
    return q, emb, bias


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("n,live,k", [(2048, 2048, 10), (2048, 1800, 20), (4096, 4000, 7), (4096, 4096, 40)])
def test_chunkmax_scan_topk_equal(dtype, n, live, k):
    jd, td = DTYPES[dtype]
    q, emb, bias = _inputs(n + k, n, live)
    jv, jr = jcm.chunkmax_scan_topk(jnp.asarray(q), jnp.asarray(emb).astype(jd), jnp.asarray(bias)[None, :], k)
    tv, tr = tcm.chunkmax_scan_topk(torch.from_numpy(q), torch.from_numpy(emb).to(td), torch.from_numpy(bias), k)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (tr.numpy() < live).all()


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunk_maxima_equal(dtype):
    jd, td = DTYPES[dtype]
    q, emb, bias = _inputs(3, 4096, 3900, b=9)
    jq = jnp.asarray(q).astype(jd)
    tb = 16  # the JAX wrapper's query block for 9 queries, rounded up to 8s
    jpad = jnp.pad(jq, ((0, tb - 9), (0, 0)))
    cm = jcm._chunk_maxima(jpad, jnp.asarray(emb).astype(jd), jnp.asarray(bias)[None, :], tb, 2048, True)
    want = np.asarray(cm)[:9].reshape(9, 2, 128)[:, :, :16].reshape(9, 32)
    got = tcm.chunk_maxima(torch.from_numpy(q).to(td), torch.from_numpy(emb).to(td), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("b,d", [(1, 64), (129, 128), (200, 384), (300, 64), (256, 768)])
def test_chunk_maxima_edge_shapes_equal(dtype, b, d):
    """K6's function at the edges of its bf16 tile (B 1 to 300: one or two query blocks
    of 128 or 256; d 64 to 768) and a dead tail, against the TPU kernel run the way
    the JAX wrapper runs it (query block min(256, B rounded up to 8))."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(b + d)
    n = 4096
    emb, q = _grid(rng, (n, d)), _grid(rng, (b, d))
    bias = np.where(np.arange(n) < n - 200, 0.0, NEG_INF).astype(np.float32)
    tb = min(256, (b + 7) // 8 * 8)
    jq = jnp.pad(jnp.asarray(q).astype(jd), ((0, -b % tb), (0, 0)))
    cm = jcm._chunk_maxima(jq, jnp.asarray(emb).astype(jd), jnp.asarray(bias)[None, :], tb, 2048, True)
    want = np.asarray(cm)[:b].reshape(b, 2, 128)[:, :, :16].reshape(b, 32)
    got = tcm.chunk_maxima(torch.from_numpy(q).to(td), torch.from_numpy(emb).to(td), torch.from_numpy(bias))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("k", [1, 10, 128])
def test_flat_scan_chunkmax_backend_equal(dtype, k):
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(k)
    vecs = _grid(rng, (3500, D))
    jb, tb = JaxBuilder(D, Similarity.DOT, capacity=4096), TorchBuilder(D, Similarity.DOT, capacity=4096)
    jb.add_batch(np.arange(3500) + 10, vecs)
    tb.add_batch(np.arange(3500) + 10, vecs)
    js, ts = jb.snapshot(device_dtype=jd), tb.snapshot(device="cpu", device_dtype=td)
    assert ts.contiguous and ts.capacity == 4096
    q = _grid(rng, (6, D))
    want = jax_scan(jnp.asarray(q), js, k, backend="chunkmax")
    got = fs.flat_scan_topk(torch.from_numpy(q), ts, k, backend="chunkmax")
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_k7_ties_follow_probe_rank_not_row():
    """Bucket 5 and bucket 1 hold the same vectors; probing 5 before 1 must return
    bucket 5's rows first on every tie (the row-order rule would pick bucket 1)."""
    rng = np.random.default_rng(0)
    c, s = 8, 128
    emb3 = _grid(rng, (c, s, D))
    emb3[1] = emb3[5]
    counts = np.full(c, s, np.int32)
    counts[3] = 40  # a partly filled bucket: its tail scores NEG_INF
    # the JAX kernel serves queries in groups of 8
    probes = np.array([[5, 1, 3, 0], [1, 5, 7, 3], [3, 2, 5, 1], [0, 2, 4, 6]] * 2, np.int32)
    q = _grid(rng, (8, D))
    ids2 = np.arange(c * s, dtype=np.int32).reshape(c, s)
    k = 30
    jv, ji = jivf._run(jnp.asarray(q), jnp.asarray(probes), jnp.asarray(counts), jnp.asarray(emb3),
                       jnp.asarray(ids2), k, 4, True)
    tv, ti = tivf.ivf_rescore(torch.from_numpy(q), torch.from_numpy(probes), torch.from_numpy(counts),
                              torch.from_numpy(emb3), torch.from_numpy(ids2), k)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    checked = 0
    for b, pr in enumerate(probes.tolist()):
        if 5 not in pr or 1 not in pr:
            continue
        got = ti.numpy()[b].tolist()
        early, late = (5, 1) if pr.index(5) < pr.index(1) else (1, 5)
        for r in range(s):
            if ids2[late, r] in got:  # the later-probed copy only after the earlier one
                assert ids2[early, r] in got and got.index(ids2[early, r]) < got.index(ids2[late, r])
                checked += 1
    assert checked > 0
    assert not np.isin(ti.numpy(), ids2[3, 40:]).any()


def test_k7_wrapper_cpu_uses_plain_and_does_not_count():
    rng = np.random.default_rng(1)
    emb3 = torch.from_numpy(_grid(rng, (4, 128, D)))
    q = torch.from_numpy(_grid(rng, (2, D)))
    probes = torch.tensor([[2, 0], [1, 3]], dtype=torch.int32)
    counts = torch.full((4,), 128, dtype=torch.int32)
    k6, k7 = counters().get("wax_k6_chunk_maxima", 0), counters().get("wax_k7_bucket_rescore", 0)
    vals, pos = tivf.bucket_rescore(q, probes, counts, emb3, 5)
    tcm.chunk_maxima(q, emb3.reshape(512, D), torch.zeros(512))
    assert (counters().get("wax_k6_chunk_maxima", 0), counters().get("wax_k7_bucket_rescore", 0)) == (k6, k7)
    assert vals.shape == pos.shape == (2, 5) and pos.dtype == torch.int32
    with pytest.raises(ValueError, match="k=300"):
        tivf._check_args(q, probes, counts, emb3, 300)
