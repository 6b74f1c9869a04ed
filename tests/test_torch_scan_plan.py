"""K1 and K2's cluster split, on the CPU: `flat_scan.scan_plan`'s choices, a plain model
of the split, and the port against the JAX package where the split is widest.

On the card K1 and K2 split each (64-query block, tile) pair over a cluster of S CTAs
(S in {1, 2, 4, 8}), each selecting over tn / S rows with keys on the tile-local
column, and merge the S sorted lists into the tile's list. The model below does the
same in plain torch and must give the plain twins' tile lists for every S; the CUDA
kernels themselves are held to the twins in tests/test_torch_cuda_kernels.py.
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
from wax_tpu_torch.ops.topk import stable_top_k

H100_SMS = 132


@pytest.mark.parametrize("sms", [H100_SMS, 114, 16])
@pytest.mark.parametrize("n", [2048, 10240, 32768, 131072])
@pytest.mark.parametrize("b", [1, 13, 256, 300])
def test_scan_plan_fills_the_card(sms, n, b):
    tn = fs._pick_tn(n)
    for k in (1, 10, 24, 100, 128):
        p = fs.scan_plan(b, n, tn, k, sms)
        s, pairs = p["split"], -(-b // 64) * (n // tn)
        assert s in (1, 2, 4, 8) and (tn // 128) % s == 0
        assert p["grid"] == (s, -(-b // 64), n // tn) and p["ctas"] == pairs * s
        if pairs * 8 >= sms:  # S 8 would reach the card: the least split that does
            assert p["ctas"] >= sms and (s == 1 or pairs * (s // 2) < sms)
        else:
            assert s == 8
        assert p == fs.scan_plan(b, n, tn, k, sms)  # plain and deterministic


def test_scan_plan_at_the_serving_shapes():
    """B 256 on 132 SMs: S 8 at 10,240 rows (160 CTAs), S 4 at exact_30k's 32,768-row
    capacity (256), S 1 at 131,072 (256); a narrow tile caps the split."""
    for n, split, ctas in ((10240, 8, 160), (32768, 4, 256), (131072, 1, 256)):
        p = fs.scan_plan(256, n, 2048, 24, H100_SMS)
        assert (p["split"], p["ctas"]) == (split, ctas)
    assert fs.scan_plan(1, 512, 512, 10, H100_SMS)["split"] == 4
    assert fs.scan_plan(1, 384, 384, 10, H100_SMS)["split"] == 1
    with pytest.raises(ValueError):
        fs.scan_plan(256, 10240, 2048, 129, H100_SMS)


def _split_model(q, emb, bias, k, tn, split, exact):
    """What the split kernel computes, in plain torch: per sub-tile of tn / split rows
    the k best by tile-local key, then per tile the k best of the split's lists."""
    b, n = q.shape[0], emb.shape[0]
    nn, sub = n // tn, tn // split
    scores = fs.scores_f32(q, emb) + bias[None, :]
    if exact:  # (score desc, column asc): stable top-k, lists concatenated in column order
        sv, sc = stable_top_k(scores.reshape(b, nn, split, sub), k)
        cols = sc + (torch.arange(split) * sub)[None, None, :, None]
        mv, pos = stable_top_k(sv.reshape(b, nn, split * k), k)
        rows = torch.gather(cols.reshape(b, nn, split * k), 2, pos) + (torch.arange(nn) * tn)[None, :, None]
        return mv.reshape(b, -1), rows.to(torch.int32).reshape(b, -1)
    keys = fs._packed_keys(scores, tn).reshape(b, nn, split, sub)  # keys on the tile-local column
    lists = torch.sort(keys, dim=-1, descending=True).values[..., :k]
    merged = torch.sort(lists.reshape(b, nn, split * k), dim=-1, descending=True).values[..., :k]
    return merged.reshape(b, -1)


@pytest.mark.parametrize("data", ["grid", "random"])
@pytest.mark.parametrize("b,k,n,tn,d", [(13, 10, 10240, 2048, 16), (5, 128, 2048, 1024, 8),
                                        (64, 24, 4096, 2048, 37), (3, 1, 1536, 512, 8)])
def test_split_model_equals_plain_twins(data, b, k, n, tn, d):
    rng = np.random.default_rng(b + k + n + d)
    if data == "grid":  # multiples of 1/8: exact sums, many ties
        q, emb = (torch.from_numpy((rng.integers(-8, 9, s) / 8).astype(np.float32)) for s in ((b, d), (n, d)))
    else:
        q, emb = (fs.normalize_rows(torch.from_numpy(rng.standard_normal(s).astype(np.float32)))
                  for s in ((b, d), (n, d)))
    bias = torch.zeros(n)
    bias[rng.permutation(n)[: n // 10]] = fs.NEG_INF
    want_keys = fs._packed_sel_topk_plain(q, emb, bias, k, tn)
    want_vals, want_rows = fs._scan_topk_plain(q, emb, bias, k, tn)
    for split in (s for s in (1, 2, 4, 8) if tn % (128 * s) == 0):
        assert torch.equal(_split_model(q, emb, bias, k, tn, split, False), want_keys), split
        vals, rows = _split_model(q, emb, bias, k, tn, split, True)
        assert torch.equal(vals, want_vals) and torch.equal(rows, want_rows), split


@pytest.fixture(scope="module")
def snaps_10k():
    """Capacity 10,240 (5 tiles of 2,048; S 8 for any batch on an H100) at d 16."""
    rng = np.random.default_rng(7)
    out = {}
    for kind, sim in (("grid", Similarity.DOT), ("random", Similarity.COSINE)):
        vecs = (rng.integers(-8, 9, (10_000, 16)) / 8).astype(np.float32) if kind == "grid" else \
            rng.standard_normal((10_000, 16)).astype(np.float32)
        jb, tb = JaxBuilder(16, sim, capacity=10_240), TorchBuilder(16, sim, capacity=10_240)
        jb.add_batch(np.arange(10_000), vecs)
        tb.add_batch(np.arange(10_000), vecs)
        for r in (3, 2047, 2048, 9000):
            assert jb.remove(r) and tb.remove(r)
        out[kind] = (jb.snapshot(), tb.snapshot(device="cpu"))
    return out


@pytest.mark.parametrize("k", [1, 10, 24])
def test_port_equals_jax_at_10240_rows(snaps_10k, k):
    """The port's K2 (`pallas`) and K1 (`pallas_packed_sel`) against the JAX package's
    Pallas kernels in interpret mode: equal on exact-arithmetic data (K1 against JAX's
    exact packed-key kernel, overlap with JAX's lookahead K1); on random data K2's
    scores within 1e-5 and ids equal up to near-ties."""
    assert fs.scan_plan(13, 10_240, 2048, k, H100_SMS)["split"] == 8
    js, ts = snaps_10k["grid"]
    rng = np.random.default_rng(k)
    q = (rng.integers(-8, 9, (13, 16)) / 8).astype(np.float32)

    def run(scan, snap, qq, backend):
        if scan is jax_scan:
            return [np.asarray(x) for x in jax_scan(jnp.asarray(qq), snap, k, backend=backend)]
        return [x.numpy() for x in fs.flat_scan_topk(torch.from_numpy(qq), snap, k, backend=backend)]

    for jb, tb in (("pallas", "pallas"), ("pallas_packed", "pallas_packed_sel")):
        for w, g in zip(run(jax_scan, js, q, jb), run(fs.flat_scan_topk, ts, q, tb)):
            np.testing.assert_array_equal(w, g, err_msg=f"{jb} vs {tb}")
    sel = run(jax_scan, js, q, "pallas_packed_sel")[1]
    got = run(fs.flat_scan_topk, ts, q, "pallas_packed_sel")[1]
    assert np.mean([len(set(a) & set(b)) / k for a, b in zip(sel, got)]) >= 0.999

    js, ts = snaps_10k["random"]
    qr = np.asarray(fs.normalize_rows(torch.from_numpy(rng.standard_normal((13, 16)).astype(np.float32))))
    jv, jr, _ = run(jax_scan, js, qr, "pallas")
    tv, tr, _ = run(fs.flat_scan_topk, ts, qr, "pallas")
    np.testing.assert_allclose(tv, jv, atol=1e-5, rtol=0)
    exact = qr @ np.asarray(js.emb).T
    for i in range(len(qr)):
        for r in set(jr[i]) ^ set(tr[i]):
            assert abs(exact[i, r] - jv[i, -1]) <= 1e-5
