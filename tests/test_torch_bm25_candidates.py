"""The budgeted BM25 lane: candidate generation and the exact rescore, against wax_tpu.

Same snapshots (both packages' builders over the same texts and budget), same
padded term ids, through each package's function:

* `merge_sorted_runs`, `segment_sum_sorted`, `candidate_scores_sorted` and
  `wide_topk` (both `exact` settings): rows and positions EQUAL, scores BIT-equal
  (the port runs the same bitonic network and Hillis-Steele order).
* `exact_rescore_fused`, `exact_rescore`, `rescore_topk`, `bm25_candidates_topk`:
  ids equal, scores within rtol 1e-6 (the final lane sum runs in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index import lex as jlex
from wax_tpu.ops import bm25_candidates as jbc
from wax_tpu.ops import bm25_rescore as jbr
from wax_tpu.ops.bm25 import pad_term_ids
from wax_tpu_torch.index import lex as tlex
from wax_tpu_torch.ops import bm25_candidates as tbc
from wax_tpu_torch.ops import bm25_rescore as tbr

WORDS = [f"t{i}" for i in range(48)]


def _docs(n, seed):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    p /= p.sum()
    return [(i, " ".join(WORDS[j] for j in rng.choice(len(WORDS), rng.integers(2, 14), p=p))) for i in range(n)]


@pytest.fixture(scope="module")
def snaps():
    out = {}
    for budget in (None, 9):
        jb, tb = jlex.LexIndexBuilder(postings_budget=budget), tlex.LexIndexBuilder(postings_budget=budget)
        docs = _docs(360, seed=4)
        jb.add_batch(docs)
        tb.add_batch(docs)
        for fid in (5, 77, 301):
            jb.remove(fid)
            tb.remove(fid)
        out[budget] = (jb.snapshot(), tb.snapshot(device="cpu"), tb)
    return out


def _tids(tb, n_terms, seed, b=6):
    rng = np.random.default_rng(seed)
    rows = [pad_term_ids(tb.term_ids([WORDS[j] for j in rng.choice(len(WORDS), n_terms, replace=False)]),
                         max_terms=max(n_terms, 1)) for _ in range(b)]
    return np.stack(rows)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize("run_len", [1, 4, 32])
def test_merge_and_segment_sum_bit_equal(run_len):
    rng = np.random.default_rng(run_len)
    n = 256
    rows = np.sort(rng.integers(0, 40, (3, n // run_len, run_len)), axis=-1).reshape(3, n).astype(np.int32)
    vals = rng.random((3, n)).astype(np.float32)
    cnts = np.ones((3, n), np.int32)
    j = jbc.merge_sorted_runs(jnp.asarray(rows), jnp.asarray(vals), jnp.asarray(cnts), run_len)
    t = tbc.merge_sorted_runs(torch.from_numpy(rows), torch.from_numpy(vals), torch.from_numpy(cnts), run_len)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(_np(b), np.asarray(a))
    js = jbc.segment_sum_sorted(*j, 8)
    ts = tbc.segment_sum_sorted(*t, 8)
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(_np(b), np.asarray(a))


@pytest.mark.parametrize("budget", [None, 9])
@pytest.mark.parametrize("mode", ["any", "all", "count"])
@pytest.mark.parametrize("n_terms", [1, 3, 5, 16])
def test_candidate_scores_sorted_bit_equal(snaps, budget, mode, n_terms):
    js, ts, tb = snaps[budget]
    tids = _tids(tb, n_terms, seed=n_terms)
    jr, jsc = jbc.candidate_scores_sorted(jnp.asarray(tids), js.doc_rows, js.wnorm, js.offsets, js.idf,
                                          int(js.max_df), mode)
    tr, tsc = tbc.candidate_scores_sorted(torch.from_numpy(tids), ts.doc_rows, ts.wnorm, ts.offsets, ts.idf,
                                          int(ts.max_df), mode)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tsc.numpy().view(np.int32), np.asarray(jsc).view(np.int32))


@pytest.mark.parametrize("exact", [True, False])
@pytest.mark.parametrize("k", [5, 100, 300])
def test_wide_topk_equal(exact, k):
    """Quantized scores on a wide plane: ties everywhere, so lane collisions (exact =
    False keeps only ceil(k/128)+2 per lane) decide which candidates survive."""
    rng = np.random.default_rng(k)
    scores = (rng.integers(0, 50, (4, 8192)) / 8.0).astype(np.float32)
    scores[rng.random((4, 8192)) < 0.3] = -3.0e38
    jv, jp = jbc.wide_topk(jnp.asarray(scores), k, exact=exact)
    tv, tp = tbc.wide_topk(torch.from_numpy(scores), k, exact=exact)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def test_wide_topk_narrow_plane_pads():
    scores = np.arange(12, dtype=np.float32).reshape(2, 6)
    jv, jp = jbc.wide_topk(jnp.asarray(scores), 9)
    tv, tp = tbc.wide_topk(torch.from_numpy(scores), 9)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))


def _cands(tb, ts, seed, f=40):
    rng = np.random.default_rng(seed)
    n = int(ts.count)
    rows = rng.integers(0, n, (6, f)).astype(np.int32)
    rows[rng.random((6, f)) < 0.2] = -1
    return rows


@pytest.mark.parametrize("n_terms", [1, 4, 16])
def test_exact_rescore_fused_and_plain_equal(snaps, n_terms):
    js, ts, tb = snaps[9]
    tids = _tids(tb, n_terms, seed=10 + n_terms)
    cand = _cands(tb, ts, seed=n_terms)
    jv, jc = jbr.exact_rescore_fused(jnp.asarray(tids), jnp.asarray(cand), js.fwd_fused, js.idf)
    tv, tc = tbr.exact_rescore_fused(torch.from_numpy(tids), torch.from_numpy(cand), ts.fwd_fused, ts.idf)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    jv2, jc2 = jbr.exact_rescore(jnp.asarray(tids), jnp.asarray(cand), js.fwd_tids, js.fwd_wnorm, js.idf,
                                 fwd_width=js.fwd_width)
    tv2, tc2 = tbr.exact_rescore(torch.from_numpy(tids), torch.from_numpy(cand), ts.fwd_tids, ts.fwd_wnorm,
                                 ts.idf, fwd_width=ts.fwd_width)
    np.testing.assert_array_equal(tc2.numpy(), np.asarray(jc2))
    np.testing.assert_allclose(tv2.numpy(), np.asarray(jv2), rtol=1e-6, atol=0)


@pytest.mark.parametrize("form", ["narrow", "wide", "wide_odd_f"])
@pytest.mark.parametrize("n_terms", [1, 4, 16])
def test_exact_rescore_k5_equals_jax_and_the_fused_route(snaps, form, n_terms):
    """exact_rescore (K5's plain twin here) against the JAX package's K5 in its narrow
    form (fwd_width <= 64 packs two candidates per row) and its wide form (width
    unknown, or an odd candidate count), and bit-equal to the fused route (K3)."""
    js, ts, tb = snaps[9]
    assert 0 < ts.fwd_width <= 64
    tids = _tids(tb, n_terms, seed=40 + n_terms)
    cand = _cands(tb, ts, seed=n_terms, f=41 if form == "wide_odd_f" else 40)
    width = 0 if form == "wide" else ts.fwd_width
    before = tbr.K5_LAUNCHES
    jv, jc = jbr.exact_rescore(jnp.asarray(tids), jnp.asarray(cand), js.fwd_tids, js.fwd_wnorm, js.idf,
                               fwd_width=width)
    tv, tc = tbr.exact_rescore(torch.from_numpy(tids), torch.from_numpy(cand), ts.fwd_tids, ts.fwd_wnorm, ts.idf,
                               fwd_width=width)
    assert tbr.K5_LAUNCHES == before
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    fv, fc = tbr.exact_rescore_fused(torch.from_numpy(tids), torch.from_numpy(cand), ts.fwd_fused, ts.idf)
    assert torch.equal(tv, fv) and torch.equal(tc, fc)
    assert (tc.numpy() > 0).any()


@pytest.mark.parametrize("mode", ["any", "all"])
@pytest.mark.parametrize("fused", [True, False])
def test_rescore_topk_equal(snaps, mode, fused):
    js, ts, tb = snaps[9]
    tids = _tids(tb, 3, seed=21)
    cand = _cands(tb, ts, seed=22, f=64)
    jv, jr = jbr.rescore_topk(jnp.asarray(tids), jnp.asarray(cand), js.fwd_tids, js.fwd_wnorm, js.idf, 10, mode,
                              fwd_width=js.fwd_width, fwd_fused=js.fwd_fused if fused else None)
    tv, tr = tbr.rescore_topk(torch.from_numpy(tids), torch.from_numpy(cand), ts.fwd_tids, ts.fwd_wnorm, ts.idf,
                              10, mode, fwd_width=ts.fwd_width, fwd_fused=ts.fwd_fused if fused else None)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)


@pytest.mark.parametrize("budget", [None, 9])
@pytest.mark.parametrize("mode", ["any", "all"])
@pytest.mark.parametrize("k", [4, 24])
def test_bm25_candidates_topk_equal(snaps, budget, mode, k):
    js, ts, tb = snaps[budget]
    tids = np.concatenate([_tids(tb, 2, seed=31), _tids(tb, 6, seed=32)[:, :2]])
    jv, jr, jf = jbc.bm25_candidates_topk(jnp.asarray(tids), js, k, mode=mode)
    tv, tr, tf = tbc.bm25_candidates_topk(torch.from_numpy(tids), ts, k, mode=mode)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert (tf.numpy()[:, 0] >= 0).any()


def test_rescore_wrapper_cpu_uses_plain_and_does_not_count(snaps):
    _, ts, tb = snaps[9]
    tids_q, idf_q = tbr._query_planes(torch.from_numpy(_tids(tb, 4, seed=3)), ts.idf)
    cand = torch.from_numpy(_cands(tb, ts, seed=3))
    before = tbr.K3_LAUNCHES
    got = tbr.rescore_fused(ts.fwd_fused, cand, tids_q.contiguous(), idf_q.contiguous())
    want = tbr._rescore_fused_plain(ts.fwd_fused, cand, tids_q, idf_q)
    assert tbr.K3_LAUNCHES == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)
