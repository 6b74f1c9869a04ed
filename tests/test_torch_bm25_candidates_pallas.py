"""The unchunked candidate kernel K8 and its top-k against wax_tpu's, on the CPU.

The port's `candidate_scores_pallas` runs its plain twin on CPU tensors; the JAX
package's runs its Pallas kernel in interpret mode, on the same postings (the JAX
side gets them padded for its DMA window, with its reversed copies). Windows are
small (max_df <= 1,024); queries of 3 and 16 slots, with padded slots, -1 ids, a
duplicated id and an empty query; modes any / all / count; sel 0 and 3.

* Exact-arithmetic weights (multiples of 1/8, some 0 as on tombstoned rows; idf 1):
  both outputs IDENTICAL, plane and sel arrays alike.
* Random weights and idf: identical leader positions and rows, scores within rtol
  1e-6 (the port sums a row's postings in query-slot order, the TPU kernel in merge
  network order).
* `bm25_candidates_topk_pallas` on unbudgeted and budgeted snapshots, the latter with
  impact chunks (K4) and without (K8 with in-kernel selection): ids equal, scores
  within rtol 1e-6.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index import lex as jlex
from wax_tpu.ops import bm25_candidates_pallas as jk
from wax_tpu.ops.bm25 import pad_term_ids
from wax_tpu_torch.index import lex as tlex
from wax_tpu_torch.ops import bm25_candidates_pallas as tk

N_ROWS, N_TERMS = 3000, 12


@pytest.fixture(scope="module")
def postings():
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 900, N_TERMS)
    sizes[3] = 0  # a term without postings
    rows = np.concatenate([np.sort(rng.choice(N_ROWS, m, replace=False)) for m in sizes]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    max_df = int(((sizes.max() + 127) // 128) * 128)
    data = {}
    for kind in ("exact", "random"):
        if kind == "exact":
            wn = (rng.integers(0, 9, len(rows)) / 8.0).astype(np.float32)
            idf = np.ones(N_TERMS, np.float32)
        else:
            wn = rng.random(len(rows)).astype(np.float32)
            idf = (rng.random(N_TERMS) + 0.5).astype(np.float32)
        data[kind] = (wn, idf)
    return rows, offsets, max_df, data


def _queries(q, seed):
    rng = np.random.default_rng(seed)
    tids = rng.integers(-1, N_TERMS, (5, q)).astype(np.int32)
    tids[1, -1] = tids[1, 0] = 7  # a duplicated term counts once per slot
    tids[2] = -1  # an empty query
    return tids


def _jax_run(rows, offsets, wn, idf, tids, max_df, mode, sel):
    w2 = jlex.dma_window(max_df)
    p = len(rows)
    padded = ((p + w2 + 1023) // 1024) * 1024
    rp = np.zeros(padded, np.int32)
    wp = np.zeros(padded, np.float32)
    rp[:p], wp[:p] = rows, wn
    rr, wr = jlex.reverse_postings_copies(rp, wp, offsets)
    out = jk.candidate_scores_pallas(jnp.asarray(tids), jnp.asarray(rp), jnp.asarray(wp), jnp.asarray(offsets),
                                     jnp.asarray(idf), jnp.asarray(rr), jnp.asarray(wr), max_df=max_df, mode=mode,
                                     sel=sel)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("sel", [0, 3])
@pytest.mark.parametrize("mode", ["any", "all", "count"])
@pytest.mark.parametrize("q", [3, 16])
@pytest.mark.parametrize("kind", ["exact", "random"])
def test_k8_equals_jax(postings, kind, q, mode, sel):
    rows, offsets, max_df, data = postings
    wn, idf = data[kind]
    tids = _queries(q, seed=q)
    jr, js = _jax_run(rows, offsets, wn, idf, tids, max_df, mode, sel)
    before = tk.K8_LAUNCHES
    tr, ts = tk.candidate_scores_pallas(torch.from_numpy(tids), torch.from_numpy(rows), torch.from_numpy(wn),
                                        torch.from_numpy(offsets), torch.from_numpy(idf), max_df=max_df, mode=mode,
                                        sel=sel)
    assert tk.K8_LAUNCHES == before  # the plain twin ran: no launch counted
    assert tr.shape == jr.shape and ts.shape == js.shape and ts.dtype == (torch.int32 if sel else torch.float32)
    np.testing.assert_array_equal(tr.numpy(), jr)
    if kind == "exact":
        np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))
    elif sel == 0:
        np.testing.assert_allclose(ts.numpy(), js, rtol=1e-6, atol=0)
    else:  # keys keep 10 mantissa bits: a last-bit difference moves one only at a boundary
        assert np.mean(ts.numpy() == js) >= 0.999
    assert (tr.numpy()[2] == -1).all()
    assert (tr.numpy() >= 0).any() or mode == "all"  # 16 random terms rarely meet in a row


def test_k8_duplicate_documents_tie_to_the_lowest_row():
    """Rows 5 and 9 hold the same postings: their slot-order sums are equal to the
    bit, so the stable top-k ranks the lower row first."""
    rng = np.random.default_rng(3)
    per_term = [np.array([1, 5, 9, 20]), np.array([5, 9, 11]), np.array([0, 5, 9])]
    rows = np.concatenate(per_term).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum([len(r) for r in per_term])]).astype(np.int32)
    wn = rng.random(len(rows)).astype(np.float32)
    for t in range(3):  # rows 5 and 9 get equal weights in every term
        a = offsets[t]
        sl = rows[a:offsets[t + 1]]
        wn[a + np.flatnonzero(sl == 9)[0]] = wn[a + np.flatnonzero(sl == 5)[0]]
    idf = (rng.random(3) + 0.5).astype(np.float32)
    tids = torch.tensor([[0, 1, 2]], dtype=torch.int32)
    r, s = tk.candidate_scores_pallas(tids, torch.from_numpy(rows), torch.from_numpy(wn), torch.from_numpy(offsets),
                                      torch.from_numpy(idf), max_df=128)
    live = r[0] >= 0
    got = dict(zip(r[0][live].tolist(), s[0][live].tolist()))
    assert got[5] == got[9]
    vals, pos = tk.wide_topk(s, 2)
    assert r[0][pos[0]].tolist() == [5, 9]


def test_k8_wrapper_validates_its_arguments(postings):
    rows, offsets, max_df, data = postings
    args = (torch.from_numpy(rows), torch.from_numpy(data["exact"][0]), torch.from_numpy(offsets),
            torch.from_numpy(data["exact"][1]))
    with pytest.raises(ValueError, match="mode"):
        tk.candidate_scores_pallas(torch.zeros((1, 2), dtype=torch.int32), *args, max_df=max_df, mode="some")
    with pytest.raises(ValueError, match="13 chunk bits"):
        tk.candidate_scores_pallas(torch.zeros((1, 16), dtype=torch.int32), *args, max_df=600_000, sel=3)
    with pytest.raises(ValueError, match="2\\^31"):
        tk.candidate_scores_pallas(torch.zeros((1, 16), dtype=torch.int32), *args, max_df=2**27)
    with pytest.raises(ValueError, match="sel"):
        tk.candidate_scores_pallas(torch.zeros((1, 2), dtype=torch.int32), *args, max_df=max_df, sel=5)
    for m in (0, 1, 1023, 1024, 1025, 31_744, 31_745):
        assert tk.dma_window(m) == jlex.dma_window(m)


# ----------------------------------------------------------------------- the wrapper

WORDS = [f"t{i}" for i in range(48)]


@pytest.fixture(scope="module")
def snaps():
    rng = np.random.default_rng(4)
    p = 1.0 / np.arange(1, len(WORDS) + 1) ** 0.8
    p /= p.sum()
    docs = [(i, " ".join(WORDS[j] for j in rng.choice(len(WORDS), rng.integers(2, 14), p=p))) for i in range(360)]
    out = {}
    for budget in (None, 9):
        jb, tb = jlex.LexIndexBuilder(postings_budget=budget), tlex.LexIndexBuilder(postings_budget=budget)
        jb.add_batch(docs)
        tb.add_batch(docs)
        for fid in (5, 77, 301):
            jb.remove(fid)
            tb.remove(fid)
        out[budget] = (jb.snapshot(), tb.snapshot(device="cpu"), tb)
    return out


@pytest.mark.parametrize("mode", ["any", "all"])
@pytest.mark.parametrize("store", ["exact", "budgeted_chunks", "budgeted_no_chunks"])
def test_bm25_candidates_topk_pallas_equals_jax(snaps, store, mode):
    js, ts, tb = snaps[None if store == "exact" else 9]
    if store == "budgeted_no_chunks":
        js = dataclasses.replace(js, pk_chunks=None)
        ts = dataclasses.replace(ts, pk_chunks=None)
    rng = np.random.default_rng(7)
    tids = np.stack([pad_term_ids(tb.term_ids([WORDS[j] for j in rng.choice(len(WORDS), n, replace=False)]),
                                  max_terms=16) for n in (1, 2, 3, 5, 2, 4)])
    for k in (4, 24):
        jv, jr, jf = jk.bm25_candidates_topk_pallas(jnp.asarray(tids), js, k, mode=mode)
        tv, tr, tf = tk.bm25_candidates_topk_pallas(torch.from_numpy(tids), ts, k, mode=mode)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert (tf.numpy()[:, 0] >= 0).any()
