"""Kernel K4's plain twin and its host packing against wax_tpu's chunked Pallas kernel.

Impact chunks are built by each package's `build_impact_chunks` from the same
synthetic CSR (terms of up to four 1,024-posting chunks), so queries of 16 terms
overflow the 32 merge slots and the water-fill truncation decides which chunks are
merged. The JAX kernel runs in interpret mode. All arithmetic is integer: `win`,
candidate rows and rank keys must be EQUAL, in the kernel's output layout
(level * 1024 + slot position), in both the `any` and `count` modes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index import lex as jlex
from wax_tpu.ops import bm25_chunked_pallas as jck
from wax_tpu_torch.index import lex as tlex
from wax_tpu_torch.ops import bm25_chunked_pallas as tck

N_ROWS, N_TERMS = 6000, 24


@pytest.fixture(scope="module")
def chunks():
    rng = np.random.default_rng(7)
    heavy = [3900, 3500, 3100, 2900, 2500, 2200, 2100, 1500]  # 4,4,4,3,3,3,3,2 chunks
    sizes = np.concatenate([heavy, rng.integers(1, 1000, N_TERMS - len(heavy))])
    rows = np.concatenate([np.sort(rng.choice(N_ROWS, m, replace=False)) for m in sizes]).astype(np.int32)
    wn = (rng.integers(1, 30, len(rows)) / 8.0).astype(np.float32)
    wn[rng.random(len(rows)) < 0.02] = 0.0  # tombstoned postings
    offsets = np.zeros(N_TERMS + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    idf = (rng.integers(1, 9, N_TERMS) / 4.0).astype(np.float64)
    n_cap = -(-N_ROWS // 128) * 128
    jpk, jpkr, jcb, jcc, qb = jlex.build_impact_chunks(rows, wn.astype(np.float64), offsets, idf, n_cap)
    tpk, tcb, tcc, _ = tlex.build_impact_chunks(rows, wn, offsets, idf, n_cap)
    return (jpk, jpkr, jcb, jcc), (torch.from_numpy(tpk), torch.from_numpy(tcb), torch.from_numpy(tcc)), qb


def _tids(n_terms, seed, b=3):
    rng = np.random.default_rng(seed)
    t = np.stack([rng.choice(N_TERMS, n_terms, replace=False) for _ in range(b)]).astype(np.int32)
    if n_terms == 16:
        t[0] = np.arange(16)  # 34 live chunks for 32 slots: two are dropped
    if n_terms > 2:
        t[1, -1] = -1  # a padding slot
    return t


@pytest.mark.parametrize("n_terms", [1, 5, 16])
def test_pack_query_chunks_equal(chunks, n_terms):
    (jpk, _, jcb, jcc), (tpk, tcb, tcc), _ = chunks
    tids = _tids(n_terms, seed=n_terms)
    slots = tck.slots_for_query(n_terms)
    assert slots == jck.slots_for_query(n_terms)
    maxc = int(jcc.max())
    dead = len(jpk) // 1024 - 1
    jw = jck.pack_query_chunks(jnp.asarray(tids), jnp.asarray(jcb), jnp.asarray(jcc), slots, maxc, dead)
    tw = tck.pack_query_chunks(torch.from_numpy(tids), tcb, tcc, slots, maxc, dead)
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))


@pytest.mark.parametrize("mode", ["any", "count"])
@pytest.mark.parametrize("n_terms", [1, 5, 16])
def test_chunked_candidates_sel_equal(chunks, mode, n_terms):
    (jpk, jpkr, jcb, jcc), (tpk, tcb, tcc), qb = chunks
    tids = _tids(n_terms, seed=100 + n_terms)
    maxc = int(jcc.max())
    jr, jk = jck.chunked_candidates_sel(jnp.asarray(tids), jnp.asarray(jpk), jnp.asarray(jpkr), jnp.asarray(jcb),
                                        jnp.asarray(jcc), qb=qb, max_chunks=maxc, mode=mode)
    tr, tk = tck.chunked_candidates_sel(torch.from_numpy(tids), tpk, tcb, tcc, qb=qb, max_chunks=maxc, mode=mode)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert (tr.numpy() >= 0).any()


def test_overflowing_query_drops_deep_chunks(chunks):
    """Terms 0-15 hold 34 chunks (eight terms span 2-4) for 32 slots: the water-fill
    keeps every term's top chunk and every second and third chunk (31 in all), and of
    the three fourth chunks only that of the lowest query position."""
    _, (tpk, tcb, tcc), _ = chunks
    tids = torch.arange(16, dtype=torch.int32)[None, :]
    win = tck.pack_query_chunks(tids, tcb, tcc, 32, int(tcc.max()), tpk.shape[0] // 1024 - 1)
    assert int(tcc[:16].sum()) == 34
    want = [int(tcb[i]) + j for i in range(16) for j in range(min(int(tcc[i]), 3))]
    want.append(int(tcb[0]) + 3)
    assert sorted(win[0].tolist()) == sorted(want)
    tcc2 = tcc.clone()
    tcc2[:16] = 4  # demand 64 chunks from 32 slots: levels 0 and 1 only
    win2 = tck.pack_query_chunks(tids, tcb, tcc2, 32, 4, tpk.shape[0] // 1024 - 1)
    assert sorted(win2[0].tolist()) == sorted([int(tcb[i]) + j for j in (0, 1) for i in range(16)])


def test_wrapper_validates_and_cpu_does_not_count(chunks):
    _, (tpk, tcb, tcc), qb = chunks
    win = tck.pack_query_chunks(torch.tensor([[0, 1]], dtype=torch.int32), tcb, tcc, 32, int(tcc.max()),
                                tpk.shape[0] // 1024 - 1)
    before = tck.K4_LAUNCHES
    rows, keys = tck.chunked_sel(win, tpk, qb=qb, seg_log2=2)
    assert tck.K4_LAUNCHES == before and rows.shape == keys.shape == (1, 3 * 1024)
    with pytest.raises(ValueError, match="at most 128"):
        tck.slots_for_query(129)
