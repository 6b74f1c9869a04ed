"""The port's budgeted lexical snapshot against wax_tpu's, array by array.

A postings budget that truncates a term keeps each term's impact head (ranked in
float64 like the JAX builder's Python doubles, ties to the lowest row), scores with
idf from the full document frequency, and adds the forward index (`fwd_tids`,
`fwd_wnorm`, `fwd_fused`) and the impact-chunked packed postings (`pk_chunks`,
`chunk_base`, `chunk_counts`). The port builds all of it with vectorised numpy; the
JAX builder loops in Python. Every array must be EQUAL (postings arrays over the JAX
snapshot's live prefix: the port keeps no TPU padding and no reversed copies).
"""
import numpy as np
import pytest

from wax_tpu.index import lex as jlex
from wax_tpu_torch.index import lex as tlex

WORDS = [f"w{i}" for i in range(40)] + ["Café", "naïve"]


def _docs(n, seed, long_doc=False):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    docs = [(500 + i, " ".join(WORDS[j] for j in rng.choice(len(WORDS), rng.integers(1, 16), p=p)))
            for i in range(n)]
    if long_doc:  # more unique terms than the (lowered) forward width cap
        docs.append((9999, " ".join(f"x{j} " * (1 + j % 3) for j in range(30)) + " w0 w1"))
    return docs


def _pair(docs, budget, removed=(), upsert=False):
    jb, tb = jlex.LexIndexBuilder(postings_budget=budget), tlex.LexIndexBuilder(postings_budget=budget)
    jb.add_batch(docs)
    tb.add_batch(docs)
    for fid in removed:
        assert jb.remove(fid) and tb.remove(fid)
    if upsert:
        jb.add(docs[3][0], "w0 w0 w1 Café w7")
        tb.add(docs[3][0], "w0 w0 w1 Café w7")
    return jb, tb


FIELDS_PREFIX = ("doc_rows", "tfs", "wnorm")
FIELDS_EQUAL = ("offsets", "idf", "doc_len", "frame_ids", "active", "count", "avgdl", "fwd_tids",
                "fwd_wnorm", "fwd_fused", "pk_chunks", "chunk_base", "chunk_counts")
STATIC = ("max_df", "pk_qb", "pk_max_chunks", "fwd_width")


def _assert_snapshots_equal(js, ts):
    p = int(np.asarray(js.offsets)[-1])
    assert ts.n_postings == p
    for f in FIELDS_PREFIX:
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))[:p], err_msg=f)
    for f in FIELDS_EQUAL:
        j, t = getattr(js, f), getattr(ts, f)
        assert (j is None) == (t is None), f
        if j is not None:
            np.testing.assert_array_equal(t.numpy(), np.asarray(j), err_msg=f)
    for f in STATIC:
        assert getattr(ts, f) == getattr(js, f), f


@pytest.mark.parametrize("budget", [3, 7, 25, "auto", None])
@pytest.mark.parametrize("removed,upsert", [((), False), ((503, 540, 777), True)])
def test_budgeted_snapshot_arrays_equal(budget, removed, upsert):
    jb, tb = _pair(_docs(400, seed=11), budget, removed, upsert)
    js, ts = jb.snapshot(), tb.snapshot(device="cpu")
    _assert_snapshots_equal(js, ts)
    truncated = budget in (3, 7, 25)
    assert (ts.fwd_fused is not None) == truncated


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_width_cap_keeps_highest_impact_terms(monkeypatch, seed):
    """Documents with more unique terms than FWD_WIDTH_CAP keep their highest-impact
    terms (lowest-tid ties); the cap is lowered so that a small corpus reaches it."""
    monkeypatch.setattr(jlex, "FWD_WIDTH_CAP", 6)
    monkeypatch.setattr(tlex, "FWD_WIDTH_CAP", 6)
    jb, tb = _pair(_docs(150, seed=seed, long_doc=True), 5, removed=(501,))
    js, ts = jb.snapshot(), tb.snapshot(device="cpu")
    _assert_snapshots_equal(js, ts)
    assert ts.fwd_width == 6


def _random_csr(seed, n_terms, n_rows, max_df, tomb_frac):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, max_df, n_terms)
    rows, wn = [], []
    for m in sizes:
        rows.append(np.sort(rng.choice(n_rows, size=m, replace=False)).astype(np.int32))
        # weights on a coarse grid: equal contributions are common (row tie-breaks)
        w = (rng.integers(1, 9, m) / 4.0).astype(np.float32)
        w[rng.random(m) < tomb_frac] = 0.0  # tombstoned postings
        wn.append(w)
    offsets = np.zeros(n_terms + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    idf = (rng.integers(1, 5, n_terms) / 2.0).astype(np.float32)
    return np.concatenate(rows), np.concatenate(wn), offsets, idf


@pytest.mark.parametrize("seed,n_terms,n_rows,max_df", [(0, 6, 5000, 2600), (1, 40, 3000, 300),
                                                        (2, 3, 70_000, 4500), (3, 1, 128, 0)])
def test_build_impact_chunks_equal(seed, n_terms, n_rows, max_df):
    rows, wn, offsets, idf = _random_csr(seed, n_terms, n_rows, max(max_df, 1), 0.05)
    n_cap = max(128, -(-n_rows // 128) * 128)
    jpk, _, jcb, jcc, jqb = jlex.build_impact_chunks(rows, wn.astype(np.float64), offsets,
                                                     idf.astype(np.float64), n_cap)
    tpk, tcb, tcc, tqb = tlex.build_impact_chunks(rows, wn, offsets, idf.astype(np.float64), n_cap)
    np.testing.assert_array_equal(tpk, jpk)
    np.testing.assert_array_equal(tcb, jcb)
    np.testing.assert_array_equal(tcc, jcc)
    assert tqb == jqb


@pytest.mark.parametrize("width", [1, 40, 64, 65, 128, 200])
def test_fuse_forward_equal(width):
    rng = np.random.default_rng(width)
    l_pad = max(128, -(-width // 128) * 128)
    tids = np.full((37, l_pad), -1, np.int32)
    tids[:, :width] = rng.integers(0, 1000, (37, width))
    wn = np.where(tids >= 0, rng.random((37, l_pad)), 0.0).astype(np.float32)
    np.testing.assert_array_equal(tlex.fuse_forward(tids, wn, width), jlex.fuse_forward(tids, wn, width))


@pytest.mark.parametrize("n_cap", [128, 1 << 20, 1_048_576 + 128, (1 << 25) - 1, 1 << 25])
def test_packed_row_bits_equal(n_cap):
    try:
        want = jlex.packed_row_bits(n_cap)
    except ValueError:
        with pytest.raises(ValueError):
            tlex.packed_row_bits(n_cap)
        return
    assert tlex.packed_row_bits(n_cap) == want


def test_constants_equal():
    assert tlex.PK_CHUNK == jlex.PK_CHUNK and tlex.FWD_WIDTH_CAP == jlex.FWD_WIDTH_CAP
    for n in (0, 262_143, 262_144, 1_048_576, 5_000_000):
        assert tlex.auto_postings_floor(n) == jlex.auto_postings_floor(n)
