"""wax_tpu_torch BM25 lane and fusion against wax_tpu's on the same texts.

The port's LexIndex keeps only the unbudgeted fields and no TPU padding, so postings
arrays are compared over the JAX snapshot's live prefix (`offsets[-1]` entries); every
other field must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index import lex as jlex
from wax_tpu.ops import bm25 as jbm25
from wax_tpu.ops import fusion as jfusion
from wax_tpu_torch.index import lex as tlex
from wax_tpu_torch.ops import bm25 as tbm25
from wax_tpu_torch.ops import fusion as tfusion

WORDS = [f"w{i}" for i in range(60)] + ["Café", "CAFE", "naïve", "東京", "ｆｕｌｌ"]


def _docs(n=400, seed=0):
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    p /= p.sum()
    return [(1000 + i, " ".join(WORDS[j] for j in rng.choice(len(WORDS), rng.integers(1, 14), p=p)))
            for i in range(n)]


def _builders(docs, removed=()):
    jb, tb = jlex.LexIndexBuilder(), tlex.LexIndexBuilder()
    jb.add_batch(docs)
    tb.add_batch(docs)
    for fid in removed:
        assert jb.remove(fid) and tb.remove(fid)
    return jb, tb


@pytest.fixture(scope="module")
def pair():
    docs = _docs()
    # tombstones, plus an upsert (re-adding an id tombstones its old row)
    jb, tb = _builders(docs, removed=(1003, 1100, 1399))
    jb.add(1010, "w0 w1 w1 Café")
    tb.add(1010, "w0 w1 w1 Café")
    return jb, tb


ANALYZE_CASES = [
    "Hello, World! hello-world",
    "Café CAFÉ café naïve",
    "東京タワー and ＦＵＬＬ width ｆｕｌｌ",
    "ß Straße ﬁ ligature Œuvre",
    "x" * 70 + " tail",
    "",
]


def test_analyze_identical():
    for s in ANALYZE_CASES:
        assert tlex.analyze(s) == jlex.analyze(s), s
    assert tlex.ANALYZER_VERSION == jlex.ANALYZER_VERSION
    assert (tlex.BM25_K1, tlex.BM25_B) == (jlex.BM25_K1, jlex.BM25_B)


@pytest.mark.parametrize("removed", [(), (1003, 1100, 1399)])
def test_snapshot_arrays_identical(removed):
    jb, tb = _builders(_docs(), removed)
    js, ts = jb.snapshot(), tb.snapshot()
    p = int(np.asarray(js.offsets)[-1])
    assert ts.n_postings == p
    for f in ("doc_rows", "tfs", "wnorm"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))[:p], err_msg=f)
    for f in ("offsets", "idf", "doc_len", "frame_ids", "active", "count", "avgdl"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    assert ts.max_df == js.max_df
    assert tb.row_space() == jb.row_space() and tb.max_term_df() == jb.max_term_df()
    assert len(tb) == len(jb) and tb.generation == jb.generation
    for t in range(len(jb._vocab)):
        assert tb.df(t) == jb.df(t)


def test_empty_snapshot_identical():
    js, ts = jlex.LexIndexBuilder().snapshot(), tlex.LexIndexBuilder().snapshot()
    assert ts.n_postings == int(np.asarray(js.offsets)[-1]) == 0
    for f in ("offsets", "idf", "doc_len", "frame_ids", "active", "count", "avgdl"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    tids = np.full((2, 16), -1, np.int32)
    assert (tbm25.bm25_topk(tids, ts, 3)[2] == -1).all()


def test_builder_queries_identical(pair):
    jb, tb = pair
    for q in ("w0 w5 nosuch", "CAFE naïve", ""):
        assert tb.query_term_ids(q) == jb.query_term_ids(q)
    assert 1003 not in tb and 1004 in tb and not tb.remove(1003)


def _queries(tb):
    rng = np.random.default_rng(7)
    qs = [[WORDS[j] for j in rng.choice(len(WORDS), rng.integers(1, 5), replace=False)] for _ in range(12)]
    qs.append(["w0", "w0", "w1"])  # repeated term: deduplicated by pad_term_ids
    qs.append(["nosuchterm"])
    return [jbm25.pad_term_ids(tb.term_ids(q), max_terms=16, dfs=tb.df) for q in qs]


@pytest.mark.parametrize("mode", ["any", "all"])
def test_bm25_topk_matches(pair, mode):
    jb, tb = pair
    js, ts = jb.snapshot(), tb.snapshot()
    tids = np.stack(_queries(tb))
    for k in (5, 24):
        jv, jr, jf = (np.asarray(x) for x in jbm25.bm25_topk(jnp.asarray(tids), js, k, mode=mode))
        tv, tr, tf = (x.numpy() for x in tbm25.bm25_topk(torch.from_numpy(tids), ts, k, mode=mode))
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)
    assert (tf[:-1, 0] >= 0).any() and (tf[-1] == -1).all()


def test_bm25_scores_match(pair):
    jb, tb = pair
    tids = np.stack(_queries(tb))
    for mode in ("any", "all"):
        j = np.asarray(jbm25.bm25_scores(jnp.asarray(tids), jb.snapshot(), mode=mode))
        t = tbm25.bm25_scores(torch.from_numpy(tids), tb.snapshot(), mode=mode).numpy()
        np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def test_pad_term_ids_identical():
    df = {i: (i * 7) % 5 for i in range(300)}.get
    for ids, mt in (([3, 1, 3, 2], None), (list(range(40)), None), (list(range(200)), None),
                    (list(range(20)), 8), ([], None)):
        np.testing.assert_array_equal(tbm25.pad_term_ids(ids, mt, dfs=df), jbm25.pad_term_ids(ids, mt, dfs=df))


def test_budget_that_truncates_raises():
    b = tlex.LexIndexBuilder(postings_budget=3)
    b.add_batch([(i, "common word") for i in range(5)])
    with pytest.raises(NotImplementedError, match="ROADMAP item 6"):
        b.snapshot()
    auto = tlex.LexIndexBuilder(postings_budget="auto")
    auto.add_batch([(i, "common word") for i in range(5)])
    assert auto.snapshot().n_postings == 10  # exact below 256K rows
    assert tlex.auto_postings_floor(1_000_000) == jlex.auto_postings_floor(1_000_000)


def test_rrf_fuse_identical():
    rng = np.random.default_rng(3)
    lanes = {
        "bm25": [(int(f), float(s)) for f, s in zip(rng.integers(-1, 30, 24), rng.random(24))],
        "vector": [(int(f), float(s)) for f, s in zip(rng.integers(0, 30, 24), rng.random(24))],
        "temporal": [(5, 1.0), (6, 2.0)],
    }
    for weights, top_k in (({"bm25": 0.5, "vector": 0.5}, None), ({"bm25": 1.0, "vector": 0.3}, 7)):
        got = tfusion.rrf_fuse(lanes, weights, top_k=top_k)
        want = jfusion.rrf_fuse(lanes, weights, top_k=top_k)
        assert [vars(h) for h in got] == [vars(h) for h in want]
        assert [h.sources for h in got] == [h.sources for h in want]
    assert tfusion.DEFAULT_RRF_K == jfusion.DEFAULT_RRF_K
