"""The port's lexical compaction and frame-id remap against the JAX builder's.

The port's builder keeps a flat posting log and a token log where the JAX builder
keeps per-term dicts and analysed term lists, so `compact()` is a rewrite, not a copy.
After the same adds, removes, upserts and compaction both builders must give equal
segment arrays, equal generations, equal snapshot arrays, equal BM25 lane answers and
equal MATCH answers (float64 scores and instances) on positional and phrase queries.
`remapped(remap)` is held against the JAX live-set rewrite's rebuild of the lexical
builder (`wax_tpu/orchestrator/maintenance.py` `_remap_engines`), written out here.
"""
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu.ops import bm25 as jbm25
from wax_tpu.search.match import match_search as jax_match
from wax_tpu_torch.index.lex import LexIndexBuilder
from wax_tpu_torch.ops import bm25 as tbm25
from wax_tpu_torch.search.match import match_search

WORDS = ("apple banana cherry ab b c d de river mountain alpha beta gamma delta omega "
         "Café naïve 東京").split()
QUERIES = ["apple", "apple banana", "apple AND banana", "apple OR omega", "apple NOT banana",
           '"apple banana"', '"ab b c"', "ab*", '"ab b*"', "^apple", "NEAR(apple banana)",
           "NEAR(ab c d, 2)", "(apple OR cherry) AND river", "omega", "gamma delta"]


def _docs(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, len(WORDS) + 1)
    return [" ".join(rng.choice(WORDS, int(rng.integers(0, 20)), p=p / p.sum())) for _ in range(n)]


def _build(budget=None):
    """Both builders after adds, removes (every row of some terms), upserts and an
    empty document, so compaction drops rows and vocab."""
    pair = (JaxLex(postings_budget=budget), LexIndexBuilder(postings_budget=budget))
    for b in pair:
        for i, d in enumerate(_docs(1, 160)):
            b.add(i, d)
        b.add(500, "zzonly words gone soon")
        b.add(501, "")
        for fid in (3, 50, 77, 500, 120, 121, 999):
            b.remove(fid)
        b.add(10, "ab b ab b c ab apple")
        b.add(11, "omega omega omega unique-late")
        b.add(10, "ab b ab b c ab apple river")
    return pair


def _assert_arrays_equal(j, t) -> None:
    vj, aj = j.frozen_or_built_arrays()
    vt, at = t.frozen_or_built_arrays()
    assert vj == vt
    assert set(aj) == set(at)
    for k in aj:
        assert aj[k].dtype == at[k].dtype and np.array_equal(aj[k], at[k]), k
    assert (len(j), j.generation, dict(j._row_of)) == (len(t), t.generation, dict(t._row_of))
    assert [j.df(i) for i in range(len(j._vocab))] == [t.df(i) for i in range(len(t._vocab))]


def _assert_snapshots_equal(j, t) -> None:
    js, ts = j.snapshot(), t.snapshot(device="cpu")
    p = int(np.asarray(js.offsets)[-1])
    assert ts.n_postings == p
    for f in ("doc_rows", "tfs", "wnorm"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f))[:p], err_msg=f)
    for f in ("offsets", "idf", "doc_len", "frame_ids", "active", "count", "avgdl"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(), np.asarray(getattr(js, f)), err_msg=f)
    assert ts.max_df == js.max_df


def _assert_answers_equal(j, t) -> None:
    js, ts = j.snapshot(), t.snapshot(device="cpu")
    rng = np.random.default_rng(7)
    qs = [list(rng.choice(WORDS, int(rng.integers(1, 5)), replace=False)) for _ in range(12)]
    tids = np.stack([jbm25.pad_term_ids(t.term_ids(q), max_terms=16, dfs=t.df) for q in qs])
    for mode in ("any", "all"):
        jv, jr, jf = (np.asarray(x) for x in jbm25.bm25_topk(jnp.asarray(tids), js, 10, mode=mode))
        tv, tr, tf = (x.numpy() for x in tbm25.bm25_topk(torch.from_numpy(tids), ts, 10, mode=mode))
        np.testing.assert_array_equal(tr, jr)
        np.testing.assert_array_equal(tf, jf)
        np.testing.assert_allclose(tv, jv, rtol=1e-6, atol=0)
    for q in QUERIES:
        want = [(h.frame_id, h.score, h.row, h.instances) for h in jax_match(j, q, 20)]
        assert [(h.frame_id, h.score, h.row, h.instances) for h in match_search(t, q, 20)] == want, q


@pytest.mark.parametrize("budget", [None, 4], ids=["exact", "budget4"])
def test_compact_equals_jax(budget):
    j, t = _build(budget)
    _assert_arrays_equal(j, t)
    j.compact()
    t.compact()
    _assert_arrays_equal(j, t)
    assert len(t._doc_len) == len(t) and all(t._active)
    assert "zzonly" not in t._vocab and "unique" in t._vocab
    _assert_snapshots_equal(j, t)
    _assert_answers_equal(j, t)
    # building goes on alike after a compaction, and a second one is a no-op on rows
    for b in (j, t):
        b.add(2000, "apple fresh-after-compact")
        b.remove(4)
        b.compact()
    _assert_arrays_equal(j, t)
    _assert_answers_equal(j, t)


def test_compact_of_an_adopted_builder_equals_jax():
    """A builder adopted from segment arrays (a cold open) compacts as the JAX builder
    thawed from the same arrays does."""
    j0, t0 = _build()
    j = JaxLex.from_frozen_arrays(*j0.frozen_or_built_arrays())
    t = LexIndexBuilder.from_frozen_arrays(*t0.frozen_or_built_arrays())
    j.compact()
    t.compact()
    _assert_arrays_equal(j, t)
    _assert_answers_equal(j, t)


def test_compact_of_empty_and_all_removed_builders():
    for docs in ([], ["apple", "banana"]):
        j, t = JaxLex(), LexIndexBuilder()
        for b in (j, t):
            for i, d in enumerate(docs):
                b.add(i, d)
                b.remove(i)
            b.compact()
        _assert_arrays_equal(j, t)
        assert len(t) == 0 and t._vocab == {}


def _jax_remapped(old: JaxLex, remap: dict) -> JaxLex:
    """The JAX live-set rewrite's lexical rebuild (maintenance.py `_remap_engines`)."""
    state = old.state()
    fresh = JaxLex(postings_budget=old.postings_budget)
    for terms, fid, active in zip(state["doc_terms"], state["frame_ids"], state["active"]):
        if not active or fid not in remap:
            continue
        new_fid = remap[fid]
        row = len(fresh._doc_len)
        fresh._doc_terms.append(terms)
        fresh._doc_len.append(len(terms))
        fresh._frame_ids.append(new_fid)
        fresh._active.append(True)
        fresh._row_of[new_fid] = row
        for term, tf in Counter(terms).items():
            fresh._postings[fresh._tid(term)][row] = tf
    return fresh


@pytest.mark.parametrize("drop", [(), (0, 1, 2, 11, 159)], ids=["all", "some"])
def test_remapped_equals_jax_rewrite(drop):
    j, t = _build(budget=4)
    survivors = [f for f in range(600) if f not in drop]
    remap = {old: new for new, old in enumerate(survivors)}
    j2, t2 = _jax_remapped(j, remap), t.remapped(remap)
    _assert_arrays_equal(j2, t2)
    assert t2.postings_budget == 4 and t2.generation == 0
    _assert_snapshots_equal(j2, t2)
    _assert_answers_equal(j2, t2)
    assert len(t) == len(j)  # the source builder is untouched
