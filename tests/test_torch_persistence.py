"""The port's index builders persist as the JAX builders do.

`LexIndexBuilder.frozen_or_built_arrays` (the v2 lex segment's arrays) must equal the
JAX builder's after adds, removes and upserts, and after a round trip through
`from_frozen_arrays` followed by more mutations; the snapshots of an adopted builder
must equal those of one built by adds. `DenseIndexBuilder.state_arrays(aligned=True)`
and `from_state_arrays` must equal JAX's, adopt the stored container without a copy,
and copy it on the first mutation (`_thaw`). All on the CPU.
"""
import numpy as np
import pytest
import torch

from wax_tpu.index.dense import DenseIndexBuilder as JaxDense
from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu_torch.index.dense import DenseIndexBuilder
from wax_tpu_torch.index.lex import LexIndex, LexIndexBuilder

WORDS = "alpha beta gamma delta epsilon zeta eta theta iota kappa lambda mu Ünïcode naïve".split()


def _docs(seed: int, n: int) -> list[str]:
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(WORDS, int(rng.integers(0, 14)))) for _ in range(n)]


def _mutate(builders, step: str, seed: int) -> None:
    docs = _docs(seed, 40)
    for b in builders:
        if step == "adds":
            for i, d in enumerate(docs):
                b.add(1000 * seed + i, d)
        elif step == "removes":
            for fid in (1000 * seed + 3, 1000 * seed + 17, 999_999):
                b.remove(fid)
        elif step == "upserts":
            b.add(1000 * seed + 5, "alpha alpha fresh-term " + docs[0])
            b.add(1000 * seed + 9, "")
            b.add(1000 * seed + 5, "upserted twice omega")


def _assert_arrays_equal(jax_b, port_b) -> None:
    vj, aj = jax_b.frozen_or_built_arrays()
    vt, at = port_b.frozen_or_built_arrays()
    assert vj == vt
    assert set(aj) == set(at)
    for k in aj:
        assert aj[k].dtype == at[k].dtype and np.array_equal(aj[k], at[k]), k


SCENARIOS = {
    "adds": ["adds"],
    "adds_removes": ["adds", "removes"],
    "adds_upserts": ["adds", "upserts"],
    "everything": ["adds", "removes", "upserts", "adds"],
    "empty": [],
}


@pytest.mark.parametrize("steps", list(SCENARIOS.values()), ids=list(SCENARIOS))
def test_lex_frozen_arrays_equal_jax(steps):
    j, t = JaxLex(), LexIndexBuilder()
    for i, step in enumerate(steps):
        _mutate((j, t), step, i + 1)
    _assert_arrays_equal(j, t)
    assert len(j) == len(t) and j.generation == t.generation


@pytest.mark.parametrize("steps", [["adds"], ["adds", "upserts", "removes"]], ids=["adds", "mixed"])
def test_lex_round_trip_then_mutations_equal_jax(steps):
    j, t = JaxLex(), LexIndexBuilder()
    for i, step in enumerate(steps):
        _mutate((j, t), step, i + 1)
    j2 = JaxLex.from_frozen_arrays(*j.frozen_or_built_arrays())
    t2 = LexIndexBuilder.from_frozen_arrays(*t.frozen_or_built_arrays())
    _assert_arrays_equal(j2, t2)
    assert dict(t2._row_of) == dict(j2._row_of)
    assert [t2.df(i) for i in range(len(t2._vocab))] == [j2.df(i) for i in range(len(j2._vocab))]
    for step in ("adds", "removes", "upserts"):
        _mutate((j2, t2), step, 7)
    _assert_arrays_equal(j2, t2)


@pytest.mark.parametrize("budget", [None, 6], ids=["exact", "budget6"])
def test_lex_adopted_snapshot_equals_built(budget):
    """A builder adopted from its own arrays snapshots to the same tensors (the posting
    log's CSR order sorts to the same layout as the add order), budgeted too."""
    b = LexIndexBuilder(postings_budget=budget)
    for i, d in enumerate(_docs(3, 120)):
        b.add(i, d)
    b.remove(4)
    b.add(7, "alpha beta beta")
    a = LexIndexBuilder.from_frozen_arrays(*b.frozen_or_built_arrays(), postings_budget=budget)
    s1, s2 = b.snapshot(device="cpu"), a.snapshot(device="cpu")
    for f in LexIndex.__dataclass_fields__:
        x, y = getattr(s1, f), getattr(s2, f)
        assert (torch.equal(x, y) if torch.is_tensor(x) else x == y), f
    assert budget is None or s1.fwd_tids is not None


def _dense_pair(n: int, dim: int = 8):
    rng = np.random.default_rng(n)
    vecs = rng.normal(size=(n, dim)).astype(np.float32)
    j, t = JaxDense(dim=dim), DenseIndexBuilder(dim=dim)
    for b in (j, t):
        b.add_batch(np.arange(n) * 3, vecs)
        if n > 4:
            b.remove(3)
            b.add(0, vecs[1])  # upsert
    return j, t


@pytest.mark.parametrize("n", [0, 5, 700, 1500], ids=["empty", "small", "one_block", "three_blocks"])
def test_dense_state_arrays_round_trip_equal_jax(n):
    j, t = _dense_pair(n)
    for aligned in (False, True):
        aj, at = j.state_arrays(aligned=aligned), t.state_arrays(aligned=aligned)
        for k in aj:
            assert aj[k].dtype == at[k].dtype and np.array_equal(aj[k], at[k]), (k, aligned)
    stored = {k: v.copy() for k, v in t.state_arrays(aligned=True).items()}
    for a in stored.values():
        a.flags.writeable = False  # as the zero-copy segment views are
    j2 = JaxDense.from_state_arrays(stored, dim=8, count=t.count)
    t2 = DenseIndexBuilder.from_state_arrays(stored, dim=8, count=t.count)
    assert t2.count == j2.count == t.count and t2._row_of == j2._row_of and len(t2) == len(t)
    adopted = stored["emb"].shape[0] >= DenseIndexBuilder.MIN_CAPACITY
    assert (t2._emb is stored["emb"]) == adopted
    for b in (j2, t2):
        b.add(77, np.ones(8, np.float32))
        b.remove(6)
    assert t2._emb.flags.writeable
    for k, v in j2.state_arrays(aligned=True).items():
        assert np.array_equal(v, t2.state_arrays(aligned=True)[k]), k
    s = t2.snapshot(device="cpu")
    assert int(s.count) == t2.count and s.live_count() == len(t2)


def test_lex_v1_json_segment_reads_as_jax_reads_it():
    """A round-2 lex segment (JSON analyses, "wxs-lex-json-v1") loads into the port's
    builder with the arrays the JAX loader gives."""
    import json

    from wax_tpu.orchestrator.serialization import deserialize_lex as jax_deserialize
    from wax_tpu_torch.orchestrator.serialization import deserialize_lex

    j = JaxLex()
    for step, seed in (("adds", 1), ("removes", 1), ("upserts", 1)):
        _mutate((j,), step, seed)
    state = j.state()
    blob = json.dumps({k: state[k] for k in ("vocab", "doc_terms", "doc_len", "frame_ids", "active")}).encode()
    attrs = {"format": "wxs-lex-json-v1"}
    _assert_arrays_equal(jax_deserialize(blob, attrs), deserialize_lex(blob, attrs))
