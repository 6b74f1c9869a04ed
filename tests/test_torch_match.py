"""The port's host MATCH engine and FTS5 snippets against wax_tpu's on the CPU.

`wax_tpu_torch.search.match.match_search` evaluates a MATCH query over a position
index of the port builder's token log, where the JAX module verifies rows one at a
time; on the same documents (adds, removes, an upsert) both must return the same hits:
frame ids, rows, float64 scores bit for bit, and per-phrase instances.
`snippet_for_query` must render the same string. Queries cover bare terms, AND / OR /
NOT, phrases, prefixes, `^`, NEAR, nesting, repeats, unknown terms and syntax errors,
then a seeded random mix.
"""
import numpy as np
import pytest

from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu.search.match import match_search as jax_match
from wax_tpu.search.snippet import snippet_for_query as jax_snippet
from wax_tpu.text.match_query import MatchSyntaxError as JaxSyntaxError
from wax_tpu_torch.index.lex import LexIndexBuilder
from wax_tpu_torch.search.match import match_search
from wax_tpu_torch.search.snippet import snippet_for_query
from wax_tpu_torch.text.match_query import MatchSyntaxError

WORDS = "ab abc abd b bc c cd d de e apple apricot banana cherry river".split()
QUERIES = [
    "apple", "apple banana", "apple AND banana", "apple OR banana", "apple NOT banana",
    '"apple banana"', '"ab b c"', "ab*", "a*", "apri*", '"ab b*"', "^apple", '^"ab b"',
    "NEAR(apple banana)", "NEAR(apple banana, 0)", "NEAR(ab c d, 2)", 'NEAR("ab b" c, 1)',
    "(apple OR cherry) AND river", "apple OR banana cherry", "apple apple", "zzz", "apple zzz",
    "apple OR zzz", "NOT apple", "apple AND (", '"unclosed', "ab* NOT b*", "(a* OR c) NOT de",
]


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(1)
    docs = [" ".join(rng.choice(WORDS, int(rng.integers(0, 25)))) for _ in range(200)]
    jax_b, port_b = JaxLex(), LexIndexBuilder()
    for b in (jax_b, port_b):
        for i, d in enumerate(docs):
            b.add(i, d)
        for fid in (3, 50, 77):
            b.remove(fid)
        b.add(10, "ab b ab b c ab apple")
    docs[10] = "ab b ab b c ab apple"
    return docs, jax_b, port_b


def _run(fn, err, *args):
    try:
        return [(h.frame_id, h.score, h.row, h.instances) for h in fn(*args)]
    except err as e:
        return ("syntax error", str(e))


def _agree(corpus, query: str, top_k: int = 20) -> None:
    docs, jax_b, port_b = corpus
    want = _run(jax_match, JaxSyntaxError, jax_b, query, top_k)
    assert _run(match_search, MatchSyntaxError, port_b, query, top_k) == want
    for fid in ([h[0] for h in want[:3]] if isinstance(want, list) else []) + [0, 1]:
        assert snippet_for_query(docs[fid], query) == jax_snippet(docs[fid], query)


@pytest.mark.parametrize("query", QUERIES)
def test_match_and_snippet_equal_jax(corpus, query):
    _agree(corpus, query)


def test_match_random_queries_equal_jax(corpus):
    rng = np.random.default_rng(5)
    ops = [" ", " AND ", " OR ", " NOT "]

    def term():
        w, r = str(rng.choice(WORDS)), rng.random()
        if r < 0.15:
            return w[:1] + "*"
        if r < 0.3:
            return '"' + " ".join(rng.choice(WORDS, int(rng.integers(1, 4)))) + '"'
        return "^" + w if r < 0.35 else w

    for _ in range(300):
        q = term()
        for _ in range(int(rng.integers(0, 4))):
            q += str(rng.choice(ops)) + term()
        if rng.random() < 0.15:
            q = f"NEAR({term()} {term()}, {int(rng.integers(0, 4))})"
        _agree(corpus, q, top_k=int(rng.integers(1, 30)))
