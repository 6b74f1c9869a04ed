"""The port's hybrid serving step against the same composition in wax_tpu.

Both packages index the same 4,096 synthetic documents (Zipf words) with the same
small MiniLM weights (flax params converted by `params_from_flax`, f32), then answer
the same 16 text queries as `unified_search` runs its device lanes: the vector lane
(embed -> normalise -> flat top-24; `auto` picks the packed-key kernel at this
capacity), the BM25 lane (`bm25_topk`, `any` and `all` modes), and weighted RRF.

BM25 lanes must agree exactly (ids; scores to rtol 1e-6). Vector lanes must agree up
to near-ties: packed-key scores are truncated to 2^-12 relative, and the two
encoders' f32 embeddings differ in the last bits. Fused frame-id lists must be equal
for >= 99% of queries, and any that differ must differ in their vector lane.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.embed import minilm as jm
from wax_tpu.index.dense import DenseIndexBuilder as JaxDense
from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu.ops.bm25 import bm25_topk as jax_bm25
from wax_tpu.ops.bm25 import pad_term_ids
from wax_tpu.ops.flat_scan import flat_scan_topk as jax_scan
from wax_tpu.ops.fusion import rrf_fuse as jax_rrf
from wax_tpu.text.wordpiece import WordPieceTokenizer
from wax_tpu_torch.embed import minilm as tm
from wax_tpu_torch.ops.bm25 import bm25_topk
from wax_tpu_torch.ops.flat_scan import normalize_rows
from wax_tpu_torch.ops.fusion import rrf_fuse
from wax_tpu_torch.search.engine import HybridSearchEngine

SMALL = dict(vocab_size=500, hidden=64, layers=2, heads=4, intermediate=128, max_positions=128)
N_DOCS, B, FETCH_K = 4096, 16, 24
WEIGHTS = {"bm25": 0.5, "vector": 0.5}


def _corpus(seed=0):
    rng = np.random.default_rng(seed)
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = sorted({"".join(rng.choice(letters, int(rng.integers(3, 8)))) for _ in range(700)})[:512]
    p = 1.0 / np.arange(1, len(vocab) + 1)
    p /= p.sum()
    docs = [" ".join(vocab[i] for i in row) for row in rng.choice(len(vocab), (N_DOCS, 32), p=p)]
    queries = [" ".join(vocab[i] for i in rng.choice(len(vocab), int(rng.integers(2, 5)), p=p))
               for _ in range(B)]
    return docs, queries


def _term_rows(lex, texts, mode):
    from wax_tpu_torch.index.lex import analyze

    rows = []
    for t in texts:
        terms = analyze(t)
        tids = lex.term_ids(terms)
        if mode == "all" and len(tids) < len(terms):
            tids = []
        rows.append(pad_term_ids(tids, max_terms=16, dfs=lex.df))
    return np.stack(rows)


def _lanes_to_fused(vv, vf, bv, bf):
    out = []
    for i in range(len(vf)):
        lanes = {
            "bm25": [(int(f), float(v)) for f, v in zip(bf[i], bv[i]) if f >= 0],
            "vector": [(int(f), float(v)) for f, v in zip(vf[i], vv[i]) if f >= 0],
        }
        out.append(lanes)
    return out


@pytest.fixture(scope="module")
def served():
    docs, queries = _corpus()
    cfg_j = jm.MiniLMConfig(**SMALL)
    model = jm.MiniLMEncoder(cfg_j, dtype=jnp.float32)
    ids0 = jnp.zeros((1, 8), jnp.int32)
    params = model.init(jax.random.PRNGKey(0), ids0, jnp.ones_like(ids0))["params"]
    tok = WordPieceTokenizer(vocab_size=cfg_j.vocab_size)
    fwd = jax.jit(lambda p, i, m: jm.mean_pool(model.apply({"params": p}, i, m), m))

    def jax_embed(texts):
        out = []
        for s in range(0, len(texts), 256):
            i, m = tok.encode_batch(texts[s : s + 256])
            out.append(np.asarray(fwd(params, jnp.asarray(i), jnp.asarray(m))))
        return np.concatenate(out)

    # --- wax_tpu composition
    jd, jl = JaxDense(cfg_j.hidden), JaxLex()
    for fid, text in enumerate(docs):
        jl.add(fid, text)
    jd.add_batch(np.arange(N_DOCS), jax_embed(docs))
    qv = jax_embed(queries)
    qv = qv / np.linalg.norm(qv, axis=1, keepdims=True)
    jout = {}
    for mode in ("any", "all"):
        vv, _, vf = jax_scan(jnp.asarray(qv), jd.snapshot(), FETCH_K)
        bv, _, bf = jax_bm25(jnp.asarray(_term_rows(jl, queries, mode)), jl.snapshot(), FETCH_K, mode=mode)
        jout[mode] = [np.asarray(x) for x in (vv, vf, bv, bf)]

    # --- wax_tpu_torch: the engine the card serves through
    embedder = tm.MiniLMEmbedder(cfg=tm.MiniLMConfig(**SMALL), dtype=torch.float32, device="cpu")
    embedder.model.load_state_dict(tm.params_from_flax(jax.tree_util.tree_map(np.asarray, params)))
    engine = HybridSearchEngine(embedder, device="cpu")
    for fid, text in enumerate(docs):
        engine.index_text(fid, text)
    engine.index_embedding_batch(np.arange(N_DOCS), embedder.embed_batch(docs))
    tout = {}
    for mode in ("any", "all"):
        q = normalize_rows(embedder.encode(queries))
        vv, vf = engine.vector.search(q, FETCH_K)
        bv, _, bf = bm25_topk(_term_rows(engine.lex, queries, mode), engine.lex_snapshot(), FETCH_K, mode=mode)
        tout[mode] = [vv, vf, bv.numpy(), bf.numpy()]
    return jout, tout, engine


@pytest.mark.parametrize("mode", ["any", "all"])
def test_bm25_lane_equal(served, mode):
    jout, tout, _ = served
    np.testing.assert_array_equal(tout[mode][3], jout[mode][3])
    np.testing.assert_allclose(tout[mode][2], jout[mode][2], rtol=1e-6, atol=0)
    if mode == "any":
        assert (tout[mode][3][:, 0] >= 0).all()


def test_vector_lane_agrees_up_to_near_ties(served):
    jout, tout, engine = served
    jv, jf, tv, tf = jout["any"][0], jout["any"][1], tout["any"][0], tout["any"][1]
    np.testing.assert_allclose(tv, jv, rtol=2.0**-11, atol=1e-5)
    overlap = np.mean([len(set(a) & set(b)) / FETCH_K for a, b in zip(jf, tf)])
    assert overlap >= 0.99
    assert engine.vector.snapshot().capacity == N_DOCS  # 1024 doubling -> 4096 rows


@pytest.mark.parametrize("mode", ["any", "all"])
def test_fused_lists_equal(served, mode):
    jout, tout, _ = served
    jl = _lanes_to_fused(*jout[mode])
    tl = _lanes_to_fused(*tout[mode])
    equal = 0
    for a, b in zip(jl, tl):
        fa = [h.frame_id for h in jax_rrf(a, WEIGHTS)]
        fb = [h.frame_id for h in rrf_fuse(b, WEIGHTS)]
        assert fb, "every query gets at least one fused hit"
        if fa == fb:
            equal += 1
        else:
            assert [f for f, _ in a["vector"]] != [f for f, _ in b["vector"]]
    assert equal / len(jl) >= 0.99


def test_repeat_serving_identical(served):
    _, tout, engine = served
    _, queries = _corpus()
    q = normalize_rows(engine.embedder.encode(queries))
    vv, vf = engine.vector.search(q, FETCH_K)
    np.testing.assert_array_equal(vv, tout["any"][0])
    np.testing.assert_array_equal(vf, tout["any"][1])
    assert engine.stats["lex_snapshots"] == 1 and engine.vector.snapshot_count == 1


def test_engine_remove_drops_both_lanes():
    engine = HybridSearchEngine(None, dim=8, device="cpu")
    rng = np.random.default_rng(0)
    engine.index_text(1, "alpha beta")
    engine.index_text(2, "alpha gamma")
    engine.index_embedding_batch([1, 2], rng.standard_normal((2, 8)).astype(np.float32))
    assert engine.embed_query("x") is None
    engine.remove(1)
    _, _, fids = bm25_topk(pad_term_ids(engine.lex.query_term_ids("alpha"))[None, :], engine.lex_snapshot(), 5)
    assert fids[0].tolist() == [2, -1, -1, -1, -1]
    _, vf = engine.vector.search(rng.standard_normal((1, 8)).astype(np.float32), 3)
    assert vf[0].tolist() == [2, -1, -1]
