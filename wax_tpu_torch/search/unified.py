"""Unified hybrid search: the retrieval heart.

PyTorch port of `wax_tpu.search.unified`. The pipeline is the JAX module's: classify
the query -> adaptive lane weights -> the BM25 lane (implicit-AND primary query plus
the OR-expanded fallback; pure AND / OR bags of terms on the device, positional and
boolean MATCH queries on the host engine `search/match.py`), the vector lane, the
structured-evidence lane and, for temporal queries, the timeline lane -> weighted RRF
(k 60; ties by score, best rank, frame id) -> frame and metadata filters -> FTS5-style
snippet previews -> the deterministic intent-aware rerank window -> the timeline
fallback when every lane came up empty.

The device lanes run on `engine.device`: the BM25 lane's padded term ids are a tensor
there, and `_bm25_run` sends them to the sharded lane, to the candidate lane with its
exact rescore (K3) when the postings budget truncated a term, or to the scatter-free
CSR lane. The JAX package's executable cache (`aot_call`) has no counterpart: the
lanes are called directly.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from wax_tpu_torch.index.lex import analyze, auto_postings_floor
from wax_tpu_torch.ops.bm25 import bm25_topk, pad_term_ids
from wax_tpu_torch.ops.bm25_lane import bm25_candidates_topk
from wax_tpu_torch.ops.fusion import FusedHit, rrf_fuse
from wax_tpu_torch.parallel.sharded_hybrid import sharded_bm25_topk
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.fts_preprocess import candidate_limit, or_expanded_query, primary_fts_query
from wax_tpu_torch.search.match import MatchSyntaxError, match_search
from wax_tpu_torch.search.rerank import intent_aware_rerank
from wax_tpu_torch.search.snippet import snippet_for_query
from wax_tpu_torch.text.analyzer import analyze_query
from wax_tpu_torch.text.classifier import AdaptiveFusionConfig, classify_query
from wax_tpu_torch.text.match_query import BoolNode, Near, Phrase, has_match_syntax, parse_match_query
from wax_tpu_torch.types import (
    LaneSource,
    QueryType,
    RankingDiagnostics,
    SearchHit,
    SearchMode,
    SearchRequest,
    SearchResponse,
)
from wax_tpu_torch.utils.profiling import span

__all__ = ["unified_search", "make_snippet"]

_LANE_SOURCE = {
    "bm25": LaneSource.BM25,
    "vector": LaneSource.VECTOR,
    "structured": LaneSource.STRUCTURED,
    "temporal": LaneSource.TEMPORAL,
}

# rerank window size, mirroring the reference's default (FastRAGConfig rerank window 12)
_RERANK_WINDOW = 12


def make_snippet(content: str, terms: tuple[str, ...], radius: int = 80, max_len: int = 200) -> str:
    """Deterministic snippet: first window around the earliest query-term occurrence."""
    low = content.lower()
    best = None
    for t in terms:
        i = low.find(t.lower())
        if i >= 0 and (best is None or i < best):
            best = i
    if best is None:
        return content[:max_len]
    start = max(0, best - radius)
    snippet = content[start : start + max_len]
    return ("…" if start > 0 else "") + snippet


def _bm25_run(engine: HybridSearchEngine, padded, fetch_k: int, mode: str, snap=None):
    """One BM25 top-k pass over padded term ids [B, W]: (scores [B, fetch_k],
    frame_ids [B, fetch_k]) tensors on the engine's device. `snap` is the engine's
    lex snapshot (the sharded one on the sharded lane); None takes the current one."""
    if engine.lex_sharded:
        snap = engine.lex_sharded_snapshot() if snap is None else snap
        return sharded_bm25_topk(padded, snap, fetch_k, engine.mesh, mode=mode)
    snap = engine.lex_snapshot() if snap is None else snap
    if snap.fwd_tids is not None:
        # the budget truncated a term: the candidate lane rescores its top-F against
        # the forward index, restoring the exact multi-term scores
        vals, _, fids = bm25_candidates_topk(padded, snap, fetch_k, mode=mode)
        return vals, fids
    vals, _, fids = bm25_topk(padded, snap, fetch_k, mode=mode)
    return vals, fids


def _device_expressible(node) -> tuple[str, list[str]] | None:
    """("all"|"any", terms) when a parsed MATCH query is a pure AND / pure OR of
    distinct single bare terms — the cases the device bag-of-terms lane scores with
    FTS5-exact semantics. Anything positional (phrases, prefix, NEAR, caret), NOT,
    mixed operators, or repeated terms (FTS5 double-counts repeats) routes to the host
    MATCH engine."""
    terms: list[str] = []
    ops: set[str] = set()

    def walk(n) -> bool:
        if isinstance(n, Phrase):
            if len(n.terms) != 1 or n.prefix or n.first:
                return False
            terms.append(n.terms[0])
            return True
        if isinstance(n, Near):
            return False
        if isinstance(n, BoolNode):
            if n.op == "not":
                return False
            ops.add(n.op)
            return walk(n.left) and walk(n.right)
        return False

    if not walk(node) or len(set(terms)) != len(terms):
        return None
    if ops <= {"and"}:
        return "all", terms
    if ops <= {"or"}:
        return "any", terms
    return None


def _and_budget_warning(engine: HybridSearchEngine) -> str | None:
    """Warn when an AND query runs under a MANUAL postings budget below the auto
    recall floor: a conjunction is missed entirely if any one term's impact head
    truncated the doc out. Auto/None budgets sit at the measured >=0.97 point."""
    b = engine.lex.postings_budget
    if not isinstance(b, int):
        return None
    n = engine.lex.row_space()
    floor = auto_postings_floor(n)
    if floor is None:
        # exact regime (<256K rows): any truncating budget is below the floor
        if b >= engine.lex.max_term_df():
            return None
        floor_desc = "exact (no truncation)"
    elif b >= floor:
        return None
    else:
        floor_desc = str(floor)
    return (
        f"AND-mode query with manual lex_postings_budget={b} below the auto floor "
        f"[{floor_desc}] for {n} rows: conjunctions whose docs fall outside a "
        "truncated term's impact head can be missed entirely; use "
        "lex_postings_budget='auto' or raise the budget "
        "(docs/benchmarks.md, budgeted AND-mode recall)"
    )


def _run_fts_query(
    engine: HybridSearchEngine,
    match_q: str,
    fetch_k: int,
    warn_sink: list[str] | None = None,
) -> list[tuple[int, float]]:
    """Evaluate one FTS5 MATCH string: the device lane for pure AND/OR bags, the host
    MATCH engine for positional/boolean queries. Raises MatchSyntaxError exactly where
    SQLite would (the caller falls back)."""
    node = parse_match_query(match_q)
    dev = _device_expressible(node)
    if dev is not None:
        mode, terms = dev
        if mode == "all" and len(terms) > 1 and warn_sink is not None:
            w = _and_budget_warning(engine)
            if w is not None and w not in warn_sink:
                warn_sink.append(w)
        tids = engine.lex.term_ids(terms)
        if mode == "all" and len(tids) < len(terms):
            return []  # an unindexed term makes the conjunction empty (FTS5)
        if not tids:
            return []
        padded = torch.from_numpy(pad_term_ids(tids, dfs=engine.lex.df)[None, :]).to(engine.device)
        vals, fids = _bm25_run(engine, padded, fetch_k, mode)
        return [
            (int(f), float(v))
            for f, v in zip(fids[0].cpu().numpy(), vals[0].cpu().numpy())
            if f >= 0
        ]
    hits = match_search(engine.lex, match_q, fetch_k)
    return [(h.frame_id, h.score) for h in hits]


def _bm25_lane(
    engine: HybridSearchEngine, query: str, fetch_k: int, warn_sink: list[str] | None = None
) -> tuple[list[tuple[int, float]], dict[int, str]]:
    """Primary MATCH query + OR-expanded fallback, primary hits first. Returns (hits,
    {frame_id: match query that retrieved it}); the latter drives FTS5-style snippet
    highlighting."""
    trimmed = query.strip()
    if not trimmed:
        return [], {}
    primary_q = primary_fts_query(trimmed) or trimmed
    fallback_q = or_expanded_query(trimmed)

    try:
        primary = _run_fts_query(engine, primary_q, fetch_k, warn_sink)
    except MatchSyntaxError:
        if fallback_q is None:
            # sanitization left no clauses (every token a stopword / letterless): a
            # natural-language query gets an EMPTY text lane, not a failed search;
            # explicit MATCH syntax still surfaces its syntax error as FTS5 does
            if not has_match_syntax(trimmed):
                return [], {}
            raise
        hits = _run_fts_query(engine, fallback_q, fetch_k, warn_sink)
        return hits, {f: fallback_q for f, _ in hits}

    queries = {f: primary_q for f, _ in primary}
    if fallback_q is None or fallback_q == primary_q or len(primary) >= fetch_k:
        return primary[:fetch_k], queries
    fallback = _run_fts_query(engine, fallback_q, fetch_k, warn_sink)
    seen = {f for f, _ in primary}
    extra = [(f, v) for f, v in fallback if f not in seen]
    queries.update({f: fallback_q for f, _ in extra})
    return (primary + extra)[:fetch_k], queries


def _vector_lane(
    engine: HybridSearchEngine, request: SearchRequest, fetch_k: int
) -> list[tuple[int, float]]:
    if request.embedding is not None:
        qv = np.asarray(request.embedding, np.float32)
    else:
        qv = engine.embed_query(request.query)
    if qv is None or len(engine.vector) == 0:
        return []
    n = np.linalg.norm(qv)
    if n > 0:
        qv = qv / n
    vals, fids = engine.vector.search(qv[None, :], fetch_k)
    return [(int(f), float(v)) for f, v in zip(fids[0], vals[0]) if f >= 0]


def _temporal_lane(engine: HybridSearchEngine, request: SearchRequest, fetch_k: int):
    metas = engine.frames.timeline(request.time_range, limit=fetch_k, newest_first=True)
    return [(m.frame_id, float(m.timestamp_ms)) for m in metas]


def _passes_filters(engine: HybridSearchEngine, request: SearchRequest, fid: int) -> bool:
    if request.frame_filter is not None and fid not in request.frame_filter:
        return False
    meta = engine.frames.get(fid)
    if meta is None or not engine.frames.is_live(fid):
        return False
    if request.time_range is not None and not request.time_range.contains(meta.timestamp_ms):
        return False
    if request.metadata_filter:
        for k, v in request.metadata_filter.items():
            if meta.metadata.get(k) != v:
                return False
    return True


def unified_search(engine: HybridSearchEngine, request: SearchRequest) -> SearchResponse:
    t0 = time.perf_counter()
    qtype = classify_query(request.query)
    weights = AdaptiveFusionConfig().for_type(qtype)
    signals = analyze_query(request.query)

    # candidate depth: 2*k headroom for fusion/rerank with a floor of 24, capped at the
    # reference's candidateLimit clamp (at most 1000 unless top_k itself exceeds it)
    fetch_k = max(min(request.top_k * 2, candidate_limit(request.top_k)), 24)

    lanes: dict[str, list[tuple[int, float]]] = {}
    snippet_queries: dict[int, str] = {}
    warnings: list[str] = []
    if request.mode in (SearchMode.HYBRID, SearchMode.TEXT_ONLY):
        with span("search.bm25_lane"):
            lanes["bm25"], snippet_queries = _bm25_lane(engine, request.query, fetch_k, warnings)
    if request.mode in (SearchMode.HYBRID, SearchMode.VECTOR_ONLY):
        with span("search.vector_lane"):
            lanes["vector"] = _vector_lane(engine, request, fetch_k)
    if (
        request.mode == SearchMode.HYBRID
        and request.use_structured_memory
        and engine.structured_evidence is not None
    ):
        ev = engine.structured_evidence(request.query, request.as_of_ms)
        lanes["structured"] = [(fid, 1.0) for fid in ev[:fetch_k]]
    if qtype == QueryType.TEMPORAL and request.mode == SearchMode.HYBRID:
        lanes["temporal"] = _temporal_lane(engine, request, fetch_k)

    if request.mode == SearchMode.TEXT_ONLY:
        weights = {"bm25": 1.0}
    elif request.mode == SearchMode.VECTOR_ONLY:
        weights = {"vector": 1.0}

    fused = rrf_fuse(lanes, weights, rrf_k=request.rrf_k)
    fused = [h for h in fused if _passes_filters(engine, request, h.frame_id)]

    # preview hydration: text-lane hits get the FTS5-style highlighted snippet, others
    # the raw frame preview. Only hits that can reach the response need it: rerank
    # permutes within the head window and the response takes top_k.
    hydrate = max(_RERANK_WINDOW, request.top_k)
    unparsable: set[str] = set()  # one bad MATCH string fails for every doc
    previews = {}
    for i, h in enumerate(fused):
        snip = None
        sq = snippet_queries.get(h.frame_id)
        if sq is not None and i < hydrate and sq not in unparsable:
            content = engine.frames.content(h.frame_id)
            if content:
                snip = snippet_for_query(content, sq)
                if snip is None:
                    unparsable.add(sq)
                # preview_max_bytes is this API's transport cap: enforce it byte-safely
                if snip is not None and len(snip.encode()) > request.preview_max_bytes:
                    snip = snip.encode()[: request.preview_max_bytes].decode(errors="ignore")
        previews[h.frame_id] = snip or engine.frames.preview(h.frame_id, request.preview_max_bytes)

    fused = intent_aware_rerank(
        fused,
        previews,
        signals,
        window=_RERANK_WINDOW,
        vector_influenced=lambda h: "vector" in h.sources,
    )

    # timeline fallback when every lane came up empty
    if not fused and request.mode == SearchMode.HYBRID:
        metas = engine.frames.timeline(request.time_range, limit=request.top_k)
        fused = [
            FusedHit(m.frame_id, 0.0, i + 1, {"temporal": i + 1}, {"temporal": float(m.timestamp_ms)})
            for i, m in enumerate(metas)
            if _passes_filters(engine, request, m.frame_id)
        ]
        previews.update(
            {h.frame_id: engine.frames.preview(h.frame_id, request.preview_max_bytes) for h in fused}
        )

    hits = []
    for i, h in enumerate(fused[: request.top_k]):
        if h.frame_id in snippet_queries and h.frame_id in previews:
            snippet = previews[h.frame_id]  # FTS5-marked snippet from hydration
        else:
            content = engine.frames.content(h.frame_id) or ""
            snippet = make_snippet(content, signals.content_terms or tuple(analyze(request.query)))
        diag = None
        if request.include_diagnostics:
            # which criterion separated this hit from its neighbour
            tie = "score"
            prev = fused[i - 1] if i > 0 else None
            if prev is not None and prev.score == h.score:
                tie = "best_rank" if prev.best_rank != h.best_rank else "frame_id"
            diag = RankingDiagnostics(
                lane_ranks=dict(h.lane_ranks),
                lane_scores=dict(h.lane_scores),
                rrf_score=h.score,
                tie_break=tie,
            )
        hits.append(
            SearchHit(
                frame_id=h.frame_id,
                score=h.score,
                preview=snippet or previews.get(h.frame_id, ""),
                sources=tuple(_LANE_SOURCE[s] for s in h.sources if s in _LANE_SOURCE),
                diagnostics=diag,
            )
        )

    return SearchResponse(
        hits=tuple(hits),
        query_type=qtype,
        lane_counts={k: len(v) for k, v in lanes.items()},
        elapsed_ms=(time.perf_counter() - t0) * 1e3,
        warnings=tuple(warnings),
    )
