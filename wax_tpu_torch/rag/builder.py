# Port of wax_tpu/rag/builder.py onto the port's `unified_search` and
# `HybridSearchEngine`: the JAX module's text with its imports pointed at
# wax_tpu_torch. Keep the two in step.
"""Deterministic token-budgeted RAG context assembly.

Mirrors the reference's FastRAGContextBuilder (reference:
Sources/Wax/RAG/FastRAGContextBuilder.swift:15-341 — unified search ->
answer-focused rerank (:384-506) -> ONE expansion item (first result's full content,
token-truncated, :518) -> surrogate items (dense_cached mode, tier-selected) ->
snippet items; strict cl100k token budgeting with per-item caps). Pure host logic over
device search results; byte-identical across repeated builds for the same inputs.
"""
from __future__ import annotations

from wax_tpu_torch.index.lex import analyze
from wax_tpu_torch.rag.config import FastRAGConfig
from wax_tpu_torch.rag.context import RAGContext, RAGItem, RAGItemKind
from wax_tpu_torch.rag.importance import ImportanceScorer, SurrogateTierSelector
from wax_tpu_torch.rag.surrogates import generate_surrogate
from wax_tpu_torch.search.engine import HybridSearchEngine
from wax_tpu_torch.search.unified import make_snippet, unified_search
from wax_tpu_torch.text.analyzer import analyze_query
from wax_tpu_torch.text.token_counter import TokenCounter
from wax_tpu_torch.types import SearchRequest, now_ms

__all__ = ["FastRAGContextBuilder"]


class FastRAGContextBuilder:
    def __init__(
        self,
        engine: HybridSearchEngine,
        config: FastRAGConfig = FastRAGConfig(),
        counter: TokenCounter | None = None,
        access_stats=None,  # orchestrator.stats.AccessStats | None
    ):
        self.engine = engine
        self.config = config
        self.counter = counter or TokenCounter()
        self.access_stats = access_stats
        self.importance = ImportanceScorer()
        self.tier_selector = SurrogateTierSelector()

    # -- answer-focused rerank (reference :384-506) -------------------------------------
    def _rerank_for_answer(self, hits, signals):
        from wax_tpu_torch.search.rerank import rerank_for_answer

        # hybrid search: the vector lane contributes unless alpha pins text-only
        # (reference: vectorInfluenced switch, FastRAGContextBuilder.swift:398-406)
        vector_influenced = self.engine.vector is not None and len(self.engine.vector) > 0
        return rerank_for_answer(
            hits,
            contents=lambda fid: self.engine.frames.content(fid) or "",
            signals=signals,
            window=self.config.rerank_window,
            distractor_penalty=self.config.distractor_penalty,
            vector_influenced=vector_influenced,
        )

    def _expand_second_hop(self, signals, hits):
        """Bridge-entity second hop: for intent queries ("where does the owner of
        the blue tandem bike live"), entities the top hits introduce that the query
        never mentioned (the bridge: Sofia, the Chen family) seed one secondary
        search; its novel hits append to the candidate pool so BOTH hops land in
        the assembled context. Deterministic: bridge order is (hit rank, first
        occurrence); one extra search, bounded by config.second_hop_hits."""
        cfg = self.config
        if not cfg.second_hop_hits or not hits:
            return hits
        if not (
            signals.asks_location
            or signals.asks_date
            or signals.asks_ownership
            or signals.multi_hop
        ):
            return hits
        known = {t for t in signals.content_terms} | {e.lower() for e in signals.entity_terms}
        bridges: list[str] = []
        for h in hits[:3]:
            content = self.engine.frames.content(h.frame_id) or ""
            for e in analyze_query(content[:2000]).entity_terms:
                el = e.lower()
                if el in known or any(el == b.lower() for b in bridges):
                    continue
                bridges.append(e)
        if not bridges:
            return hits
        resp2 = unified_search(
            self.engine,
            SearchRequest(
                query=" ".join(bridges[:4]),
                top_k=cfg.second_hop_hits,
                rrf_k=cfg.rrf_k,
                preview_max_bytes=cfg.expansion_max_bytes,
            ),
        )
        seen = {h.frame_id for h in hits}
        extra = [h for h in resp2.hits if h.frame_id not in seen]
        return hits + extra[: cfg.second_hop_hits]

    def build(self, query: str, top_k: int | None = None) -> RAGContext:
        cfg = self.config
        signals = analyze_query(query)
        request = SearchRequest(
            query=query,
            top_k=top_k or cfg.search_top_k,
            rrf_k=cfg.rrf_k,
            preview_max_bytes=cfg.expansion_max_bytes,
        )
        response = unified_search(self.engine, request)
        hits = self._rerank_for_answer(list(response.hits), signals)
        hits = self._expand_second_hop(signals, hits)

        now = cfg.deterministic_now_ms if cfg.deterministic_now_ms is not None else now_ms()
        items: list[RAGItem] = []
        budget = cfg.max_context_tokens
        used = 0
        seen_frames: set[int] = set()

        # 1. expansion: first result's full content, token-truncated (reference :87-110)
        if hits and cfg.include_expansion:
            top = hits[0]
            content = self.engine.frames.content(top.frame_id) or ""
            content = content[: cfg.expansion_max_bytes]
            cap = min(cfg.expansion_max_tokens, budget - used)
            text = self.counter.truncate(content, cap)
            tokens = self.counter.count(text)
            if text and tokens <= budget - used:
                items.append(
                    RAGItem(
                        kind=RAGItemKind.EXPANDED,
                        frame_id=top.frame_id,
                        score=top.score,
                        text=text,
                        token_count=tokens,
                        sources=tuple(s.value for s in top.sources),
                    )
                )
                used += tokens
                seen_frames.add(top.frame_id)

        # 2. surrogates in dense_cached mode (reference :113-140)
        if cfg.mode == "dense_cached":
            n_surr = 0
            for hit in hits[1:]:
                if n_surr >= cfg.max_surrogates or used >= budget:
                    break
                if hit.frame_id in seen_frames:
                    continue
                meta = self.engine.frames.get(hit.frame_id)
                content = self.engine.frames.content(hit.frame_id) or ""
                if not content:
                    continue
                acc_count, last_ms = 0, None
                if self.access_stats is not None:
                    acc_count, last_ms = self.access_stats.stats_for(hit.frame_id)
                imp = self.importance.score(
                    now, meta.timestamp_ms if meta else now, acc_count, last_ms
                )
                tier = self.tier_selector.select(imp, signals.specificity)
                surr = generate_surrogate(content, tier, self.counter)
                tokens = min(surr.token_count, cfg.surrogate_max_tokens)
                text = self.counter.truncate(surr.text, min(tokens, budget - used))
                tokens = self.counter.count(text)
                if text and tokens <= budget - used:
                    items.append(
                        RAGItem(
                            kind=RAGItemKind.SURROGATE,
                            frame_id=hit.frame_id,
                            score=hit.score,
                            text=text,
                            token_count=tokens,
                            sources=tuple(s.value for s in hit.sources),
                        )
                    )
                    used += tokens
                    seen_frames.add(hit.frame_id)
                    n_surr += 1

        # 3. snippets under the remaining budget
        terms = signals.content_terms or tuple(analyze(query))
        n_snip = 0
        for hit in hits:
            if n_snip >= cfg.max_snippets or used >= budget:
                break
            if hit.frame_id in seen_frames:
                continue
            content = self.engine.frames.content(hit.frame_id) or ""
            if not content:
                continue
            snippet = make_snippet(content, terms, max_len=4 * cfg.snippet_max_tokens * 4)
            cap = min(cfg.snippet_max_tokens, budget - used)
            text = self.counter.truncate(snippet, cap)
            tokens = self.counter.count(text)
            if text and tokens <= budget - used:
                items.append(
                    RAGItem(
                        kind=RAGItemKind.SNIPPET,
                        frame_id=hit.frame_id,
                        score=hit.score,
                        text=text,
                        token_count=tokens,
                        sources=tuple(s.value for s in hit.sources),
                    )
                )
                used += tokens
                seen_frames.add(hit.frame_id)
                n_snip += 1

        return RAGContext(
            items=tuple(items),
            total_tokens=used,
            query=query,
            budget_tokens=budget,
            diagnostics={
                "query_type": response.query_type.value,
                "lane_counts": dict(response.lane_counts),
                "n_hits": len(hits),
            },
        )
