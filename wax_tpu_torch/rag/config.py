# Verbatim copy of wax_tpu/rag/config.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""FastRAG configuration.

Mirrors the reference's FastRAGConfig budgets (reference:
Sources/Wax/RAG/FastRAGConfig.swift:66-162 — maxContextTokens 1500, expansion 600
tokens / 2 MiB, snippets 200 tokens x 24, surrogates 60 tokens x 8, searchTopK 24,
rrfK 60, rerank window 12, distractor penalty 0.30, tier policy, deterministicNowMs).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

__all__ = ["FastRAGConfig"]


@dataclass(frozen=True)
class FastRAGConfig:
    max_context_tokens: int = 1500
    expansion_max_tokens: int = 600
    expansion_max_bytes: int = 2 * 1024 * 1024
    snippet_max_tokens: int = 200
    max_snippets: int = 24
    surrogate_max_tokens: int = 60
    max_surrogates: int = 8
    search_top_k: int = 24
    rrf_k: float = 60.0
    rerank_window: int = 12
    distractor_penalty: float = 0.30
    # "fast" skips surrogate items; "dense_cached" includes tier-selected surrogates
    mode: Literal["fast", "dense_cached"] = "fast"
    include_expansion: bool = True
    # bridge-entity second-hop expansion for indirection queries ("where does the
    # owner of X live"): entities surfaced by the top hits but absent from the
    # query seed ONE secondary search whose novel hits join the candidate pool.
    # Capability beyond the reference: its QueryAnalyzer defines a multiHop intent
    # but nothing consumes it (QueryAnalyzer.swift:240) — joining the second hop
    # there relies on ranking luck. 0 disables.
    second_hop_hits: int = 4
    # injected clock for byte-identical builds in tests (reference deterministicNowMs)
    deterministic_now_ms: int | None = None
