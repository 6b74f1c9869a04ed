# Verbatim copy of wax_tpu/orchestrator/config.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
"""Orchestrator configuration.

Mirrors the reference's OrchestratorConfig (reference:
Sources/Wax/Orchestrator/OrchestratorConfig.swift:4-28 — feature enables, chunking
target/overlap 400/40, batch sizes, embedding-cache capacity, on-device provider
requirement, scheduled live-set rewrite policy).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

from wax_tpu_torch.rag.config import FastRAGConfig
from wax_tpu_torch.storage.store import StoreOptions
from wax_tpu_torch.text.chunker import ChunkingStrategy

__all__ = ["OrchestratorConfig", "RewriteSchedule"]


@dataclass(frozen=True)
class RewriteSchedule:
    """Scheduled live-set rewrite gates (reference:
    MemoryOrchestrator+Maintenance.swift:289-380 and README:175-186)."""

    enabled: bool = False
    min_flush_count: int = 8
    min_interval_ms: int = 3_600_000
    min_dead_bytes: int = 8 * 1024 * 1024


@dataclass(frozen=True)
class OrchestratorConfig:
    enable_text_search: bool = True
    enable_vector_search: bool = True
    # "auto" | "flat" (exact fused scan) | "hnsw" (approximate graph) — mirrors the
    # reference's VectorEnginePreference {auto, metalPreferred, cpuOnly}
    vector_engine: str = "auto"
    # distribute the heavy lanes (dense scan + BM25) over all local devices via the
    # data mesh; host lanes (structured, temporal) and fusion/rerank are unchanged, so
    # results match the single-chip path. With vector_engine="auto" this also selects
    # the sharded flat scan.
    sharded_lanes: bool = False
    # topology for the sharded lanes (SURVEY §5: collectives ride ICI within a pod
    # slice, DCN across slices). mesh_slices=1 → flat data mesh over all local
    # devices; >1 → two-level ("slice", "data"[, "tp"]) mesh where candidate
    # all-gathers stay inside a slice and only [B, k] merged lists cross the slice
    # axis (parallel/mesh.make_two_level_mesh). mesh_tp>1 splits each slice's
    # devices further for tensor-parallel embedder serving. Both lanes (dense scan
    # + BM25) share ONE mesh. Ignored unless sharded_lanes is on.
    mesh_slices: int = 1
    mesh_tp: int = 1

    def __post_init__(self):
        if (self.mesh_slices > 1 or self.mesh_tp > 1) and not self.sharded_lanes:
            raise ValueError(
                "mesh_slices/mesh_tp describe the sharded-lane topology — "
                "set sharded_lanes=True (a silent single-chip fallback would "
                "ship the wrong layout)"
            )
    # per-term postings cap for device BM25 (impact-ordered truncation, index/lex.py).
    # None = exhaustive exact scoring. An int (e.g. 4096) bounds the static scoring
    # budget W = max_df on 1M+ corpora; truncation only limits candidate generation —
    # returned scores stay unbudgeted-exact via the forward-index rescore. "auto"
    # resolves per snapshot: exact below 256K rows, then max(4096, n//256)
    # (LexIndexBuilder.resolve_postings_budget; recall table in docs/benchmarks.md).
    lex_postings_budget: int | str | None = None
    enable_structured_memory: bool = True
    enable_access_stats: bool = True
    chunking: ChunkingStrategy = field(default_factory=ChunkingStrategy)
    embed_batch_size: int = 256
    embedding_cache_capacity: int = 2048
    # persistent XLA compile cache next to the store (skips first-query jit
    # compiles in fresh processes); disable for processes managing their own cache
    enable_compile_cache: bool = True
    require_on_device_providers: bool = True
    store: StoreOptions = field(default_factory=StoreOptions)
    rag: FastRAGConfig = field(default_factory=FastRAGConfig)
    rewrite_schedule: RewriteSchedule = field(default_factory=RewriteSchedule)
    # injectable clock (ms) for deterministic replay/tests (reference:
    # TimestampOverrideTests / deterministicNowMs); None = wall clock
    clock_ms: Callable[[], int] | None = None
    # What to do when the committed vec segment was built by a DIFFERENT embedding
    # provider than the one this orchestrator was opened with (detected via the
    # `embedder` identity recorded in the segment attrs):
    #   "error"   — refuse to open (default: silent recall corruption is worse)
    #   "reindex" — drop the index and re-embed every live frame's search text with
    #               the current provider (text-derived embeddings only; vectors put
    #               directly via put_embedding, e.g. multimodal, are rebuilt by their
    #               own orchestrators' re-ingest paths)
    #   "ignore"  — keep the mismatched index (pre-round-2 behavior)
    embedder_mismatch: str = "error"
