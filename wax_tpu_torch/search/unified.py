"""Unified hybrid search, narrowed to the BM25 lane dispatch.

PyTorch port of `wax_tpu.search.unified._bm25_run`: one BM25 top-k pass over a
`HybridSearchEngine`, sent to the sharded lane when the engine is configured for it,
to the candidate lane with its exact rescore when the postings budget truncated a
term, and to the scatter-free CSR lane otherwise. The rest of `unified_search`
(query classifier, MATCH parser, rerank, RAG assembly) belongs to the orchestrator
slice; the JAX package's executable cache has no counterpart here.
"""
from __future__ import annotations

from wax_tpu_torch.ops.bm25 import bm25_topk
from wax_tpu_torch.ops.bm25_candidates import bm25_candidates_topk
from wax_tpu_torch.parallel.sharded_hybrid import sharded_bm25_topk
from wax_tpu_torch.search.engine import HybridSearchEngine

__all__ = ["_bm25_run"]


def _bm25_run(engine: HybridSearchEngine, padded, fetch_k: int, mode: str):
    """One BM25 top-k pass over padded term ids [B, W]: (scores [B, fetch_k],
    frame_ids [B, fetch_k]) tensors on the engine's device."""
    if engine.lex_sharded:
        return sharded_bm25_topk(padded, engine.lex_sharded_snapshot(), fetch_k, engine.mesh, mode=mode)
    snap = engine.lex_snapshot()
    if snap.fwd_tids is not None:
        # the budget truncated a term: the candidate lane rescores its top-F against
        # the forward index, restoring the exact multi-term scores
        vals, _, fids = bm25_candidates_topk(padded, snap, fetch_k, mode=mode)
        return vals, fids
    vals, _, fids = bm25_topk(padded, snap, fetch_k, mode=mode)
    return vals, fids
