"""The BM25 lane over one device's lexical snapshot (`index/lex.LexIndex`).

`bm25_candidates` is the one place that picks a snapshot's candidate generator and
fetch (the table in README's port section). The one-device entries
`bm25_candidates_topk` (the plain merge harness) and `bm25_candidates_topk_pallas` (the
kernels), and every shard of `parallel/sharded_hybrid` (on `ShardedLexIndex.shard(s)`),
run it, rescore a budgeted snapshot's candidates exactly (`ops/bm25_rescore`, K3) and
map rows to frame ids with `lane_frame_ids`.
"""
from __future__ import annotations

import torch

from wax_tpu_torch.index.lex import LexIndex
from wax_tpu_torch.ops.bm25_candidates import candidate_scores_sorted, wide_topk
from wax_tpu_torch.ops.bm25_candidates_pallas import candidate_scores_pallas
from wax_tpu_torch.ops.bm25_chunked_pallas import _SEL_LEVELS, chunked_candidates_sel
from wax_tpu_torch.ops.bm25_rescore import rescore_topk
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.utils.profiling import device_span

__all__ = ["bm25_candidates", "bm25_candidates_topk", "bm25_candidates_topk_pallas", "lane_frame_ids"]


def bm25_candidates(term_ids, index: LexIndex, k: int, mode: str, kernels: bool, fetch: int | None = None):
    """One device's BM25 candidates for [B, Q] int32 term ids on the snapshot's device,
    in the span `bm25.candidates`. Unbudgeted snapshot: exact scores by K8's plane
    (`kernels`) or the harness, and the lane's answer (vals [B, k] f32, rows [B, k] -1
    dead). Budgeted (the snapshot carries a forward index): generated OR-mode
    ("count"-ranked for AND queries) by K4's selection where the snapshot has impact
    chunks, else K8's selection mode (`kernels`), or by the harness ranked with
    `wide_topk(exact=False)`; (None, the top-F rows to rescore, -1 dead), F the fetch
    (default max(4k, 256)) or the candidates there are, if fewer."""
    args = (term_ids, index.doc_rows, index.wnorm, index.offsets, index.idf)
    max_df = int(index.max_df)
    with device_span("bm25.candidates", index.device):
        if index.fwd_tids is None:
            if kernels:
                rows, scores = candidate_scores_pallas(*args, max_df=max_df, mode=mode)
            else:
                rows, scores = candidate_scores_sorted(*args, max_df, mode)
            vals, pos = wide_topk(scores, k)
            return vals, torch.where(vals > NEG_INF * 0.5, torch.gather(rows, 1, pos), -1)
        gen_mode = "count" if mode == "all" else "any"
        f = fetch if fetch is not None else max(4 * k, 256)
        if not kernels:
            rows, scores = candidate_scores_sorted(*args, max_df, gen_mode)
            cvals, cpos = wide_topk(scores, int(min(f, scores.shape[-1])), exact=False)
            return None, torch.where(cvals > NEG_INF * 0.5, torch.gather(rows, 1, cpos), -1)
        if index.pk_chunks is not None:
            rows, keys = chunked_candidates_sel(term_ids, index.pk_chunks, index.chunk_base, index.chunk_counts,
                                                qb=index.pk_qb, max_chunks=index.pk_max_chunks, mode=gen_mode,
                                                sel=_SEL_LEVELS)
        else:
            rows, keys = candidate_scores_pallas(*args, max_df=max_df, mode=gen_mode, sel=_SEL_LEVELS)
        _, cpos = stable_top_k(keys, int(min(f, keys.shape[-1])))
        return None, torch.gather(rows, 1, cpos)


def lane_frame_ids(index: LexIndex, vals, rows):
    """[B, k] i32 frame ids of a lane's rows, -1 where the score is dead."""
    return torch.where(vals > NEG_INF * 0.5, index.frame_ids[rows.clamp(min=0).long()], -1).to(torch.int32)


def _topk(term_ids, index: LexIndex, k: int, mode: str, kernels: bool, fetch: int | None):
    if index.wnorm is None:
        raise ValueError("snapshot has no precomputed wnorm")
    k = int(min(k, index.frame_ids.shape[0]))
    term_ids = torch.as_tensor(term_ids).to(index.device, torch.int32)
    if term_ids.dim() == 1:
        term_ids = term_ids[None, :]
    vals, rows = bm25_candidates(term_ids, index, k, mode, kernels, fetch)
    if index.fwd_tids is not None:
        vals, rows = rescore_topk(term_ids, rows, index.fwd_tids, index.fwd_wnorm, index.idf, k, mode,
                                  fwd_width=index.fwd_width, fwd_fused=index.fwd_fused)
    return vals, rows.to(torch.int32), lane_frame_ids(index, vals, rows)


def bm25_candidates_topk(term_ids, index: LexIndex, k: int, mode: str = "any", fetch: int | None = None):
    """Candidate-set BM25 top-k on the plain merge harness, the contract of `ops/bm25.py`
    `bm25_topk`: (scores [B, k], rows [B, k], frame_ids [B, k]); non-matches are
    (NEG_INF, -1, -1). On a budgeted snapshot the top-`fetch` candidates (default
    max(4k, 256)) are rescored exactly against its forward index."""
    return _topk(term_ids, index, k, mode, False, fetch)


def bm25_candidates_topk_pallas(term_ids, index: LexIndex, k: int, mode: str = "any", fetch: int | None = None):
    """`bm25_candidates_topk` through the kernels: K8's plane on an unbudgeted snapshot;
    on a budgeted one K4's selection (impact chunks) or K8's, then K3."""
    return _topk(term_ids, index, k, mode, True, fetch)
