"""BM25 scoring over CSR postings, in plain torch.

PyTorch port of `wax_tpu.ops.bm25` (the JAX package has no hand-written kernel for
this lane: XLA gathers and scatter-adds). Semantics are the JAX package's:

  * "all" mode mirrors FTS5's implicit-AND queries: only rows matching every
    distinct query term keep a score;
  * "any" mode mirrors the OR-expanded fallback query.

Two departures in how, not what:

  * The JAX scorer pads every term to the snapshot's longest postings list
    (`max_df`), which on a Zipf corpus makes [B, Q, max_df] planes of hundreds of
    millions of elements. Here each term gathers only its own CSR slice.
  * Scatter-adds with atomics sum in no fixed order on a GPU, which would break the
    determinism contract. Here the contributions are added one query-term column at a
    time; within a column every (query, row) pair occurs at most once, so each add is
    a plain gather-add-store, and each row's score is summed in query-term order, the
    order of the JAX package's scatter.
"""
from __future__ import annotations

import numpy as np
import torch

from wax_tpu_torch.index.lex import BM25_B, BM25_K1, LexIndex
from wax_tpu_torch.ops.topk import masked_top_k

__all__ = ["bm25_scores", "bm25_topk", "pad_term_ids", "MAX_QUERY_TERMS", "MAX_QUERY_TERMS_HARD"]

# Padded query widths are multiples of this (kept from the JAX package, whose jitted
# scorer compiles one variant per width).
MAX_QUERY_TERMS = 16
# Beyond this many distinct terms the rarest (highest-idf) head is kept.
MAX_QUERY_TERMS_HARD = 128


def pad_term_ids(term_ids: list[int], max_terms: int | None = None, dfs=None) -> np.ndarray:
    """Distinct term ids in query order, padded with -1 to a bucket width.

    Args:
      term_ids: raw (possibly repeated) term ids in query order.
      max_terms: explicit width; default = the distinct count rounded up to a multiple
        of MAX_QUERY_TERMS, capped at MAX_QUERY_TERMS_HARD.
      dfs: optional callable tid -> document frequency. When the distinct-term count
        exceeds the cap, the kept head is the LOWEST-df terms, ties by query order.
    """
    seen: list[int] = []
    for t in term_ids:
        if t not in seen:
            seen.append(t)
    cap = max_terms if max_terms is not None else MAX_QUERY_TERMS_HARD
    if len(seen) > cap:
        if dfs is not None:
            order = sorted(range(len(seen)), key=lambda i: (dfs(seen[i]), i))
            seen = [seen[i] for i in sorted(order[:cap])]
        else:
            seen = seen[:cap]
    if max_terms is None:
        max_terms = max(MAX_QUERY_TERMS, -(-len(seen) // MAX_QUERY_TERMS) * MAX_QUERY_TERMS)
    out = np.full(max_terms, -1, np.int32)
    out[: len(seen)] = seen
    return out


def bm25_scores(term_ids: torch.Tensor, index: LexIndex, mode: str = "any") -> torch.Tensor:
    """BM25 scores for a batch of queries.

    Args:
      term_ids: [B, Q] int32 distinct term ids, -1 padded (numpy or tensor).
      index: LexIndex snapshot.
      mode: "any" (OR) or "all" (AND, FTS5 parity).

    Returns:
      [B, N_cap] f32 scores on the index's device; non-matching, tombstoned and
      padded rows are 0.
    """
    if mode not in ("any", "all"):
        raise ValueError(f"mode must be 'any' or 'all', got {mode!r}")
    dev = index.device
    tids = torch.as_tensor(term_ids).to(dev, torch.int64)
    if tids.dim() == 1:
        tids = tids[None, :]
    b, q = tids.shape
    n_cap = index.doc_len.shape[0]

    valid_term = tids >= 0
    safe = tids.clamp(min=0)
    offsets = index.offsets.long()
    off = offsets[safe]
    length = torch.where(valid_term, offsets[safe + 1] - off, 0)
    idf = index.idf[safe]
    totals = length.sum(dim=0).tolist()  # one host sync: postings per term column

    scores = torch.zeros((b, n_cap), dtype=torch.float32, device=dev)
    flat_scores = scores.view(-1)
    hits = torch.zeros((b, n_cap), dtype=torch.float32, device=dev) if mode == "all" else None
    qidx = torch.arange(b, device=dev)
    for j in range(q):
        total = int(totals[j])
        if total == 0:
            continue
        lj = length[:, j]
        owner = torch.repeat_interleave(qidx, lj, output_size=total)  # query of each posting
        start = torch.cumsum(lj, 0) - lj
        pos = off[owner, j] + torch.arange(total, device=dev) - start[owner]
        rows = index.doc_rows[pos].long()
        tf = index.tfs[pos]
        dl = index.doc_len[rows]
        denom = tf + BM25_K1 * (1.0 - BM25_B + BM25_B * dl / index.avgdl)
        contrib = idf[owner, j] * (tf * (BM25_K1 + 1.0)) / denom.clamp(min=1e-9)
        flat = owner * n_cap + rows  # unique within one term column
        flat_scores[flat] = flat_scores[flat] + contrib
        if hits is not None:
            flat_hits = hits.view(-1)
            flat_hits[flat] = flat_hits[flat] + 1.0

    if hits is not None:
        n_terms = valid_term.sum(dim=1, keepdim=True).float()
        scores = torch.where(hits >= n_terms, scores, 0.0)
    live = index.active & (torch.arange(n_cap, device=dev) < index.count)
    return torch.where(live[None, :], scores, 0.0)


def bm25_topk(term_ids: torch.Tensor, index: LexIndex, k: int, mode: str = "any"):
    """BM25 top-k: (scores [B, k], rows [B, k], frame_ids [B, k]); rows with score 0
    (no match) are excluded (row and frame id -1)."""
    k = int(min(k, index.frame_ids.shape[0]))
    scores = bm25_scores(term_ids, index, mode=mode)
    vals, rows = masked_top_k(scores, k, mask=scores > 0.0)
    safe = rows.clamp(min=0).long()
    fids = torch.where(rows >= 0, index.frame_ids[safe], -1).to(torch.int32)
    return vals, rows, fids
