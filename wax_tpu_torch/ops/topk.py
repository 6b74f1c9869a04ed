"""Top-k utilities with a stable lowest-index tie-break.

PyTorch port of `wax_tpu.ops.topk`. The JAX package gets its tie-break from
`lax.top_k` being stable; `torch.topk` promises no order among equal values on the
CPU or the GPU, so every selection here goes through a stable descending sort: among
equal scores the lower index comes first. That rule is the determinism contract the
whole port relies on (dead slots carry score NEG_INF and index -1).
"""
from __future__ import annotations

import torch

__all__ = ["NEG_INF", "stable_top_k", "masked_top_k", "merge_topk", "topk_with_ids", "blockmax_topk"]

NEG_INF = -3.0e38


def stable_top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis; equal values
    keep ascending index order. Indices are int64, as torch indexing wants."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def masked_top_k(scores: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """Top-k over the last axis with an optional validity mask.

    Returns (values [..., k] f32, indices [..., k] int32); excluded or overflow slots
    carry NEG_INF and index -1.
    """
    scores = scores.float()
    if mask is not None:
        scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    vals, idx = stable_top_k(scores, k)
    idx = torch.where(vals <= NEG_INF, -1, idx).to(torch.int32)
    return vals, idx


def merge_topk(vals_a, idx_a, vals_b, idx_b, k: int):
    """Merge two top-k candidate lists; on score ties the candidate earlier in the
    [a | b] concatenation wins."""
    vals = torch.cat([vals_a, vals_b], dim=-1)
    idx = torch.cat([idx_a, idx_b], dim=-1)
    mvals, pos = stable_top_k(vals, k)
    midx = torch.gather(idx, -1, pos)
    midx = torch.where(mvals <= NEG_INF, -1, midx)
    return mvals, midx


def blockmax_topk(scores: torch.Tensor, k: int):
    """Exact top-k over the last axis via chunk-max pruning (n % 128 == 0).

    Every top-k element's 128-chunk has a top-k chunk maximum, so only the k best
    chunks are gathered and ranked. Winning chunks are gathered in ascending chunk
    order so that exact ties still resolve to the lowest global index.

    Returns (values [B, k], indices [B, k] int32).
    """
    b, n = scores.shape
    if n % 128 or n <= 128 * k:
        vals, idx = stable_top_k(scores, k)
        return vals, idx.to(torch.int32)
    c = n // 128
    s3 = scores.reshape(b, c, 128)
    cmax = s3.amax(dim=2)
    kc = min(k, c)
    _, chunks = stable_top_k(cmax, kc)
    chunks, _ = torch.sort(chunks, dim=1)
    cand = torch.gather(s3, 1, chunks[:, :, None].expand(b, kc, 128))
    vals, pos = stable_top_k(cand.reshape(b, kc * 128), k)
    idx = torch.gather(chunks, 1, pos // 128) * 128 + pos % 128
    return vals, idx.to(torch.int32)


def topk_with_ids(scores: torch.Tensor, ids: torch.Tensor, k: int, mask: torch.Tensor | None = None):
    """Masked top-k that also gathers an id array: (values, row_indices, ids)."""
    vals, idx = masked_top_k(scores, k, mask)
    safe = idx.clamp(min=0).long()
    out_ids = torch.where(idx >= 0, ids[safe], -1)
    return vals, idx, out_ids.to(torch.int32)
