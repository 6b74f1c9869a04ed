"""Candidate-set BM25: top-k over the sorted postings of the query terms, in plain torch.

PyTorch port of `wax_tpu.ops.bm25_candidates` (the JAX package has no hand-written
kernel here: this is the XLA harness its unified search runs on budgeted snapshots).
Per query, each term's CSR slice (rows ascending, tf-normalised weight precomputed)
is laid into a [Q2, W2] plane, the sorted runs are merged by the same bitonic merge
network, equal rows are segment-summed by the same Hillis-Steele passes, and a top-k
picks the candidates.

The merge network is ported as it is, not replaced by a sort: a bitonic merge is not
stable, so the order in which a row's contributions from three or more terms meet
depends on the network, and that order decides the last bit of their f32 sum. Running
the same network keeps `candidate_scores_sorted` bit-equal to the JAX package's.

It is the BM25 lane's plain harness (`ops/bm25_lane.py`): on a budgeted snapshot the
lane ranks its candidates with `wide_topk(exact=False)` and rescores the top-F exactly
(`ops/bm25_rescore.py`, K3).
"""
from __future__ import annotations

import torch

from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k

__all__ = [
    "candidate_scores_sorted",
    "merge_sorted_runs",
    "segment_sum_sorted",
    "wide_topk",
]

# sentinel row for padding: sorts after every real row
_SENTINEL = 2**30


def _cmp_exchange(rows, payload, d: int):
    """One bitonic compare-exchange stage at distance d over the last axis; payload
    tensors move with their row key, and ties keep the first-run element low."""
    shape = rows.shape
    nb = shape[-1] // (2 * d)
    r = rows.reshape(shape[:-1] + (nb, 2, d))
    r0, r1 = r[..., 0, :], r[..., 1, :]
    sel = r0 <= r1
    rows = torch.stack([torch.minimum(r0, r1), torch.maximum(r0, r1)], dim=-2).reshape(shape)
    out = []
    for v in payload:
        v = v.reshape(shape[:-1] + (nb, 2, d))
        v0, v1 = v[..., 0, :], v[..., 1, :]
        out.append(torch.stack([torch.where(sel, v0, v1), torch.where(sel, v1, v0)], dim=-2).reshape(shape))
    return rows, out


def _merge(rows, payload, run_len: int):
    shape = rows.shape
    npairs = shape[-1] // (2 * run_len)

    def rev2(x):
        x = x.reshape(shape[:-1] + (npairs, 2, run_len))
        return torch.cat([x[..., 0:1, :], torch.flip(x[..., 1:2, :], dims=(-1,))], dim=-2).reshape(shape)

    rows, payload = rev2(rows), [rev2(v) for v in payload]
    d = run_len
    while d >= 1:
        rows, payload = _cmp_exchange(rows, payload, d)
        d //= 2
    return rows, payload


def merge_sorted_runs(rows, vals, cnts, run_len: int):
    """Merge adjacent pairs of sorted runs of length `run_len` along the last axis
    (bitonic: reverse every second run, then compare-exchange at run_len, ..., 1)."""
    rows, (vals, cnts) = _merge(rows, [vals, cnts], run_len)
    return rows, vals, cnts


def segment_sum_sorted(rows, vals, cnts, max_run: int):
    """Hillis-Steele segmented sum over a row-sorted list: after ceil(log2(max_run))
    doubling passes the LAST element of each equal-row run holds the run's sums.
    Returns (leader_mask, summed_vals, summed_cnts)."""
    idx = torch.arange(rows.shape[-1], device=rows.device)
    d = 1
    while d < max_run:
        ok = (idx >= d) & (torch.roll(rows, d, dims=-1) == rows)
        vals = vals + torch.where(ok, torch.roll(vals, d, dims=-1), 0.0)
        cnts = cnts + torch.where(ok, torch.roll(cnts, d, dims=-1), 0)
        d *= 2
    leader = (rows != torch.roll(rows, -1, dims=-1)) | (idx == rows.shape[-1] - 1)
    return leader, vals, cnts


def _pow2(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def candidate_scores_sorted(term_ids, doc_rows, wnorm, offsets, idf, w: int, mode: str):
    """[B, Q] term ids -> row-sorted (rows [B, Q2*W2] i32, scores [B, Q2*W2] f32),
    Q2 and W2 the powers of two at or above Q and w; non-candidates score NEG_INF.
    mode "any" (OR), "all" (every query term matched) or "count" (matched count
    dominates: score + 4096 * count, the AND rescore's candidate ranking)."""
    if term_ids.dim() == 1:
        term_ids = term_ids[None, :]
    dev = doc_rows.device
    term_ids = term_ids.to(dev, torch.int64)
    b, q = term_ids.shape
    qp, wp = _pow2(q), _pow2(w)
    p_total = doc_rows.shape[0]

    valid_term = term_ids >= 0
    safe = term_ids.clamp(min=0)
    offs = offsets.long()
    off = offs[safe]
    length = offs[safe + 1] - off
    j = torch.arange(wp, device=dev)[None, None, :]
    valid = valid_term[..., None] & (j < length[..., None])
    # the JAX package reads one past a term's slice into padding; the port has none
    pos = (off[..., None] + torch.minimum(j, (length[..., None] - 1).clamp(min=0))).clamp(0, max(p_total - 1, 0))
    if p_total:
        rows = torch.where(valid, doc_rows[pos].to(torch.int32), _SENTINEL)
        contrib = torch.where(valid, idf[safe][..., None] * wnorm[pos], 0.0)
    else:
        rows = torch.full(pos.shape, _SENTINEL, dtype=torch.int32, device=dev)
        contrib = torch.zeros(pos.shape, dtype=torch.float32, device=dev)
    if qp > q:
        rows = torch.nn.functional.pad(rows, (0, 0, 0, qp - q), value=_SENTINEL)
        contrib = torch.nn.functional.pad(contrib, (0, 0, 0, qp - q))
    rows = rows.reshape(b, qp * wp)
    contrib = contrib.reshape(b, qp * wp)
    run = wp
    while run < qp * wp:
        # counts move with their key and are 1 exactly on real rows: derived below
        rows, (contrib,) = _merge(rows, [contrib], run)
        run *= 2
    cnts = (rows < _SENTINEL).to(torch.int32)
    leader, summed, counts = segment_sum_sorted(rows, contrib, cnts, 2 * qp)
    live = leader & (rows < _SENTINEL) & (summed > 0.0)
    if mode == "all":
        live = live & (counts >= valid_term.sum(dim=1, keepdim=True))
    score_out = summed
    if mode == "count":
        score_out = summed + 4096.0 * counts.float()
    return rows, torch.where(live, score_out, NEG_INF)


def wide_topk(scores, k: int, exact: bool = True):
    """Top-k over a wide candidate plane in two narrow passes, with the exact
    lowest-position tie-break (a drop-in for a stable top-k).

    Stage 1 takes each of 128 lanes' top-L over the [B, S, 128] slices; stage 2 orders
    the L*128 survivors by (score desc, plane position asc). exact=True uses
    L = min(S, k), which is exactly the stable top-k; exact=False uses
    L = ceil(k / 128) + 2, which can displace a few borderline candidates by lane
    collisions (only rescore fetches use it). Returns (vals, pos) like a top-k."""
    b, w = scores.shape
    if k > w:
        vals, pos = wide_topk(scores, w, exact=exact)
        return (torch.nn.functional.pad(vals, (0, k - w), value=NEG_INF),
                torch.nn.functional.pad(pos, (0, k - w)))
    if w <= max(1024, 8 * k) or w % 128:
        vals, pos = stable_top_k(scores, k)
        return vals, pos
    s = w // 128
    lvl = min(s, k if exact else -(-k // 128) + 2)
    t = scores.reshape(b, s, 128).transpose(1, 2)  # [B, 128, S]
    tv, ti = stable_top_k(t, lvl)  # per-lane top-L; ties keep the lowest slice
    gpos = ti * 128 + torch.arange(128, device=scores.device)[None, :, None]
    cv = tv.transpose(1, 2).reshape(b, lvl * 128)
    gp = gpos.transpose(1, 2).reshape(b, lvl * 128)
    # (score desc, position asc): order by position, then a stable sort by score
    o1 = torch.argsort(gp, dim=-1, stable=True)
    cv, gp = torch.gather(cv, 1, o1), torch.gather(gp, 1, o1)
    _, o2 = torch.sort(cv, dim=-1, descending=True, stable=True)
    o2 = o2[:, :k]
    return torch.gather(cv, 1, o2), torch.gather(gp, 1, o2)
