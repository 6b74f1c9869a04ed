"""Plain reference of exact dense top-k over bf16 rows, and the comparison of top-k
lists that every cell's check uses.

Scores are the dot products of the bf16-valued queries and rows, worked out in f64
(each product is exact there, and the sums all but exact), in blocks of rows on the
rows' device. With `precision="bf16"` the same scores come from a bf16 product with
bf16 output: the control, one precision below the f32 accumulation the
configurations state.
"""
from __future__ import annotations

import math

import numpy as np
import torch

DEAD = -1e30  # a score below this is an empty slot (the program pads with -3e38)
BLOCK_ROWS = 1 << 18


def _scores(q: torch.Tensor, rows: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f64":
        return q.double() @ rows.double().t()
    if precision == "bf16":
        return (q.to(torch.bfloat16) @ rows.to(torch.bfloat16).t()).double()
    raise ValueError(f"unknown precision {precision!r}")


def dense_topk(q: torch.Tensor, rows: torch.Tensor, k: int, first_id: int = 0, precision: str = "f64"):
    """Top-k of q [B, d] against rows [N, d] (ids first_id + row): (scores [B, k] f64,
    ids [B, k] int64), numpy, best first."""
    q = q.to(rows.device)
    best_v = best_i = None
    for lo in range(0, rows.shape[0], BLOCK_ROWS):
        s = _scores(q, rows[lo:lo + BLOCK_ROWS], precision)
        v, i = torch.topk(s, min(k, s.shape[1]), dim=1)
        i = i + lo
        if best_v is not None:
            v, pos = torch.topk(torch.cat([best_v, v], 1), k, dim=1)
            i = torch.gather(torch.cat([best_i, i], 1), 1, pos)
        best_v, best_i = v, i
    return best_v.cpu().numpy(), best_i.cpu().numpy() + first_id


def chunk_topk(q: torch.Tensor, rows: torch.Tensor, kc: int, chunk: int = 128) -> np.ndarray:
    """The kc chunks of `chunk` rows with the best f64 maxima for each query: [B, kc]."""
    q = q.to(rows.device)
    maxima = torch.cat([(q.double() @ rows[lo:lo + BLOCK_ROWS].double().t()).reshape(q.shape[0], -1, chunk).amax(2)
                        for lo in range(0, rows.shape[0], BLOCK_ROWS)], dim=1)
    return torch.topk(maxima, kc, dim=1).indices.cpu().numpy()


def dense_score_of(q: torch.Tensor, rows: torch.Tensor, ids: np.ndarray, first_id: int = 0) -> np.ndarray:
    """f64 scores of q [B, d] against the rows of `ids` [B, k] (-1: NaN)."""
    ids_t = torch.as_tensor(ids, device=rows.device).long() - first_id
    ok = (ids_t >= 0) & (ids_t < rows.shape[0])
    g = rows[ids_t.clamp(0, rows.shape[0] - 1)].double()  # [B, k, d]
    s = torch.einsum("bkd,bd->bk", g, q.to(rows.device).double())
    return torch.where(ok, s, torch.nan).cpu().numpy()


def topk_err(p_vals: np.ndarray, p_ids: np.ndarray, r_vals: np.ndarray, r_of_p: np.ndarray) -> float:
    """How far a program's top-k lists [B, k] lie from the reference's: the largest of
    |program score - reference's score at the same place| and |program score -
    reference's score of the id the program returned|. Swaps of tied or near-tied ids
    read as their score gap, a missing or wrong member as its score gap or more. An
    empty slot where the reference has an entry, an id the reference cannot score, or
    an id listed twice reads inf."""
    p_vals, p_ids = np.asarray(p_vals, np.float64), np.asarray(p_ids)
    p_live, r_live = p_vals > DEAD, np.asarray(r_vals) > DEAD
    if not np.array_equal(p_live, r_live) or np.any(p_live & (p_ids < 0)):
        return math.inf
    for row, live in zip(p_ids, p_live):
        if len(set(row[live].tolist())) != int(live.sum()):
            return math.inf
    if not p_live.any():
        return 0.0
    e_place = np.abs(p_vals - r_vals)[p_live]
    e_id = np.abs(p_vals - r_of_p)[p_live]
    if not np.all(np.isfinite(e_id)):
        return math.inf
    return float(max(e_place.max(), e_id.max()))
