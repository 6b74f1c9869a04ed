"""Batched graph beam search over a `GraphIndex`: the HNSW query path.

PyTorch port of `wax_tpu.ops.beam_search`. The search is fixed-shape and batch
parallel over the padded adjacency matrix; each step, for every query:

  pick the best unexpanded beam node -> gather its neighbour rows -> score them
  (one [B, d] x [B, 3M, d] product) -> dedup against the beam by id -> keep the top ef.

The visited set is implicit: duplicates are removed by an id sort in which expanded
copies win, so nothing is expanded twice. The JAX function is one XLA program (a
`lax.scan` of `iters` steps) and reaches no Pallas kernel; here the steps are a Python
loop of plain torch operations on the graph's device.

The answers equal the JAX function's bit for bit wherever the products are exact, and
so on any device: every selection keeps `lax.top_k`'s and `jnp.argsort`'s stable
lowest-index order (`stable_top_k`, `torch.sort(stable=True)`, and `torch.argmax`,
which returns the first maximum), the beam and its neighbours are concatenated in
JAX's [beam | neighbours] order (a seed's score comes from the seed product and a
neighbour's from the row product, which can differ in the last bit, and the stable
order decides which copy the dedup keeps), and indices are clamped before every gather,
as `jnp.take` clamps. Both products run in full f32 on the card whatever the TF32
setting (`utils.device.full_f32_matmul`).
"""
from __future__ import annotations

import torch

from wax_tpu_torch.index.graph import GraphIndex
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.utils.device import full_f32_matmul

__all__ = ["hnsw_search"]


def _dedup_by_id(ids, scores, expanded):
    """Mask duplicate ids (the expanded copy is kept); -1 ids stay. Returns the three
    arrays in id order (key id*2 - expanded, stable)."""
    key = ids * 2 - expanded.to(torch.int32)
    order = torch.sort(key, dim=-1, stable=True).indices
    ids_s = torch.gather(ids, -1, order)
    scores_s = torch.gather(scores, -1, order)
    exp_s = torch.gather(expanded, -1, order)
    dup = torch.zeros_like(ids_s, dtype=torch.bool)
    dup[:, 1:] = ids_s[:, 1:] == ids_s[:, :-1]
    invalid = dup | (ids_s < 0)
    scores_s = torch.where(invalid, NEG_INF, scores_s)
    ids_s = torch.where(invalid, -1, ids_s)
    return ids_s, scores_s, exp_s


@full_f32_matmul
def _seed_scores(q: torch.Tensor, seed_emb: torch.Tensor, seed_bias: torch.Tensor) -> torch.Tensor:
    """[B, E] f32 products of the queries with every entry seed, plus the bias (JAX's
    dot_general with an f32 result)."""
    return q.float() @ seed_emb.float().t() + seed_bias[None, :]


@full_f32_matmul
def _row_products(q: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """[B, R] products of each query with its own rows `vecs` [B, R, d], in the rows'
    dtype (JAX's einsum "bd,brd->br"), as f32."""
    return torch.bmm(vecs, q[:, :, None])[:, :, 0].float()


def hnsw_search(queries: torch.Tensor, graph: GraphIndex, k: int = 10, ef: int = 64, iters: int | None = None):
    """Batched beam search.

    Args:
      queries: [B, dim] on the graph's device (normalised for cosine).
      graph: GraphIndex snapshot.
      k: final top-k (capped at ef).
      ef: beam width (efSearch; the reference sweeps 16-256).
      iters: expansion steps; defaults to ef (each step expands one node per query).

    Returns:
      (scores [B, min(k, ef)] f32, frame_ids [B, min(k, ef)] int32); dead slots hold
      NEG_INF and -1.
    """
    if iters is None:
        iters = ef
    b = queries.shape[0]
    dev = graph.emb.device
    q = queries.to(dev, graph.emb.dtype)
    entries = graph.entries.long()
    n_seed = min(entries.shape[0], ef)

    def score_rows(rows):  # rows [B, R] -> [B, R] similarity + bias
        safe = rows.clamp(min=0).long()
        s = _row_products(q, graph.emb[safe]) + graph.bias[safe]
        return torch.where(rows >= 0, s, NEG_INF)

    # seed the beam: score every entry seed densely and start from the best per query
    seed_scores = _seed_scores(q, graph.emb[entries], graph.bias[entries])
    top_seed, seed_pos = stable_top_k(seed_scores, n_seed)
    ids = torch.full((b, ef), -1, dtype=torch.int32, device=dev)
    scores = torch.full((b, ef), NEG_INF, dtype=torch.float32, device=dev)
    ids[:, :n_seed] = graph.entries[seed_pos]
    scores[:, :n_seed] = top_seed
    exp = torch.zeros((b, ef), dtype=torch.bool, device=dev)
    slots = torch.arange(ef, device=dev)[None, :]
    unexpanded = torch.zeros((b, graph.max_degree), dtype=torch.bool, device=dev)

    for _ in range(iters):
        # best unexpanded node per query (first maximum)
        cand = torch.where(exp | (ids < 0), NEG_INF, scores)
        best = torch.argmax(cand, dim=-1, keepdim=True)  # [B, 1]
        best_id = torch.gather(ids, -1, best)
        has_work = torch.gather(cand, -1, best) > NEG_INF * 0.5
        exp = exp | ((slots == best) & has_work)
        nbrs = graph.adjacency[best_id[:, 0].clamp(min=0).long()]  # [B, 3M]
        nbrs = torch.where(has_work & (best_id >= 0), nbrs, -1)
        nscores = score_rows(nbrs)
        all_ids, all_scores, all_exp = _dedup_by_id(torch.cat([ids, nbrs], dim=-1),
                                                    torch.cat([scores, nscores], dim=-1),
                                                    torch.cat([exp, unexpanded], dim=-1))
        scores, pos = stable_top_k(all_scores, ef)
        ids = torch.gather(all_ids, -1, pos)
        exp = torch.gather(all_exp, -1, pos)

    vals, pos = stable_top_k(scores, min(k, ef))
    rows = torch.gather(ids, -1, pos)
    fids = torch.where((vals > NEG_INF * 0.5) & (rows >= 0), graph.frame_ids[rows.clamp(min=0).long()], -1)
    fids = fids.to(torch.int32)
    vals = torch.where(fids >= 0, vals, NEG_INF)
    return vals, fids
