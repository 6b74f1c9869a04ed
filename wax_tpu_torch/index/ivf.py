"""IVF (inverted-file) vector index: k-means buckets built on the device, probed search.

PyTorch port of `wax_tpu.index.ivf`. The corpus is clustered by spherical k-means, each
cluster is stored as one contiguous fixed-size bucket, and a query is answered by two
products: against the centroids to pick `nprobe` buckets, then against the probed
buckets' rows for exact scores inside them (`ivf_search_topk` here, or kernel K7 through
`ops.ivf_kernel.ivf_search_topk_pallas`).

Differences from the JAX package, by design:
  * Random draws (k-means' initial rows, the training sample) come from a seeded CPU
    `torch.Generator`; `jax.random.choice` cannot be reproduced in torch. `lloyd` takes
    the initial centroids, so a caller can start from any rows it likes.
  * Centroid sums are blocked one-hot products, not a scatter-add: a scatter-add on the
    card adds with atomics in a varying order, and every build must repeat bit for bit.
  * Top-k selections keep `lax.top_k`'s lowest-index tie order (`ops.topk.stable_top_k`,
    or first-maximum rounds of `torch.argmax` where only a few are kept).
Assignment and probe products are f32 matrix products (TF32 off, torch's default).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.utils.device import full_f32_matmul, resolve_device

__all__ = ["IVFIndex", "build_ivf", "dedup_topk", "ivf_index_from_numpy", "ivf_search_topk", "kmeans", "lloyd"]


@dataclass(frozen=True)
class IVFIndex:
    """IVF snapshot on one device.

    centroids: [C, d] f32 cluster centres (L2-normalised for cosine).
    emb:       [C, S, d] bucketed vectors, f32 or bf16, bucket-contiguous.
    ids:       [C, S] int32 external frame ids, -1 padding.
    bias:      [C, S] f32 additive mask (0 live, NEG_INF padding).
    spilled:   True when boundary rows were copied into their 2nd-best bucket
               (build_ivf(spill=...)); search then fetches a 2k window and dedupes by
               frame id, since one row can reach the merge through two buckets.
    """

    centroids: torch.Tensor
    emb: torch.Tensor
    ids: torch.Tensor
    bias: torch.Tensor
    spilled: bool = False

    @property
    def n_clusters(self) -> int:
        return self.centroids.shape[0]

    @property
    def bucket_size(self) -> int:
        return self.emb.shape[1]

    @property
    def dim(self) -> int:
        return self.centroids.shape[1]

    @property
    def device(self) -> torch.device:
        return self.emb.device


def ivf_index_from_numpy(centroids, emb, ids, bias, spilled: bool, device: str | torch.device | None = None):
    """An `IVFIndex` on `device` (None: the current CUDA device) from numpy arrays of
    the same layout, e.g. a `wax_tpu` IVFIndex's fields as numpy (bf16 buckets
    included)."""
    device = resolve_device(device)

    def put(a):  # a copy: the arrays may be read-only views
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
        return torch.tensor(a, device=device)

    return IVFIndex(centroids=put(centroids).float(), emb=put(emb), ids=put(ids).to(torch.int32),
                    bias=put(bias).float(), spilled=bool(spilled))


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


_ASSIGN_BLOCK = 65536
_ASSIGN_SCORE_BYTES = 1 << 30  # cap the [block, C] f32 score temp at ~1 GiB


def _assign_rows(n_clusters: int) -> int:
    """Rows per block of the assignment (and of the centroid sums), so that a [block,
    C] f32 temp stays under ~1 GiB next to a multi-GB corpus and bucket tensor."""
    return max(8192, min(_ASSIGN_BLOCK, _ASSIGN_SCORE_BYTES // (4 * max(n_clusters, 1))))


@full_f32_matmul
def _assign_scores(vecs: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[rows, C] f32 row-centroid products (assignment, probe selection, placement),
    in f32 whatever the process's TF32 setting."""
    return vecs.float() @ centroids.t()


def _assign(vecs: torch.Tensor, centroids: torch.Tensor) -> torch.Tensor:
    """[N] int64 nearest centroid (first maximum) of each row, in row blocks."""
    rows = _assign_rows(centroids.shape[0])
    return torch.cat([torch.argmax(_assign_scores(vecs[s : s + rows], centroids), dim=1)
                      for s in range(0, vecs.shape[0], rows)])


def _top_clusters(vecs: torch.Tensor, centroids: torch.Tensor, k: int):
    """(scores, clusters) [rows, k] of each row's k best centroids, best first, ties to
    the lower cluster (lax.top_k's order): k rounds of a first-maximum argmax."""
    scores = _assign_scores(vecs, centroids)
    vals, idx = [], []
    for _ in range(k):
        i = torch.argmax(scores, dim=1, keepdim=True)
        vals.append(torch.gather(scores, 1, i))
        idx.append(i)
        scores.scatter_(1, i, -torch.inf)
    return torch.cat(vals, dim=1), torch.cat(idx, dim=1)


@full_f32_matmul
def _update_centroids(vecs: torch.Tensor, assign: torch.Tensor, n_clusters: int):
    """(normalised means [C, d] f32, counts [C] f32) of the rows of each cluster. The
    sums are one-hot products in fixed row blocks: no atomics, so they repeat bit for
    bit on the card."""
    cols = torch.arange(n_clusters, device=vecs.device)
    sums = torch.zeros((n_clusters, vecs.shape[1]), dtype=torch.float32, device=vecs.device)
    rows = _assign_rows(n_clusters)
    for s in range(0, vecs.shape[0], rows):
        onehot = (assign[s : s + rows, None] == cols[None, :]).float()
        sums += onehot.t() @ vecs[s : s + rows].float()
    counts = torch.bincount(assign, minlength=n_clusters).float()
    cent = sums / counts.clamp(min=1.0)[:, None]
    norms = torch.linalg.vector_norm(cent, dim=1, keepdim=True)
    return torch.where(norms > 0, cent / norms.clamp(min=1e-12), cent), counts


def lloyd(vecs: torch.Tensor, centroids: torch.Tensor, iters: int):
    """`iters` spherical Lloyd iterations from `centroids` [C, d]; a cluster left empty
    keeps its centre. Returns (centroids [C, d] f32, assignments [N] int64)."""
    centroids = centroids.float()
    for _ in range(iters):
        assign = _assign(vecs, centroids)
        new_cent, counts = _update_centroids(vecs, assign, centroids.shape[0])
        centroids = torch.where((counts > 0)[:, None], new_cent, centroids)
    return centroids, _assign(vecs, centroids)


def kmeans(vecs: torch.Tensor, n_clusters: int, iters: int = 8, seed: int = 0):
    """Spherical k-means on vecs' device from `n_clusters` rows drawn with a seeded
    CPU generator (with replacement only when there are fewer rows than clusters).
    Returns (centroids [C, d] f32, assignments [N] int64)."""
    n = vecs.shape[0]
    g = torch.Generator().manual_seed(seed)
    if n < n_clusters:
        init_rows = torch.randint(0, n, (n_clusters,), generator=g)
    else:
        init_rows = torch.randperm(n, generator=g)[:n_clusters]
    return lloyd(vecs, vecs[init_rows.to(vecs.device)], iters)


def build_ivf(
    vecs,
    frame_ids: np.ndarray,
    n_clusters: int | None = None,
    bucket_size: int | None = None,
    iters: int = 8,
    seed: int = 0,
    normalize: bool = True,
    bucket_dtype: torch.dtype | None = None,
    train_rows: int | str | None = "auto",
    spill: float | str = 0.0,
    device: str | torch.device | None = None,
) -> IVFIndex:
    """Cluster `vecs` [N, d] (numpy or a tensor) and pack them into fixed-size buckets
    on `device` (None: the current CUDA device); a row whose cluster is full goes to the
    first of its 8 best clusters with room.

    `spill` copies boundary rows (the smallest top-1 / top-2 centroid-score margin)
    into their 2nd-best cluster's free slots: a float caps the copies at spill * N,
    "auto" fills every free slot. `train_rows` bounds k-means' training set (a uniform
    sample; the final assignment covers every row): "auto" trains on max(2M, 128 rows
    a centroid), capped at N; None on the whole corpus. Only the [N] assignments (and
    the overflow rows' preferences) go to the host, which plans the slots."""
    device = resolve_device(device)
    vecs_dev = torch.as_tensor(vecs).to(device)
    n, d = vecs_dev.shape
    if normalize:
        v = vecs_dev.float()
        vecs_dev = v / torch.linalg.vector_norm(v, dim=1, keepdim=True).clamp(min=1e-12)
    frame_ids = np.asarray(frame_ids, np.int64)

    if n_clusters is None:
        n_clusters = max(1, min(n, int(2 * math.sqrt(max(n, 1)))))
    if bucket_size is None:
        # 128-aligned, the bucket stride K7's callers take
        bucket_size = _round_up(max(128, int(1.5 * n / n_clusters)), 128)
    while n_clusters * bucket_size < n:
        bucket_size = _round_up(bucket_size + max(128, bucket_size // 4), 128)

    if train_rows == "auto":
        train_rows = max(2_097_152, 128 * n_clusters)
    if train_rows is not None and train_rows < n:
        g = torch.Generator().manual_seed(seed ^ 0x5EED)
        sample = torch.randperm(n, generator=g)[:train_rows].to(device)
        centroids, _ = kmeans(vecs_dev[sample], n_clusters, iters, seed)
        assign = _assign(vecs_dev, centroids)
    else:
        centroids, assign = kmeans(vecs_dev, n_clusters, iters, seed)
    return _pack(vecs_dev, frame_ids, centroids, assign.cpu().numpy(), bucket_size, bucket_dtype, spill)


def _pack(vecs_dev, frame_ids, centroids, assign: np.ndarray, bucket_size: int, bucket_dtype, spill) -> IVFIndex:
    """Buckets from each row's assigned cluster (`assign`, on the host). A cluster's
    first `bucket_size` rows by index take its slots in order; the rest overflow to the
    first of their 8 preferred clusters with room (else the emptiest bucket). Then the
    spill copies, if any."""
    n, d = vecs_dev.shape
    n_clusters = centroids.shape[0]
    device = vecs_dev.device
    order = np.argsort(assign, kind="stable")
    sorted_assign = assign[order].astype(np.int64)
    counts = np.bincount(sorted_assign, minlength=n_clusters)
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank_in_group = np.arange(n, dtype=np.int64) - group_start[sorted_assign]
    fits = rank_in_group < bucket_size
    slot_cluster = np.full(n, -1, np.int64)
    slot_pos = np.full(n, -1, np.int64)
    slot_cluster[order[fits]] = sorted_assign[fits]
    slot_pos[order[fits]] = rank_in_group[fits]
    bucket_fill = np.minimum(counts, bucket_size)
    ov = order[~fits]
    if len(ov):
        rows_per, n_pref = _assign_rows(n_clusters), min(8, n_clusters)
        ov_dev = torch.from_numpy(ov).to(device)
        pref = torch.cat([_top_clusters(vecs_dev[ov_dev[s : s + rows_per]], centroids, n_pref)[1]
                          for s in range(0, len(ov), rows_per)]).cpu().numpy()
        for i, row in enumerate(ov.tolist()):
            for c in pref[i].tolist():
                if bucket_fill[c] < bucket_size:
                    break
            else:
                c = int(np.argmin(bucket_fill))
            slot_cluster[row] = c
            slot_pos[row] = bucket_fill[c]
            bucket_fill[c] += 1

    slot_index = slot_cluster * bucket_size + slot_pos  # [N] flat bucket slot of each row
    if bucket_dtype is not None:
        vecs_dev = vecs_dev.to(bucket_dtype)
    emb = torch.zeros((n_clusters * bucket_size, d), dtype=vecs_dev.dtype, device=device)
    emb[torch.from_numpy(slot_index).to(device)] = vecs_dev
    ids = np.full((n_clusters * bucket_size,), -1, np.int32)
    ids[slot_index] = frame_ids.astype(np.int32)

    spilled = False
    if spill and n_clusters > 1:
        spill_rows, spill_slots = _plan_spill(vecs_dev, centroids, slot_cluster, bucket_fill, bucket_size, spill)
        if len(spill_rows):
            ids[spill_slots] = frame_ids[spill_rows].astype(np.int32)
            spilled = True
            for s in range(0, len(spill_rows), _SPILL_CHUNK):  # bounded row-gather temps
                r = torch.from_numpy(spill_rows[s : s + _SPILL_CHUNK]).to(device)
                emb[torch.from_numpy(spill_slots[s : s + _SPILL_CHUNK]).to(device)] = vecs_dev[r]

    ids = ids.reshape(n_clusters, bucket_size)
    return IVFIndex(
        centroids=centroids,
        emb=emb.view(n_clusters, bucket_size, d),
        ids=torch.from_numpy(ids).to(device),
        bias=torch.from_numpy(np.where(ids >= 0, 0.0, NEG_INF).astype(np.float32)).to(device),
        spilled=spilled,
    )


_SPILL_CHUNK = 262_144


def _plan_spill(vecs_dev, centroids, placed_cluster, bucket_fill, bucket_size: int, spill):
    """Boundary rows and target slots for 2nd-best-cluster copies.

    The device gives each row its 2nd-best cluster and top-1 / top-2 margin, in blocks;
    the host keeps the `budget` smallest margins among rows whose placed bucket is not
    their 2nd-best cluster, then fills each target cluster's free slots in ascending
    margin order. Returns (rows, flat slots) as int64 arrays."""
    n = vecs_dev.shape[0]
    n_clusters = centroids.shape[0]
    rows_per = _assign_rows(n_clusters)
    sec = np.empty(n, np.int64)
    margin = np.empty(n, np.float32)
    for s in range(0, n, rows_per):
        v2, i2 = _top_clusters(vecs_dev[s : s + rows_per], centroids, 2)
        e = s + v2.shape[0]
        sec[s:e] = i2[:, 1].cpu().numpy()
        margin[s:e] = (v2[:, 0] - v2[:, 1]).cpu().numpy()

    budget = n if spill == "auto" else int(float(spill) * n)
    if budget <= 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    eligible = np.nonzero(sec != placed_cluster)[0]
    cand = eligible[np.argsort(margin[eligible], kind="stable")[:budget]]
    cand = cand[np.lexsort((margin[cand], sec[cand]))]
    tgt = sec[cand]
    counts = np.bincount(tgt, minlength=n_clusters)
    group_start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(cand), dtype=np.int64) - group_start[tgt]
    free = (bucket_size - bucket_fill).astype(np.int64)
    take = rank < free[tgt]
    rows = cand[take]
    slots = tgt[take] * bucket_size + bucket_fill[tgt[take]] + rank[take]
    return rows.astype(np.int64), slots.astype(np.int64)


def _lexsort_last(minor: torch.Tensor, major: torch.Tensor) -> torch.Tensor:
    """Indices that sort each row by (major, minor) ascending, ties in index order:
    jnp.lexsort((minor, major), axis=-1) as two stable sorts, the minor key first."""
    o1 = torch.argsort(minor, dim=-1, stable=True)
    o2 = torch.argsort(torch.gather(major, -1, o1), dim=-1, stable=True)
    return torch.gather(o1, -1, o2)


def dedup_topk(vals: torch.Tensor, fids: torch.Tensor, k: int):
    """Collapse duplicate frame ids in a candidate window, keeping each one's best
    score, and return the top k by (score desc, frame id asc), -1 / NEG_INF last.

    Needed for spilled indexes: a copied row can reach the merge through two probed
    buckets."""
    order = _lexsort_last(-vals, fids)
    fid_s = torch.gather(fids, -1, order)
    val_s = torch.gather(vals, -1, order)
    dup = torch.cat([torch.zeros_like(fid_s[:, :1], dtype=torch.bool),
                     (fid_s[:, 1:] == fid_s[:, :-1]) & (fid_s[:, 1:] >= 0)], dim=1)
    val_s = torch.where(dup, NEG_INF, val_s)
    fid_s = torch.where(dup, -1, fid_s)
    tie = torch.where(fid_s >= 0, fid_s, 2**31 - 1)
    final = _lexsort_last(tie, -val_s)[:, :k]
    return torch.gather(val_s, -1, final), torch.gather(fid_s, -1, final)


def _pad_k(vals: torch.Tensor, fids: torch.Tensor, k: int):
    """(vals, fids) padded with NEG_INF / -1 to k columns."""
    pad = k - vals.shape[1]
    if pad > 0:
        vals = torch.nn.functional.pad(vals, (0, pad), value=NEG_INF)
        fids = torch.nn.functional.pad(fids, (0, pad), value=-1)
    return vals, fids


@full_f32_matmul
def ivf_search_topk(queries: torch.Tensor, index: IVFIndex, k: int = 10, nprobe: int = 8):
    """Probe each query's `nprobe` best buckets and score exactly inside them, one
    probe rank at a time (one [B, S, d] gather, its top-k, a merge into the running
    top-k), so memory stays bounded at any nprobe.

    On a spilled index the merge carries a 2k window and duplicates are collapsed at
    the end. Returns (scores [B, k] f32, frame ids [B, k] int32), -1 padded."""
    b = queries.shape[0]
    nprobe = min(nprobe, index.n_clusters)
    s_bucket = index.bucket_size
    q = queries.float()
    _, probes = stable_top_k(_assign_scores(q, index.centroids), nprobe)  # [B, P]
    kk = min(2 * k if index.spilled else k, s_bucket * nprobe)
    best_v = torch.full((b, kk), NEG_INF, dtype=torch.float32, device=q.device)
    best_f = torch.full((b, kk), -1, dtype=torch.int32, device=q.device)
    for p in range(nprobe):
        col = probes[:, p]
        scores = torch.bmm(index.emb[col].float(), q[:, :, None])[..., 0] + index.bias[col]
        v, pos = stable_top_k(scores, min(kk, s_bucket))
        f = torch.gather(index.ids[col], 1, pos)
        best_v, mpos = stable_top_k(torch.cat([best_v, v], dim=1), kk)
        best_f = torch.gather(torch.cat([best_f, f], dim=1), 1, mpos)
    fids = torch.where(best_v > NEG_INF * 0.5, best_f, -1)
    if index.spilled:
        vals, fids = dedup_topk(best_v, fids, min(k, kk))
    else:
        vals, fids = best_v[:, :k], fids[:, :k]
    vals, fids = _pad_k(vals, fids, k)
    return vals, fids.to(torch.int32)
