"""Corpus-sharded hybrid retrieval: dense lane + BM25 lane + RRF in one device program.

PyTorch port of `wax_tpu.parallel.sharded_hybrid`. The corpus (embedding matrix and
CSR postings) is split into contiguous row ranges, one per corpus shard of the mesh,
each on its shard's device; a query batch (dense vectors and padded term ids) runs both
lanes on every shard, issued from one loop with no host synchronisation, the per-shard
top-k lists merge across the mesh on the lead device (`parallel/merge.py`), and
weighted reciprocal-rank fusion of the two rankings runs there. Determinism is the JAX
package's: stable top-k merges, and (score desc, lane order, candidate position)
tie-breaks, so a two-level mesh answers as the flat mesh bit for bit.

Lanes and the kernels they run on CUDA tensors, chosen per shard from its local rows
as JAX chooses (but for shards of 2^23 rows and more, below):

  * dense: chunkmax (K6 + K7) where `chunkmax_scan.takes_chunkmax` allows it for the
    local rows and the fetch, the packed-key select kernel (K1,
    `flat_scan.packed_sel_scan_topk`) at `_SELKERNEL_MIN_LOCAL_ROWS` or more, else exact
    blockmax in plain torch (`flat_scan.blockmax_scan_topk`);
  * BM25: `ops/bm25_lane.bm25_candidates` on the shard's one-device view
    (`ShardedLexIndex.shard`), then the exact forward-index rescore (K3) when the
    postings budget truncated a term. The backend "candidates_pallas" generates with
    the kernels (K4, or K8 on a shard without impact chunks), "candidates" with the
    plain merge harness; "auto" takes the kernels on a card where
    `bm25_candidates_pallas.kernels_take` allows them. A shard of 2^23 rows or more gets
    no impact chunks (`index/lex.PK_MIN_QB`: K4's packed ranking loses recall there),
    so its kernel lane generates with K8 in its selection mode; the JAX package builds
    chunks at every size.

The sharded lexical index is built with torch ops on the device its postings live on
(`shard_lex_postings`, on `index/lex.lex_arrays`, as the one-device snapshot is);
`shard_lex_index` hands it a host builder's postings.

Left out: the per-term reversed postings copies and DMA-window padding the TPU
kernels read, and the scatter lane (its only trigger, a snapshot without precomputed
weights, does not occur in the port).
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from wax_tpu_torch.index.lex import LexIndex, LexIndexBuilder, lex_arrays
from wax_tpu_torch.ops.bm25_candidates_pallas import kernels_take
from wax_tpu_torch.ops.bm25_lane import bm25_candidates, lane_frame_ids
from wax_tpu_torch.ops.bm25_rescore import rescore_topk
from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk, takes_chunkmax
from wax_tpu_torch.ops.flat_scan import blockmax_scan_topk, packed_sel_scan_topk
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards, on_device, replicate
from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex
from wax_tpu_torch.utils.profiling import count, device_span

__all__ = ["ShardedLexIndex", "shard_lex_index", "shard_lex_postings", "sharded_hybrid_topk", "sharded_bm25_topk"]

# local-shard row count from which the dense lane switches from exact blockmax to the
# packed select kernel (flat_scan's `auto` regime above 64K rows; tests lower it to
# run every branch on small CPU corpora)
_SELKERNEL_MIN_LOCAL_ROWS = 65_536


@dataclasses.dataclass(frozen=True)
class ShardedLexIndex:
    """Row-sharded CSR postings; `field[s]` is shard s's array, `shard(s)` the shard as
    a one-device snapshot.

    Each field is a tuple of the shards' arrays on their devices, padded to common
    shapes (shown per shard below). `row_base` maps local rows to the global row space
    shared with the dense index. The forward index and the impact chunks are present
    only when the postings budget truncated a term, the chunks only below 2^23 rows a
    shard (`index/lex.PK_MIN_QB`).
    """

    doc_rows: tuple  # [P_max] i32 local rows
    tfs: tuple  # [P_max] f32
    offsets: tuple  # [T+1] i32
    idf: tuple  # [T] f32 (global idf on every shard)
    doc_len: tuple  # [N_local] f32
    frame_ids: tuple  # [N_local] i32
    live: tuple  # [N_local] bool
    row_base: tuple  # 0-d i32
    count: tuple  # 0-d i32 rows that hold a snapshot row
    avgdl: torch.Tensor  # 0-d f32 on the lead device
    wnorm: tuple  # [P_max] f32 tf-normalised weights (0 dead)
    fwd_tids: tuple | None = None  # [N_local, L] i32
    fwd_wnorm: tuple | None = None  # [N_local, L] f32
    fwd_fused: tuple | None = None  # [N_local, 2*L2] i32
    pk_chunks: tuple | None = None  # [PB*1024] i32
    chunk_base: tuple | None = None  # [T] i32
    chunk_counts: tuple | None = None  # [T] i32
    max_df: int = 0
    pk_qb: int = 0
    pk_max_chunks: int = 0
    fwd_width: int = 0

    @property
    def n_local(self) -> int:
        """Rows per shard."""
        return self.doc_len[0].shape[0]

    def shard(self, s: int) -> LexIndex:
        """Shard s as a one-device snapshot: its arrays (`active` from `live`) and the
        mean length on its device. Built once per index."""
        return self._shards[s]

    @functools.cached_property
    def _shards(self) -> tuple:
        fields = {f.name: getattr(self, "live" if f.name == "active" else f.name) for f in dataclasses.fields(LexIndex)}
        return tuple(LexIndex(**{n: v[s] if isinstance(v, tuple) else v for n, v in fields.items()}
                              | {"avgdl": self.avgdl.to(self.doc_len[s].device)}) for s in range(len(self.doc_len)))


def shard_lex_index(builder: LexIndexBuilder, mesh: Mesh, n_rows_global: int) -> ShardedLexIndex:
    """Split a lexical builder's postings into per-shard CSR arrays over contiguous
    row ranges (global rows 0..n_rows_global-1 map to the same frames as the dense
    index), each shard's on its device: `shard_lex_postings` on the builder's CSR
    (CPU tensors), its postings budget and its mean length."""
    post_offsets, doc_rows, tfs = (torch.from_numpy(np.array(a)) for a in builder.csr())
    doc_len, frame_ids, active = (torch.from_numpy(a) for a in builder.row_arrays())
    return shard_lex_postings(mesh, n_rows_global, post_offsets, doc_rows, tfs, doc_len, frame_ids, active,
                              postings_budget=builder.resolve_postings_budget(len(doc_len)), avgdl=builder.avgdl())


def shard_lex_postings(mesh: Mesh, n_rows_global: int, post_offsets, doc_rows, tfs, doc_len, frame_ids, active,
                       postings_budget: int | None = None, avgdl: float | None = None) -> ShardedLexIndex:
    """The sharded lexical index of a global CSR snapshot's postings, built with torch
    ops on the postings' device (`index/lex.lex_arrays`, which documents the
    arguments) and then moved to each shard's device. On CPU tensors the arrays equal
    `LexIndexBuilder.snapshot`'s sharded, bit for bit."""
    a = lex_arrays(corpus_shards(mesh), n_rows_global, post_offsets, doc_rows, tfs, doc_len, frame_ids, active,
                   postings_budget=postings_budget, avgdl=avgdl)
    per = a["doc_len"].shape[1]
    n = min(doc_len.shape[0], n_rows_global)

    def put(name):  # [S, ...] -> each shard's entry on its device
        x = a.pop(name)
        return None if x is None else tuple(x[si].to(d) for si, d in enumerate(mesh.shard_devices))

    fields = ("doc_rows", "tfs", "offsets", "idf", "doc_len", "frame_ids", "live", "wnorm", "fwd_tids", "fwd_wnorm",
              "fwd_fused", "pk_chunks", "chunk_base", "chunk_counts")
    return ShardedLexIndex(
        **{f: put(f) for f in fields},
        row_base=tuple(torch.tensor(si * per, dtype=torch.int32, device=d) for si, d in enumerate(mesh.shard_devices)),
        count=tuple(torch.tensor(min(max(n - si * per, 0), per), dtype=torch.int32, device=d)
                    for si, d in enumerate(mesh.shard_devices)),
        avgdl=torch.tensor(a["avgdl"], dtype=torch.float32, device=mesh.device),
        max_df=a["max_df"], pk_qb=a["pk_qb"], pk_max_chunks=a["pk_max_chunks"], fwd_width=a["fwd_width"],
    )


def _resolve_lex_backend(lex: ShardedLexIndex, backend: str, q2: int = 16) -> str:
    """The BM25 lane's implementation. "auto" decides on the device the postings
    live on: the CPU takes the plain merge harness ("candidates"), CUDA the kernels
    ("candidates_pallas") where `kernels_take` allows them for `q2` term slots."""
    if backend == "auto":
        on_card = lex.doc_rows[0].device.type == "cuda"
        backend = "candidates_pallas" if on_card and kernels_take(lex.shard(0), q2) else "candidates"
    if backend not in ("candidates", "candidates_pallas"):
        raise ValueError(f"unknown BM25 backend {backend!r} (the port has 'candidates' and "
                         "'candidates_pallas')")
    return backend


def _bm25_lane(tids, lex: ShardedLexIndex, s: int, kk: int, mode: str, backend: str):
    """The BM25 lane on shard s: (vals [B, kk], frame ids [B, kk])."""
    index = lex.shard(s)
    vals, rows = bm25_candidates(tids, index, kk, mode, backend == "candidates_pallas")
    if index.fwd_tids is not None:
        with device_span("bm25.rescore", index.device):
            vals, rows = rescore_topk(tids, rows, index.fwd_tids, index.fwd_wnorm, index.idf, kk, mode,
                                      fwd_width=index.fwd_width, fwd_fused=index.fwd_fused)
    return vals, lane_frame_ids(index, vals, rows)


def _term_batches(term_ids, mesh: Mesh) -> tuple:
    """The padded term ids [B, Q] (a [Q] row becomes [1, Q]) as int32 on each shard's
    device."""
    tids = torch.as_tensor(term_ids).to(torch.int32)
    return replicate(mesh, tids[None, :] if tids.dim() == 1 else tids)


def _bm25_shards(tids, lex: ShardedLexIndex, kk: int, mode: str, backend: str, mesh: Mesh):
    """Every shard's BM25 lane, issued in shard order on the shards' devices."""
    vals, fids = [], []
    for s, dev in enumerate(mesh.shard_devices):
        with on_device(dev), device_span("sharded_hybrid.bm25", dev):
            v, f = _bm25_lane(tids[s], lex, s, kk, mode, backend)
        vals.append(v)
        fids.append(f)
    return vals, fids


def sharded_bm25_topk(term_ids, lex: ShardedLexIndex, k: int, mesh: Mesh, mode: str = "any",
                      backend: str = "auto"):
    """Sharded BM25 top-k: per-shard scoring, then the merge across the mesh.

    mode: "any" (OR) or "all" (implicit AND, FTS5 parity). backend: "auto" |
    "candidates" | "candidates_pallas" (see `_resolve_lex_backend`). Returns
    (scores [B, k] f32, frame_ids [B, k] i32) on the mesh's lead device."""
    backend = _resolve_lex_backend(lex, backend, q2=int(term_ids.shape[-1]))
    kk = min(int(k), lex.n_local)
    vals, fids = _bm25_shards(_term_batches(term_ids, mesh), lex, kk, mode, backend, mesh)
    return merge_topk_across_mesh(vals, fids, int(k), mesh)


def _rrf_on_device(dfid, lfid, k: int, fetch: int, w_dense: float, w_bm25: float, rrf_k: float):
    """Weighted RRF over the two global rankings (rank = position + 1): the frame-id
    lists are concatenated, sorted by id, each duplicate (one per lane at most) folds
    into its left neighbour, and a stable top-k ranks the fused scores."""
    ranks = torch.arange(1, fetch + 1, dtype=torch.float32, device=dfid.device)[None, :]
    inc_d = torch.where(dfid >= 0, w_dense / (rrf_k + ranks), 0.0)
    inc_l = torch.where(lfid >= 0, w_bm25 / (rrf_k + ranks), 0.0)
    all_fid = torch.cat([dfid, lfid], dim=1)
    all_inc = torch.cat([inc_d, inc_l], dim=1)
    order = torch.argsort(all_fid, dim=1, stable=True)
    fid_s = torch.gather(all_fid, 1, order)
    inc_s = torch.gather(all_inc, 1, order)
    no = torch.zeros_like(fid_s[:, :1], dtype=torch.bool)
    same = torch.cat([no, fid_s[:, 1:] == fid_s[:, :-1]], dim=1)
    nxt_same = torch.cat([same[:, 1:], no], dim=1)
    nxt_inc = torch.cat([inc_s[:, 1:], torch.zeros_like(inc_s[:, :1])], dim=1)
    folded = inc_s + torch.where(nxt_same, nxt_inc, 0.0)
    score = torch.where(same | (fid_s < 0), NEG_INF, folded)
    fv, pos = stable_top_k(score, k)
    ffid = torch.gather(fid_s, 1, pos)
    return fv, torch.where(fv > NEG_INF * 0.5, ffid, -1)


def sharded_hybrid_topk(queries, term_ids, dense: ShardedDenseIndex, lex: ShardedLexIndex, k: int,
                        mesh: Mesh, w_dense: float = 0.5, w_bm25: float = 0.5, rrf_k: float = 60.0,
                        lex_backend: str = "auto"):
    """One-program hybrid search: both lanes on every shard, the merges across the mesh
    and RRF on the lead device. queries [B, d] (normalised by the caller), term_ids
    [B, Q] padded distinct ids. Returns (fused_scores [B, k] f32, frame_ids [B, k] i32)
    on the lead device.

    Spans (`utils/profiling.device_span`): `sharded_hybrid.call` (the body, lead
    device); per shard `sharded_hybrid.dense` (the dense lane and its id gather) and
    `sharded_hybrid.bm25` (the BM25 lane: `bm25.candidates`, then `bm25.rescore` on a
    truncated snapshot); `sharded_hybrid.rrf` (lead device). The counter
    `sharded_hybrid.lex_route.<backend>` adds one a call for the BM25 lane's resolved
    backend."""
    with device_span("sharded_hybrid.call", mesh.device):
        lex_backend = _resolve_lex_backend(lex, lex_backend, q2=int(term_ids.shape[-1]))
        count(f"sharded_hybrid.lex_route.{lex_backend}")
        fetch = max(2 * int(k), 16)
        local_rows = dense.local_rows
        # the dense lane's body for every shard's rows: (vals [B, kk], local rows [B, kk])
        if takes_chunkmax(local_rows, min(fetch, local_rows), dense.contiguous):
            dense_lane = chunkmax_scan_topk
        elif _SELKERNEL_MIN_LOCAL_ROWS <= local_rows and min(fetch, local_rows) <= 100:
            dense_lane = packed_sel_scan_topk
        else:
            dense_lane = blockmax_scan_topk
        qs = replicate(mesh, torch.as_tensor(queries, dtype=torch.float32))
        tids = _term_batches(term_ids, mesh)

        dvals, dfids = [], []
        for s, dev in enumerate(mesh.shard_devices):
            emb, d_fids, d_bias = dense.shard(s)
            with on_device(dev), device_span("sharded_hybrid.dense", dev):
                dv, drows = dense_lane(qs[s], emb, d_bias, min(fetch, local_rows))
                dvals.append(dv)
                dfids.append(torch.where(dv > NEG_INF * 0.5, d_fids[drows.clamp(min=0).long()], -1).to(torch.int32))
        lvals, lfids = _bm25_shards(tids, lex, min(fetch, lex.n_local), "any", lex_backend, mesh)
        _, dfid_g = merge_topk_across_mesh(dvals, dfids, fetch, mesh)
        _, lfid_g = merge_topk_across_mesh(lvals, lfids, fetch, mesh)
        with device_span("sharded_hybrid.rrf", mesh.device):
            return _rrf_on_device(dfid_g, lfid_g, int(k), fetch, float(w_dense), float(w_bm25), float(rrf_k))
