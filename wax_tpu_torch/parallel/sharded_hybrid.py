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
as JAX chooses:

  * dense: chunkmax (K6 + K7) at `_CHUNKMAX_MIN_LOCAL_ROWS` rows or more on a
    contiguous shard, the packed-key select kernel (K1) at `_SELKERNEL_MIN_LOCAL_ROWS`
    or more, else exact blockmax in plain torch;
  * BM25: candidate generation, then the exact forward-index rescore (K3) when the
    postings budget truncated a term. With the backend "candidates_pallas" the
    generator is the chunked kernel (K4) when the snapshot carries impact chunks, else
    the unchunked candidate kernel (K8: its whole plane on an exact store, its
    in-kernel top 3 per slot position before a rescore); with "candidates", the
    plain-torch merge harness.

Left out: the per-term reversed postings copies and DMA-window padding the TPU
kernels read, and the scatter lane (its only trigger, a snapshot without precomputed
weights, does not occur in the port).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from wax_tpu_torch.index.lex import BM25_B, BM25_K1, LexIndexBuilder, build_impact_chunks, fuse_forward
from wax_tpu_torch.ops.bm25_candidates import candidate_scores_sorted, wide_topk
from wax_tpu_torch.ops.bm25_candidates_pallas import candidate_scores_pallas, dma_window
from wax_tpu_torch.ops.bm25_chunked_pallas import _SEL_LEVELS, chunked_candidates_sel
from wax_tpu_torch.ops.bm25_rescore import rescore_topk
from wax_tpu_torch.ops.flat_scan import _scores_f32
from wax_tpu_torch.ops.topk import NEG_INF, blockmax_topk, stable_top_k
from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards, on_device, replicate
from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex

__all__ = ["ShardedLexIndex", "shard_lex_index", "shard_lex_arrays", "sharded_hybrid_topk", "sharded_bm25_topk"]

# local-shard row count from which the dense lane switches from blockmax to chunkmax
# (tests lower these to run every branch on small CPU corpora)
_CHUNKMAX_MIN_LOCAL_ROWS = 524_288
# local-shard row count from which the dense lane switches from exact blockmax to the
# packed select kernel (flat_scan's `auto` regime above 64K rows)
_SELKERNEL_MIN_LOCAL_ROWS = 65_536
# the TPU candidate kernel's plane guard, kept so "auto" resolves as it does there
_PALLAS_MAX_PLANE_ELEMS = 512 * 1024


@dataclass(frozen=True)
class ShardedLexIndex:
    """Row-sharded CSR postings; `field[s]` is shard s's array.

    Each field is a tuple of the shards' arrays on their devices, padded to common
    shapes (shown per shard below). `row_base` maps local rows to the global row space
    shared with the dense index. The forward index and the impact chunks are present
    only when the postings budget truncated a term.
    """

    doc_rows: tuple  # [P_max] i32 local rows
    tfs: tuple  # [P_max] f32
    offsets: tuple  # [T+1] i32
    idf: tuple  # [T] f32 (global idf on every shard)
    doc_len: tuple  # [N_local] f32
    frame_ids: tuple  # [N_local] i32
    live: tuple  # [N_local] bool
    row_base: tuple  # 0-d i32
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


def shard_lex_index(builder: LexIndexBuilder, mesh: Mesh, n_rows_global: int) -> ShardedLexIndex:
    """Split a lexical builder's snapshot into per-shard CSR arrays over contiguous
    row ranges (global rows 0..n_rows_global-1 map to the same frames as the dense
    index), each shard's on its device."""
    full = builder.snapshot(device="cpu")
    fwd = full.fwd_tids is not None
    return shard_lex_arrays(
        mesh, n_rows_global, full.doc_rows.numpy(), full.tfs.numpy(), full.offsets.numpy(), full.idf.numpy(),
        full.doc_len.numpy(), full.frame_ids.numpy(), full.active.numpy(), int(full.count), float(full.avgdl),
        fwd_tids=full.fwd_tids.numpy() if fwd else None, fwd_wnorm=full.fwd_wnorm.numpy() if fwd else None,
        fwd_width=full.fwd_width)


def shard_lex_arrays(mesh: Mesh, n_rows_global: int, doc_rows, tfs, offsets, idf, doc_len_g, frame_ids_g, active_g,
                     count: int, avgdl_f: float, fwd_tids=None, fwd_wnorm=None, fwd_width: int = 0) -> ShardedLexIndex:
    """`shard_lex_index` on a global CSR snapshot given as numpy arrays (postings
    `doc_rows`/`tfs` in term order under `offsets`, per-row `doc_len_g`, `frame_ids_g`
    and `active_g`, and the forward index when a postings budget truncated a term)."""
    s = corpus_shards(mesh)
    per = -(-n_rows_global // s)
    offsets = np.asarray(offsets).astype(np.int64)
    t = len(offsets) - 1
    p_total = int(offsets[-1])
    tid_post = np.repeat(np.arange(t, dtype=np.int64), np.diff(offsets))

    shards, max_p, max_df = [], 1, 1
    for si in range(s):
        lo, hi = si * per, min((si + 1) * per, n_rows_global)
        keep = (doc_rows[:p_total] >= lo) & (doc_rows[:p_total] < hi)  # CSR order kept
        sizes = np.bincount(tid_post[keep], minlength=t)
        offs = np.zeros(t + 1, np.int64)
        offs[1:] = np.cumsum(sizes)
        rows_l = (doc_rows[:p_total][keep] - lo).astype(np.int32)
        shards.append((rows_l, tfs[:p_total][keep], offs))
        max_p = max(max_p, len(rows_l))
        max_df = max(max_df, int(sizes.max()) if t else 0)

    dr = np.zeros((s, max_p), np.int32)
    tf = np.zeros((s, max_p), np.float32)
    wn = np.zeros((s, max_p), np.float32)
    off = np.zeros((s, t + 1), np.int32)
    dl = np.zeros((s, per), np.float32)
    fid = np.full((s, per), -1, np.int32)
    live = np.zeros((s, per), bool)
    base = np.zeros(s, np.int32)
    for si, (rows_l, tfs_l, offs) in enumerate(shards):
        lo, hi = si * per, min((si + 1) * per, n_rows_global)
        dr[si, : len(rows_l)] = rows_l
        tf[si, : len(tfs_l)] = tfs_l
        off[si] = offs
        src_hi = min(hi, len(doc_len_g))
        if src_hi > lo:
            dl[si, : src_hi - lo] = doc_len_g[lo:src_hi]
            fid[si, : src_hi - lo] = frame_ids_g[lo:src_hi]
            live[si, : src_hi - lo] = active_g[lo:src_hi] & (np.arange(lo, src_hi) < count)
        base[si] = lo
        if len(rows_l):
            # the JAX package's expression, so both give identical weights
            pdl = dl[si, rows_l]
            denom = tfs_l + BM25_K1 * (1.0 - BM25_B + BM25_B * pdl / max(avgdl_f, 1e-9))
            wn[si, : len(rows_l)] = np.where(
                live[si, rows_l], tfs_l * (BM25_K1 + 1.0) / np.maximum(denom, 1e-9), 0.0
            ).astype(np.float32)

    truncated = fwd_tids is not None
    pk_a = cbase_a = ccnt_a = ftids = fwn = fz = None
    pk_qb = pk_maxc = 0
    fwd_width = int(fwd_width) if truncated else 0
    if truncated:
        per_pk = []
        cb_l, cc_l = [], []
        for si, (_, _, offs) in enumerate(shards):
            pk_i, cb_i, cc_i, pk_qb = build_impact_chunks(dr[si], wn[si], offs, idf.astype(np.float64), per)
            per_pk.append(pk_i)
            cb_l.append(cb_i)
            cc_l.append(cc_i)
            pk_maxc = max(pk_maxc, int(cc_i.max()) if len(cc_i) else 0)
        pk_a = np.full((s, max(len(p) for p in per_pk)), np.int32(2**31 - 1), np.int32)
        for si, p in enumerate(per_pk):
            pk_a[si, : len(p)] = p
        cbase_a = np.stack(cb_l) if t else np.zeros((s, 1), np.int32)
        ccnt_a = np.stack(cc_l) if t else np.zeros((s, 1), np.int32)

        ftids_g, fwn_g = fwd_tids, fwd_wnorm
        l_pad = ftids_g.shape[1]
        ftids = np.full((s, per, l_pad), -1, np.int32)
        fwn = np.zeros((s, per, l_pad), np.float32)
        for si in range(s):
            lo, hi = si * per, min((si + 1) * per, n_rows_global)
            src_hi = min(hi, ftids_g.shape[0])
            if src_hi > lo:
                ftids[si, : src_hi - lo] = ftids_g[lo:src_hi]
                fwn[si, : src_hi - lo] = fwn_g[lo:src_hi]
        fz = np.stack([fuse_forward(ftids[si], fwn[si], fwd_width) for si in range(s)])

    def put(a):  # [S, ...] -> each shard's entry on its device
        return None if a is None else tuple(torch.as_tensor(np.ascontiguousarray(a)[si]).to(dev)
                                            for si, dev in enumerate(mesh.shard_devices))

    idf_s = np.repeat(idf[None, :], s, axis=0)
    return ShardedLexIndex(
        doc_rows=put(dr), tfs=put(tf), offsets=put(off), idf=put(idf_s), doc_len=put(dl),
        frame_ids=put(fid), live=put(live), row_base=put(base),
        avgdl=torch.tensor(avgdl_f, dtype=torch.float32, device=mesh.device), wnorm=put(wn),
        fwd_tids=put(ftids), fwd_wnorm=put(fwn), fwd_fused=put(fz), pk_chunks=put(pk_a),
        chunk_base=put(cbase_a), chunk_counts=put(ccnt_a),
        max_df=((max_df + 127) // 128) * 128, pk_qb=pk_qb, pk_max_chunks=pk_maxc, fwd_width=fwd_width,
    )


def _resolve_lex_backend(lex: ShardedLexIndex, backend: str, q2: int = 16) -> str:
    """The BM25 lane's implementation. "auto" decides on the device the postings
    live on: CUDA resolves as the TPU does ("candidates_pallas" while the TPU
    kernel's plane guard passes), the CPU to the plain merge harness
    ("candidates")."""
    if backend != "auto":
        return backend
    if lex.doc_rows[0].device.type != "cuda":
        return "candidates"
    q2_pow2 = 2
    while q2_pow2 < q2:
        q2_pow2 *= 2
    if q2_pow2 * dma_window(int(lex.max_df)) > _PALLAS_MAX_PLANE_ELEMS:
        return "candidates"
    return "candidates_pallas"


def _local_bm25_candidates_topk(tids, doc_rows, wnorm, offsets, idf, kk: int, w: int, mode: str,
                                pallas: bool, fwd_tids=None, fwd_wnorm=None, rescore: bool = False,
                                chunked=None, fwd_width: int = 0, fwd_fused=None):
    """One shard's candidate-set BM25 top-k: (vals, local rows), rows -1 dead.

    With `rescore`, candidates are generated OR-mode ("count"-ranked for AND queries)
    from the budgeted postings and the top-F are rescored exactly against the shard's
    forward index. With `pallas` the kernels generate them: the chunked kernel (K4)
    when `chunked` = (pk, chunk_base, chunk_counts, qb, max_chunks) is given, else K8
    (its in-kernel top 3 per slot position when rescoring, its whole plane
    otherwise)."""
    gen_mode = ("count" if mode == "all" else "any") if rescore else mode
    if rescore and pallas:
        if chunked is not None:
            pk, cbase, ccnt, pk_qb, pk_maxc = chunked
            cand_rows, keys = chunked_candidates_sel(tids, pk, cbase, ccnt, qb=pk_qb, max_chunks=pk_maxc,
                                                     mode=gen_mode, sel=_SEL_LEVELS)
        else:
            cand_rows, keys = candidate_scores_pallas(tids, doc_rows, wnorm, offsets, idf, max_df=w,
                                                      mode=gen_mode, sel=_SEL_LEVELS)
        f = int(min(max(4 * kk, 256), keys.shape[-1]))
        _, cpos = stable_top_k(keys, f)
        crows = torch.gather(cand_rows, 1, cpos)
        return rescore_topk(tids, crows, fwd_tids, fwd_wnorm, idf, kk, mode,
                            fwd_width=fwd_width, fwd_fused=fwd_fused)
    if pallas:
        rows, scores = candidate_scores_pallas(tids, doc_rows, wnorm, offsets, idf, max_df=w, mode=gen_mode)
    else:
        rows, scores = candidate_scores_sorted(tids, doc_rows, wnorm, offsets, idf, w, gen_mode)
    if rescore:
        f = int(min(max(4 * kk, 256), scores.shape[-1]))
        cvals, cpos = wide_topk(scores, f, exact=False)
        crows = torch.where(cvals > NEG_INF * 0.5, torch.gather(rows, 1, cpos), -1)
        return rescore_topk(tids, crows, fwd_tids, fwd_wnorm, idf, kk, mode,
                            fwd_width=fwd_width, fwd_fused=fwd_fused)
    vals, pos = wide_topk(scores, kk)
    sel = torch.gather(rows, 1, pos)
    ok = vals > NEG_INF * 0.5
    return torch.where(ok, vals, NEG_INF), torch.where(ok, sel, -1)


def _bm25_lane(tids, lex: ShardedLexIndex, s: int, kk: int, mode: str, backend: str):
    """The BM25 lane on shard s: (vals [B, kk], frame ids [B, kk])."""
    if backend not in ("candidates", "candidates_pallas"):
        raise ValueError(f"unknown BM25 backend {backend!r} (the port has 'candidates' and "
                         "'candidates_pallas')")
    rescore = lex.fwd_tids is not None
    chunked = None
    if rescore and backend == "candidates_pallas" and lex.pk_chunks is not None:
        chunked = (lex.pk_chunks[s], lex.chunk_base[s], lex.chunk_counts[s], lex.pk_qb, lex.pk_max_chunks)
    vals, rows = _local_bm25_candidates_topk(
        tids, lex.doc_rows[s], lex.wnorm[s], lex.offsets[s], lex.idf[s], kk, int(lex.max_df), mode,
        pallas=backend == "candidates_pallas",
        fwd_tids=lex.fwd_tids[s] if rescore else None, fwd_wnorm=lex.fwd_wnorm[s] if rescore else None,
        rescore=rescore, chunked=chunked, fwd_width=lex.fwd_width,
        fwd_fused=lex.fwd_fused[s] if rescore and lex.fwd_fused is not None else None,
    )
    fids = torch.where(vals > NEG_INF * 0.5, lex.frame_ids[s][rows.clamp(min=0).long()], -1)
    return vals, fids.to(torch.int32)


def _term_batches(term_ids, mesh: Mesh) -> tuple:
    """The padded term ids [B, Q] (a [Q] row becomes [1, Q]) as int32 on each shard's
    device."""
    tids = torch.as_tensor(term_ids).to(torch.int32)
    return replicate(mesh, tids[None, :] if tids.dim() == 1 else tids)


def _bm25_shards(tids, lex: ShardedLexIndex, kk: int, mode: str, backend: str, mesh: Mesh):
    """Every shard's BM25 lane, issued in shard order on the shards' devices."""
    vals, fids = [], []
    for s, dev in enumerate(mesh.shard_devices):
        with on_device(dev):
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


def _dense_lane(q, emb, bias, kk: int, use_chunkmax: bool, use_selkernel: bool):
    """The dense lane on one shard's rows: (vals [B, kk], local rows [B, kk])."""
    if use_chunkmax:
        from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk

        return chunkmax_scan_topk(q, emb, bias, kk)
    if use_selkernel:
        from wax_tpu_torch.ops.flat_scan import _packed_sel_scan_topk, _pick_tn

        return _packed_sel_scan_topk(q.to(emb.dtype).contiguous(), emb, bias, kk, _pick_tn(emb.shape[0]))
    return blockmax_topk(_scores_f32(q.to(emb.dtype), emb, bias), kk)


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
    on the lead device."""
    lex_backend = _resolve_lex_backend(lex, lex_backend, q2=int(term_ids.shape[-1]))
    fetch = max(2 * int(k), 16)
    local_rows = dense.local_rows
    use_chunkmax = (dense.contiguous and local_rows % 2048 == 0 and local_rows >= _CHUNKMAX_MIN_LOCAL_ROWS
                    and min(fetch, local_rows) <= 100)
    use_selkernel = (not use_chunkmax and _SELKERNEL_MIN_LOCAL_ROWS <= local_rows
                     and min(fetch, local_rows) <= 100)
    qs = replicate(mesh, torch.as_tensor(queries, dtype=torch.float32))
    tids = _term_batches(term_ids, mesh)

    dvals, dfids = [], []
    for s, dev in enumerate(mesh.shard_devices):
        emb, d_fids, d_bias = dense.shard(s)
        with on_device(dev):
            dv, drows = _dense_lane(qs[s], emb, d_bias, min(fetch, local_rows), use_chunkmax, use_selkernel)
            dvals.append(dv)
            dfids.append(torch.where(dv > NEG_INF * 0.5, d_fids[drows.clamp(min=0).long()], -1).to(torch.int32))
    lvals, lfids = _bm25_shards(tids, lex, min(fetch, lex.n_local), "any", lex_backend, mesh)
    _, dfid_g = merge_topk_across_mesh(dvals, dfids, fetch, mesh)
    _, lfid_g = merge_topk_across_mesh(lvals, lfids, fetch, mesh)
    return _rrf_on_device(dfid_g, lfid_g, int(k), fetch, float(w_dense), float(w_bm25), float(rrf_k))
