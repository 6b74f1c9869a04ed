"""Bucket-gather exact rescore with per-query top-k: kernel K7.

PyTorch port of `wax_tpu.ops.ivf_kernel`: the TPU kernel that scores each query's
probed [S, d] buckets and extracts its exact top-k, and its IVF entry
`ivf_search_topk_pallas`. K7 serves the IVF search and the chunk-max scan
(`ops/chunkmax_scan.py`, buckets = 128-row chunks).

`bucket_rescore` is the kernel wrapper: on CUDA tensors it launches K7
(`csrc/ivf_kernel.cu`), on CPU tensors it runs the plain version
`_bucket_rescore_plain`. Both return the k best candidates by (f32 score desc, flat
position p * S + r asc), so ties go to the lowest position in probe-rank order, not to
the lowest row. `K7_LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from wax_tpu_torch.index.ivf import IVFIndex, _assign_scores, _pad_k, dedup_topk, ivf_search_topk
from wax_tpu_torch.ops._build import launch, load_library, on_cpu
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k

__all__ = ["argmax_fits", "bucket_rescore", "ivf_rescore", "ivf_search_topk_pallas", "launch_plan", "K7_LAUNCHES"]

_KPAD = 128  # the most candidates the TPU kernel extracts a query (its output lanes)
_SMEM_MAX = 227 * 1024  # shared memory a CTA may hold on sm_90 (`SMEM_MAX` in csrc/ivf_kernel.cu)
_ARGMAX_STATIC = 64  # the arg-max body's static shared memory: one 8-byte slot for each of its 8 warps

K7_LAUNCHES = 0


def _check_args(q, probes, counts, emb3, k: int) -> None:
    if q.dim() != 2 or q.dtype != torch.float32:
        raise ValueError(f"q must be f32 [B, d], got {q.dtype} {tuple(q.shape)}")
    if emb3.dim() != 3 or emb3.shape[2] != q.shape[1] or emb3.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"emb3 must be f32/bf16 [C, S, d], got {emb3.dtype} {tuple(emb3.shape)}")
    if probes.dtype != torch.int32 or probes.dim() != 2 or probes.shape[0] != q.shape[0]:
        raise ValueError(f"probes must be i32 [B, nprobe], got {probes.dtype} {tuple(probes.shape)}")
    if counts.dtype != torch.int32 or counts.shape != (emb3.shape[0],):
        raise ValueError(f"counts must be i32 [C], got {counts.dtype} {tuple(counts.shape)}")
    if not all(t.is_contiguous() for t in (q, probes, counts, emb3)):
        raise ValueError("q, probes, counts and emb3 must be contiguous")
    if not 1 <= k <= probes.shape[1] * emb3.shape[1]:
        raise ValueError(f"k={k} outside [1, nprobe * S = {probes.shape[1] * emb3.shape[1]}]")


def _bucket_rescore_plain(q, probes, counts, emb3, k: int):
    """Plain twin of K7: (vals [B, k] f32, flat positions [B, k] i32)."""
    b, nprobe = probes.shape
    s = emb3.shape[1]
    p = probes.long()
    rows = emb3[p].float().reshape(b, nprobe * s, -1)  # [B, nprobe*S, d]
    scores = torch.bmm(rows, q[:, :, None])[..., 0]
    slot = torch.arange(s, device=q.device)
    live = (slot[None, None, :] < counts[p][..., None]).reshape(b, nprobe * s)
    scores = torch.where(live, scores, NEG_INF)
    vals, pos = stable_top_k(scores, k)
    return vals, pos.to(torch.int32)


def bucket_rescore(q, probes, counts, emb3, k: int):
    """K7 wrapper: the k best of each query's probed buckets, as (vals [B, k] f32,
    flat positions [B, k] i32 into the [nprobe * S] candidate plane).

    q [B, d] f32; probes [B, nprobe] i32 bucket ids; counts [C] i32 live rows per
    bucket (rows at or past the count score NEG_INF); emb3 [C, S, d] f32 or bf16."""
    global K7_LAUNCHES
    if on_cpu(q, probes, counts, emb3):
        return _bucket_rescore_plain(q, probes, counts, emb3, k)
    _check_args(q, probes, counts, emb3, k)
    b, nprobe = probes.shape
    _, s, d = emb3.shape
    vals = torch.empty((b, k), dtype=torch.float32, device=q.device)
    pos = torch.empty((b, k), dtype=torch.int32, device=q.device)
    if b:
        launch("wax_k7_bucket_rescore", q.device, q.data_ptr(), probes.data_ptr(), counts.data_ptr(),
               emb3.data_ptr(), vals.data_ptr(), pos.data_ptr(), b, d, s, nprobe, k,
               int(emb3.dtype == torch.bfloat16))
        K7_LAUNCHES += 1
    return vals, pos


def launch_plan(d: int, s: int, k: int, dtype=torch.bfloat16) -> dict:
    """How K7 launches for rows of d elements, buckets of s rows and this k on the
    current CUDA device (builds the kernels; needs a card): the ring body (k <= 128)
    or the arg-max body, the ring's rows per slab, shared memory and CTAs per SM."""
    out = (ctypes.c_int * 4)()
    err = load_library().wax_k7_plan(d, s, k, int(dtype == torch.bfloat16), ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"wax_k7_plan failed: CUDA error {err}")
    return dict(zip(("ring", "rows_per_slab", "smem_bytes", "ctas_per_sm"), out))


def argmax_fits(d: int, s: int, nprobe: int) -> bool:
    """Whether K7's arg-max body (k > 128) holds a query's plane of nprobe * s 8-byte
    keys and its d-float query row in one CTA's shared memory."""
    return nprobe * s * 8 + d * 4 + _ARGMAX_STATIC <= _SMEM_MAX


def ivf_rescore(q, probes, counts, emb3, ids2, k: int):
    """`wax_tpu.ops.ivf_kernel._run`: K7, then flat positions decoded through the
    probe list to ids2[bucket, slot]; dead slots carry NEG_INF and id -1."""
    vals, pos = bucket_rescore(q, probes, counts, emb3, k)
    s = emb3.shape[1]
    probe_rank = pos.long() // s
    slot = pos.long() % s
    bucket = torch.gather(probes.long(), 1, probe_rank)
    ids = ids2[bucket, slot]
    ids = torch.where(vals > NEG_INF * 0.5, ids, -1)
    vals = torch.where(ids >= 0, vals, NEG_INF)
    return vals, ids.to(torch.int32)


def ivf_search_topk_pallas(queries: torch.Tensor, index: IVFIndex, k: int = 10, nprobe: int = 8):
    """IVF search through K7: `index.ivf_search_topk`'s results, each query's probed
    buckets scored and ranked by the kernel. Needs a 128-aligned bucket size.

    As the TPU kernel, K7 returns at most 128 candidates a query on an index without
    spill: there k > 128 gives [B, 128]. On a spilled index K7 fetches a window of
    min(2k, nprobe * S) candidates and duplicates are collapsed after it, as the plain
    path does. A window past 128 takes K7's arg-max body, whose key plane must fit
    shared memory (`argmax_fits`); where it does not, the plain path answers (the TPU
    kernel's 128 lanes send every spilled 2k > 128 there)."""
    if queries.dim() == 1:
        queries = queries[None, :]
    if index.bucket_size % 128:
        raise ValueError("the IVF kernel path requires a 128-aligned bucket size")
    nprobe = min(nprobe, index.n_clusters)
    if index.spilled and 2 * k > _KPAD and not argmax_fits(index.dim, index.bucket_size, nprobe):
        return ivf_search_topk(queries, index, k, nprobe)
    q = queries.float().contiguous()
    _, probes = stable_top_k(_assign_scores(q, index.centroids), nprobe)
    counts = (index.ids >= 0).sum(dim=1).to(torch.int32)  # live rows a bucket: a prefix
    width = index.bucket_size * nprobe
    kfetch = min(2 * k, width) if index.spilled else min(k, _KPAD)
    vals, fids = ivf_rescore(q, probes.to(torch.int32).contiguous(), counts, index.emb, index.ids,
                             min(kfetch, width))
    vals, fids = _pad_k(vals, fids, kfetch)
    if index.spilled:
        vals, fids = _pad_k(*dedup_topk(vals, fids, min(k, kfetch)), k)
    return vals, fids
