"""Bucket-gather exact rescore with per-query top-k: kernel K7.

PyTorch port of `wax_tpu.ops.ivf_kernel._run`, the TPU kernel that scores each
query's probed [S, d] buckets and extracts its exact top-k. Here it serves the
chunk-max scan (`ops/chunkmax_scan.py`, buckets = 128-row chunks); the IVF entry
`ivf_search_topk_pallas` waits for the IVF slice.

`bucket_rescore` is the kernel wrapper: on CUDA tensors it launches K7
(`csrc/ivf_kernel.cu`), on CPU tensors it runs the plain version
`_bucket_rescore_plain`. Both return the k best candidates by (f32 score desc, flat
position p * S + r asc), so ties go to the lowest position in probe-rank order, not to
the lowest row. `K7_LAUNCHES` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from wax_tpu_torch.ops._build import launch, load_library, on_cpu
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k

__all__ = ["bucket_rescore", "ivf_rescore", "launch_plan", "K7_LAUNCHES"]

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
