"""Chunk-max flat scan: exact large-corpus top-k in three stages.

PyTorch port of `wax_tpu.ops.chunkmax_scan`:

  1. kernel K6 (`chunk_maxima`, `csrc/chunkmax.cu`): Q.D^T + bias reduced to the
     maximum of every 128-row chunk, [B, N/128] f32; the [B, N] scores never exist;
  2. `blockmax_topk` over the chunk maxima picks the k best chunks per query (a
     top-k element's chunk always has a top-k maximum, so this stays exact);
  3. kernel K7 (`ops/ivf_kernel.py`) rescores the winning chunks exactly, a flat
     corpus being an IVF index of 128-row buckets probed in chunk-rank order.

Queries are cast to the corpus dtype for stage 1 and that bf16-rounded query, widened
to f32, is what K7 rescores with (as the JAX package does). `K6_LAUNCHES` counts K6
launches; on CPU tensors `chunk_maxima` runs its plain twin `_chunk_maxima_plain`.
"""
from __future__ import annotations

import ctypes

import torch

from wax_tpu_torch.ops._build import launch, load_library, on_cpu
from wax_tpu_torch.ops.ivf_kernel import ivf_rescore
from wax_tpu_torch.ops.topk import NEG_INF, blockmax_topk

__all__ = ["chunkmax_scan_topk", "chunk_maxima", "mma_plan", "K6_LAUNCHES"]

K6_LAUNCHES = 0
_CHUNK = 128
_TN = 2048  # the JAX package's corpus tile: the row count must be a multiple of it


def _chunk_maxima_plain(q, emb, bias):
    """Plain twin of K6: [B, N/128] f32 chunk maxima of the f32 scores plus bias."""
    scores = torch.matmul(q.float(), emb.float().t()) + bias[None, :]
    return scores.reshape(q.shape[0], -1, _CHUNK).amax(dim=2)


def chunk_maxima(q, emb, bias):
    """K6 wrapper: q [B, d] and emb [N, d] of one dtype (f32 or bf16), bias [N] f32,
    N % 128 == 0 -> [B, N/128] f32 chunk maxima."""
    global K6_LAUNCHES
    if on_cpu(q, emb, bias):
        return _chunk_maxima_plain(q, emb, bias)
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"need q [B, d] and emb [N, d], got {tuple(q.shape)} and {tuple(emb.shape)}")
    if q.dtype != emb.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and emb must both be float32 or both bfloat16, got {q.dtype}, {emb.dtype}")
    if bias.dtype != torch.float32 or bias.shape != (emb.shape[0],) or emb.shape[0] % _CHUNK:
        raise ValueError(f"bias must be f32 [N] with N % {_CHUNK} == 0, got {bias.dtype} {tuple(bias.shape)}")
    if not (q.is_contiguous() and emb.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, emb and bias must be contiguous")
    (b, d), n = q.shape, emb.shape[0]
    cm = torch.empty((b, n // _CHUNK), dtype=torch.float32, device=q.device)
    if b:
        launch("wax_k6_chunk_maxima", q.device, q.data_ptr(), emb.data_ptr(), bias.data_ptr(),
               cm.data_ptr(), b, n, d, int(q.dtype == torch.bfloat16))
        K6_LAUNCHES += 1
    return cm


def mma_plan(b: int, n: int) -> dict:
    """How K6's bf16 tensor-core path launches for b queries over n rows on the current
    CUDA device (builds the kernels; needs a card)."""
    out = (ctypes.c_int * 7)()
    err = load_library().wax_k6_mma_plan(b, n, ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"wax_k6_mma_plan failed: CUDA error {err}")
    keys = ("queries_per_cta", "smem_bytes", "grid_x", "grid_y", "ctas_per_sm", "stages", "depth_per_stage")
    return dict(zip(keys, out))


def chunkmax_scan_topk(queries: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor, k: int):
    """Exact top-k over a contiguous [N, d] corpus (N % 2048 == 0).

    Args:
      queries: [B, d] (cast to emb's dtype for the chunk maxima).
      emb: [N, d] corpus, f32 or bf16.
      bias: [N] f32 additive mask (0 live / NEG_INF dead); the live rows must form a
        prefix, since each chunk is masked by its live count.
      k: top-k (k * 128 rows are rescored per query).

    Returns (scores [B, k] f32, rows [B, k] int32 into emb; -1 padded).
    """
    n, d = emb.shape
    if n % _TN:
        raise ValueError(f"corpus rows must be a multiple of {_TN}")
    q = queries.to(emb.dtype).contiguous()
    n_chunks = n // _CHUNK
    cm = chunk_maxima(q, emb, bias)
    kc = min(k, n_chunks)  # small corpora have fewer chunks than k: rescore them all
    _, chunks = blockmax_topk(cm, kc)
    counts = (bias.reshape(n_chunks, _CHUNK) > NEG_INF * 0.5).sum(dim=1).to(torch.int32)
    ids2 = torch.arange(n, dtype=torch.int32, device=emb.device).reshape(n_chunks, _CHUNK)
    return ivf_rescore(q.float(), chunks.to(torch.int32).contiguous(), counts,
                       emb.reshape(n_chunks, _CHUNK, d), ids2, k)
