"""Mesh-sharded dense scan: distributed flat-scan top-k over a corpus-sharded index.

PyTorch port of `wax_tpu.parallel.sharded_scan`. The [N, d] embedding matrix is split
into row blocks, one per corpus shard, each on its shard's device; the query batch is
replicated; each shard computes its exact local top-k and the candidates merge on the
lead device (`parallel/merge.py`).

A shard's local top-k takes the chunkmax dense lane (`ops/chunkmax_scan`: K6's chunk
maxima, the k best chunks, K7's exact rescore; no [B, N] score plane) when its rows
allow it, by the rule of the sharded hybrid program's dense lane: a contiguous index, at
least `_CHUNKMAX_MIN_LOCAL_ROWS` local rows, a multiple of 2,048, and k <= 100. Other
shards keep the JAX module's XLA body in plain torch: f32-accumulated products plus the
row bias (f32 when a process turns TF32 on), then `blockmax_topk`. The JAX module runs
XLA on every shard; the two routes give the same scores up to summation order, and the
same ids but for near-ties of the k-th score and exact ties (chunkmax ranks exactly tied
rows by their chunk's rank, blockmax by row).

Determinism: the global candidate order is (shard, local extraction order) and every
merge is a stable top-k, so ties resolve alike on every run, and on every mesh shape
over the same global row order where the shards take the blockmax route.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from wax_tpu_torch.index.dense import DenseIndex
from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk
from wax_tpu_torch.ops.flat_scan import _scores_f32
from wax_tpu_torch.ops.topk import NEG_INF, blockmax_topk
from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards, on_device, replicate, shard_rows
from wax_tpu_torch.utils.profiling import count, device_span

__all__ = ["ShardedDenseIndex", "shard_dense_index", "sharded_flat_scan_topk"]

_CHUNKMAX_MIN_LOCAL_ROWS = 524_288  # as `parallel/sharded_hybrid` and flat_scan's "auto"


@dataclass(frozen=True)
class ShardedDenseIndex:
    """emb [N_pad, d], frame_ids [N_pad] i32 and bias [N_pad] f32 (0 live, NEG_INF
    dead) split into equal row blocks, one per corpus shard: each field is a tuple of
    the shards' blocks on their devices (views of one tensor where the shards share a
    device). `contiguous` when the live rows form a dense prefix (each shard's live
    rows are then a prefix too), which the chunkmax dense lane requires."""

    emb: tuple
    frame_ids: tuple
    bias: tuple
    contiguous: bool = False

    @property
    def n_shards(self) -> int:
        return len(self.emb)

    @property
    def local_rows(self) -> int:
        return self.emb[0].shape[0]

    def shard(self, s: int):
        """(emb, frame_ids, bias) of corpus shard s."""
        return self.emb[s], self.frame_ids[s], self.bias[s]


def shard_dense_index(index: DenseIndex, mesh: Mesh, dtype: torch.dtype | None = None) -> ShardedDenseIndex:
    """Lay a DenseIndex snapshot out over the mesh: rows padded to a multiple of the
    shard count (padding rows carry NEG_INF bias and frame id -1), each shard's block
    moved to its device and, with `dtype`, cast there."""
    n_shards = corpus_shards(mesh)
    cap = index.capacity
    pad = (-cap) % n_shards
    rows = torch.arange(cap, device=index.device)
    live = index.active & (rows < index.count)
    bias = torch.where(live, 0.0, NEG_INF).to(torch.float32)
    emb, fids = index.emb, index.frame_ids
    if pad:
        emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        fids = torch.nn.functional.pad(fids, (0, pad), value=-1)
        bias = torch.nn.functional.pad(bias, (0, pad), value=NEG_INF)
    emb = shard_rows(mesh, emb)
    if dtype is not None:
        emb = tuple(e.to(dtype) for e in emb)
    return ShardedDenseIndex(emb=emb, frame_ids=shard_rows(mesh, fids), bias=shard_rows(mesh, bias),
                             contiguous=index.contiguous)


def sharded_flat_scan_topk(queries, index: ShardedDenseIndex, k: int, mesh: Mesh):
    """Distributed dense top-k: each shard's exact local top-k (queries cast to the
    rows' dtype; the chunkmax lane K6 + K7 where the shard qualifies, else
    f32-accumulated products plus the bias and a blockmax top-k), issued on its device
    with no host synchronisation, then the merge across the mesh. Each shard routed to
    chunkmax adds one to the counter `sharded_scan.chunkmax_shards`.

    queries [B, d] (numpy or a tensor). Returns (scores [B, k] f32, frame_ids [B, k]
    i32) on the mesh's lead device."""
    with device_span("sharded_scan.call", mesh.device):
        q = torch.as_tensor(queries, dtype=torch.float32)
        qs = replicate(mesh, q)
        n = index.local_rows
        kk = min(k, n)
        chunkmax = index.contiguous and n % 2048 == 0 and n >= _CHUNKMAX_MIN_LOCAL_ROWS and kk <= 100
        vals, fids = [], []
        for s, dev in enumerate(mesh.shard_devices):
            emb, sf, bias = index.shard(s)
            with on_device(dev), device_span("sharded_scan.local", dev):
                if chunkmax:
                    count("sharded_scan.chunkmax_shards")
                    v, rows = chunkmax_scan_topk(qs[s], emb, bias, kk)
                else:
                    v, rows = blockmax_topk(_scores_f32(qs[s].to(emb.dtype), emb, bias), kk)
                vals.append(v)
                fids.append(torch.where(v > NEG_INF * 0.5, sf[rows.clamp(min=0).long()], -1))
        mv, mf = merge_topk_across_mesh(vals, fids, int(k), mesh)
        return mv, mf.to(torch.int32)
