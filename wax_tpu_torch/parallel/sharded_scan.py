"""Corpus-sharded dense index layout.

PyTorch port of `wax_tpu.parallel.sharded_scan`'s `ShardedDenseIndex` and
`shard_dense_index` on a one-device mesh: the [N_pad, d] matrix, the frame ids and an
additive row bias (0 live, NEG_INF dead) on the mesh's device.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from wax_tpu_torch.index.dense import DenseIndex
from wax_tpu_torch.ops.topk import NEG_INF
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards

__all__ = ["ShardedDenseIndex", "shard_dense_index"]


@dataclass(frozen=True)
class ShardedDenseIndex:
    """emb [N_pad, d], frame_ids [N_pad] i32 and bias [N_pad] f32 (0 live, NEG_INF
    dead); `contiguous` when the live rows form a dense prefix, which the chunkmax
    dense lane requires."""

    emb: torch.Tensor
    frame_ids: torch.Tensor
    bias: torch.Tensor
    contiguous: bool = False


def shard_dense_index(index: DenseIndex, mesh: Mesh) -> ShardedDenseIndex:
    """Lay a DenseIndex snapshot out over the mesh: rows padded to a multiple of the
    shard count (padding rows carry NEG_INF bias and frame id -1)."""
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
    dev = mesh.device
    return ShardedDenseIndex(emb=emb.to(dev).contiguous(), frame_ids=fids.to(dev),
                             bias=bias.to(dev).contiguous(), contiguous=index.contiguous)
