"""Mesh-sharded IVF search: bucket slots distributed over the corpus shards.

PyTorch port of `wax_tpu.parallel.sharded_ivf`. Each cluster's fixed-size bucket is
split along its slot axis: shard s holds slots [s*S/n, (s+1)*S/n) of every bucket, so
every query probes the same nprobe clusters on every shard and the probe work divides
exactly by the shard count. Centroids are small and replicated; each shard picks the
probes itself (replicated work, as in JAX), runs the probe loop in JAX's order (probe
rank, then slot, keeping min(kk, local slots) a step) and the candidate lists merge on
the lead device (`parallel/merge.py`). The JAX body is an einsum scan, not a Pallas
kernel, so this one is plain torch; its f32 products stay f32 when TF32 is on.

Determinism: the merged candidate order is (shard, probe rank, slot) and every top-k is
stable, so results repeat run to run on a fixed mesh shape. Tie order can differ from
the one-device `ivf_search_topk`, which merges probe by probe; scores are exact either
way. A spilled index fetches a 2k window and collapses duplicate frame ids.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from wax_tpu_torch.index.ivf import IVFIndex, _assign_scores, _pad_k, dedup_topk
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.parallel.merge import merge_topk_across_mesh
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards, on_device, replicate
from wax_tpu_torch.utils.device import full_f32_matmul

__all__ = ["ShardedIVFIndex", "shard_ivf_index", "sharded_ivf_search_topk"]


@dataclass(frozen=True)
class ShardedIVFIndex:
    """An IVF snapshot laid out over a mesh's corpus shards; each field is a tuple
    holding each shard's part on its device (views of one tensor where the shards share
    a device).

    centroids: [C, d] f32, replicated (one copy per distinct device).
    emb:       [C, S_loc, d] the shard's slot block of every bucket.
    ids:       [C, S_loc] int32, -1 padding.
    bias:      [C, S_loc] f32 additive mask (0 live, NEG_INF padding).
    """

    centroids: tuple
    emb: tuple
    ids: tuple
    bias: tuple
    spilled: bool = False

    @property
    def n_shards(self) -> int:
        return len(self.emb)

    @property
    def n_clusters(self) -> int:
        return self.centroids[0].shape[0]

    @property
    def local_slots(self) -> int:
        return self.emb[0].shape[1]

    @property
    def bucket_size(self) -> int:
        return self.local_slots * self.n_shards

    def shard(self, s: int):
        """(centroids, emb, ids, bias) of corpus shard s."""
        return self.centroids[s], self.emb[s], self.ids[s], self.bias[s]


def shard_ivf_index(index: IVFIndex, mesh: Mesh) -> ShardedIVFIndex:
    """Lay a built IVFIndex out over the mesh, slot axis over the corpus shards.

    Pads the bucket size to a multiple of the shard count; padding slots carry NEG_INF
    bias and id -1, exactly like build-time bucket padding."""
    n_shards = corpus_shards(mesh)
    pad = (-index.bucket_size) % n_shards
    emb, ids, bias = index.emb, index.ids, index.bias
    if pad:
        emb = torch.nn.functional.pad(emb, (0, 0, 0, pad))
        ids = torch.nn.functional.pad(ids, (0, pad), value=-1)
        bias = torch.nn.functional.pad(bias, (0, pad), value=NEG_INF)
    s_loc = emb.shape[1] // n_shards

    def split(a):
        return tuple(a[:, s * s_loc:(s + 1) * s_loc].to(dev) for s, dev in enumerate(mesh.shard_devices))

    return ShardedIVFIndex(centroids=replicate(mesh, index.centroids), emb=split(emb), ids=split(ids),
                           bias=split(bias), spilled=index.spilled)


def _shard_probe_topk(q, probes, emb, ids, bias, kk: int):
    """One shard's probe loop: (vals, fids) [B, kk] over its slots of the probed
    buckets, one probe rank at a time."""
    b, s_loc = q.shape[0], emb.shape[1]
    best_v = torch.full((b, kk), NEG_INF, dtype=torch.float32, device=q.device)
    best_f = torch.full((b, kk), -1, dtype=torch.int32, device=q.device)
    step_k = min(kk, s_loc)
    for p in range(probes.shape[1]):
        col = probes[:, p]
        scores = torch.bmm(emb[col].float(), q[:, :, None])[..., 0] + bias[col]
        v, pos = stable_top_k(scores, step_k)
        f = torch.gather(ids[col], 1, pos)
        best_v, mpos = stable_top_k(torch.cat([best_v, v], dim=1), kk)
        best_f = torch.gather(torch.cat([best_f, f], dim=1), 1, mpos)
    return best_v, best_f


@full_f32_matmul
def sharded_ivf_search_topk(queries, index: ShardedIVFIndex, k: int, mesh: Mesh, nprobe: int = 8):
    """Distributed IVF top-k: probe selection on each shard's device, the shard's slots
    of the probed buckets scored exactly, the candidate merge across the mesh.

    queries [B, d]. Returns (scores [B, k] f32, frame ids [B, k] int32) on the lead
    device, -1 padded."""
    nprobe = min(nprobe, index.n_clusters)
    kfetch = 2 * k if index.spilled else k
    qs = replicate(mesh, torch.as_tensor(queries, dtype=torch.float32))
    probes_on = {}  # probe selection once per distinct device (it is replicated work)
    vals, fids = [], []
    for s, dev in enumerate(mesh.shard_devices):
        centroids, emb, ids, bias = index.shard(s)
        with on_device(dev):
            if dev not in probes_on:
                probes_on[dev] = stable_top_k(_assign_scores(qs[s], centroids), nprobe)[1]
            kk = min(kfetch, emb.shape[1] * nprobe)
            v, f = _shard_probe_topk(qs[s], probes_on[dev], emb, ids, bias, kk)
        vals.append(v)
        fids.append(f)
    mvals, mfids = merge_topk_across_mesh(vals, fids, kfetch, mesh)
    if index.spilled:
        mvals, mfids = dedup_topk(mvals, mfids.to(torch.int32), k)
    else:
        mvals, mfids = mvals[:, :k], mfids[:, :k]
    mvals, mfids = _pad_k(mvals, mfids, k)
    return mvals, mfids.to(torch.int32)
