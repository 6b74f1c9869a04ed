"""Hierarchical top-k candidate merge across the mesh's corpus shards.

PyTorch port of `wax_tpu.parallel.merge`. The all-gather is a copy of each shard's
[B, kk] list to the mesh's lead device (`non_blocking`, so no host synchronisation);
the lists are concatenated in JAX's candidate order and merged with the stable top-k:
first within each slice (its data shards in order), then, on a two-level mesh, the
slices' merged [B, k] lists in slice order. Ties therefore break as in the JAX
package, and a two-level mesh gives the flat mesh's answer bit for bit. Dead slots
carry NEG_INF and id -1; a list narrower than k is padded back to k.
"""
from __future__ import annotations

import torch

from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.parallel.mesh import DATA_AXIS, SLICE_AXIS, Mesh
from wax_tpu_torch.utils.profiling import device_span

__all__ = ["merge_topk_across_mesh"]


def _gather_merge(vals: list, fids: list, k: int):
    """Concatenate candidate lists [B, kk] (score-descending) in order and keep the
    top k: (vals, fids) [B, k]."""
    av, af = torch.cat(vals, dim=1), torch.cat(fids, dim=1)
    kk = min(k, av.shape[1])
    mv, pos = stable_top_k(av, kk)
    mf = torch.gather(af, 1, pos)
    mf = torch.where(mv > NEG_INF * 0.5, mf, -1)
    if kk < k:  # tiny shards: pad back to the requested width
        mv = torch.nn.functional.pad(mv, (0, k - kk), value=NEG_INF)
        mf = torch.nn.functional.pad(mf, (0, k - kk), value=-1)
    return mv, mf


def merge_topk_across_mesh(vals, fids, k: int, mesh: Mesh):
    """Merge the corpus shards' top-k lists into the global top-k on the lead device.

    `vals`/`fids` are sequences of [B, kk] lists, one per corpus shard in corpus order
    (a single tensor stands for a one-shard mesh). Returns (vals, fids) [B, k]."""
    if torch.is_tensor(vals):
        vals, fids = [vals], [fids]
    n = mesh.corpus_shards
    if len(vals) != n or len(fids) != n:
        raise ValueError(f"{len(vals)} candidate lists for {n} corpus shards")
    lead = mesh.device
    with device_span("merge.across_mesh", lead):
        vals = [v.to(lead, non_blocking=True) for v in vals]
        fids = [f.to(lead, non_blocking=True) for f in fids]
        per = mesh.shape[DATA_AXIS]
        slices = [_gather_merge(vals[i:i + per], fids[i:i + per], k) for i in range(0, n, per)]
        if SLICE_AXIS not in mesh.axis_names:
            return slices[0]
        return _gather_merge([v for v, _ in slices], [f for _, f in slices], k)
