"""Top-k candidate merge across the mesh's corpus shards.

PyTorch port of `wax_tpu.parallel.merge` on a one-device mesh: the all-gather of the
per-shard [B, kk] lists is the list itself, so the merge is the stable top-k (ties to
the earlier candidate) with the JAX package's padding rules: dead slots carry NEG_INF
and id -1, and a list narrower than k is padded back to k.
"""
from __future__ import annotations

import torch

from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k
from wax_tpu_torch.parallel.mesh import Mesh, corpus_shards

__all__ = ["merge_topk_across_mesh"]


def merge_topk_across_mesh(vals: torch.Tensor, fids: torch.Tensor, k: int, mesh: Mesh):
    """Merge the per-shard top-k lists (vals, fids) [B, kk] into the global
    (vals, fids) [B, k]."""
    if corpus_shards(mesh) != 1:
        raise NotImplementedError("the port's meshes hold one corpus shard")
    kk = min(k, vals.shape[1])
    mv, pos = stable_top_k(vals, kk)
    mf = torch.gather(fids, 1, pos)
    mf = torch.where(mv > NEG_INF * 0.5, mf, -1)
    if kk < k:  # tiny shards: pad back to the requested width
        mv = torch.nn.functional.pad(mv, (0, k - kk), value=NEG_INF)
        mf = torch.nn.functional.pad(mf, (0, k - kk), value=-1)
    return mv, mf
