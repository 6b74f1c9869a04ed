"""The device mesh the sharded programs run on.

PyTorch port of `wax_tpu.parallel.mesh`, narrowed to one device: a `Mesh` holds the
device and has one corpus shard, so every sharded array keeps its leading shard axis
of length 1 and the cross-shard merges reduce to a stable top-k. Meshes over several
GPUs (`torch.distributed`) come with the multi-GPU slice.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from wax_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "data_mesh", "corpus_shards"]


@dataclass(frozen=True)
class Mesh:
    """A one-device mesh: the corpus lives on `device` as a single shard."""

    device: torch.device

    @property
    def corpus_shards(self) -> int:
        return 1


def data_mesh(device: str | torch.device | None = None) -> Mesh:
    """The corpus-sharding mesh over one device (None: the current CUDA device)."""
    return Mesh(resolve_device(device))


def corpus_shards(mesh: Mesh) -> int:
    """Number of corpus row shards on this mesh."""
    return mesh.corpus_shards
