"""Dense vector index: an immutable tensor snapshot and a host-side numpy builder.

PyTorch port of `wax_tpu.index.dense`. The builder is a copy of the JAX package's
numpy builder (same MIN_CAPACITY doubling, ROW_ALIGN, cosine normalisation in
`_prep`, upsert as tombstone plus append); only `snapshot()` differs: it returns a
frozen dataclass of torch tensors on an explicit device.

Padding and masking: `emb` has capacity rows; rows >= `count` are zero, removed rows
stay in place with `active=False`, and `frame_ids` carries -1 for both.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["DenseIndex", "DenseIndexBuilder", "Similarity"]


class Similarity:
    COSINE = "cosine"
    DOT = "dot"
    EUCLIDEAN = "euclidean"


@dataclass(frozen=True)
class DenseIndex:
    """Dense index snapshot.

    Attributes:
      emb:        [capacity, dim] f32 or bf16; cosine rows are L2-normalised.
      frame_ids:  [capacity] int32 external ids; -1 for padding and tombstones.
      active:     [capacity] bool; False for padding and removed rows.
      count:      0-d int32, occupied rows (active or tombstoned).
      similarity: Similarity name.
      contiguous: True when live rows form a dense prefix (no tombstones).
    """

    emb: torch.Tensor
    frame_ids: torch.Tensor
    active: torch.Tensor
    count: torch.Tensor
    similarity: str = Similarity.COSINE
    contiguous: bool = False

    @property
    def capacity(self) -> int:
        return self.emb.shape[0]

    @property
    def dim(self) -> int:
        return self.emb.shape[1]

    @property
    def device(self) -> torch.device:
        return self.emb.device

    def live_count(self) -> int:
        return int(self.active.sum())


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class DenseIndexBuilder:
    """Host-side mutable builder producing `DenseIndex` snapshots.

    Capacity grows by doubling from MIN_CAPACITY and stays a multiple of ROW_ALIGN, so
    the scan kernels' corpus tiles always divide it. add() of an existing id is an
    upsert (tombstone + append).
    """

    MIN_CAPACITY = 1024
    ROW_ALIGN = 512

    def __init__(
        self,
        dim: int,
        similarity: str = Similarity.COSINE,
        dtype: np.dtype = np.float32,
        capacity: int = 0,
    ):
        self.dim = int(dim)
        self.similarity = similarity
        self.dtype = np.dtype(dtype)
        cap = max(self.MIN_CAPACITY, _round_up(max(capacity, 1), self.ROW_ALIGN))
        self._emb = np.zeros((cap, self.dim), dtype=self.dtype)
        self._frame_ids = np.full((cap,), -1, dtype=np.int32)
        self._active = np.zeros((cap,), dtype=bool)
        self._count = 0
        self._row_of: dict[int, int] = {}
        self._generation = 0

    def __len__(self) -> int:
        return len(self._row_of)

    @property
    def count(self) -> int:
        return self._count

    @property
    def generation(self) -> int:
        return self._generation

    def __contains__(self, frame_id: int) -> bool:
        return int(frame_id) in self._row_of

    def vector(self, frame_id: int) -> np.ndarray | None:
        row = self._row_of.get(int(frame_id))
        return None if row is None else self._emb[row].copy()

    def _ensure_capacity(self, extra: int) -> None:
        need = self._count + extra
        cap = self._emb.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        cap = _round_up(cap, self.ROW_ALIGN)
        self._emb = np.vstack([self._emb, np.zeros((cap - self._emb.shape[0], self.dim), self.dtype)])
        self._frame_ids = np.concatenate([self._frame_ids, np.full((cap - self._frame_ids.shape[0],), -1, np.int32)])
        self._active = np.concatenate([self._active, np.zeros((cap - self._active.shape[0],), bool)])

    def _prep(self, vecs: np.ndarray) -> np.ndarray:
        vecs = np.asarray(vecs, dtype=np.float32)
        if vecs.ndim == 1:
            vecs = vecs[None, :]
        if vecs.shape[1] != self.dim:
            raise ValueError(f"dimension mismatch: got {vecs.shape[1]}, index dim {self.dim}")
        if self.similarity == Similarity.COSINE:
            norms = np.linalg.norm(vecs, axis=1, keepdims=True)
            vecs = np.where(norms > 0, vecs / np.maximum(norms, 1e-30), vecs)
        return vecs.astype(self.dtype)

    def add(self, frame_id: int, vec: np.ndarray) -> None:
        self.add_batch(np.asarray([frame_id], dtype=np.int64), self._prep(vec))

    def add_batch(self, frame_ids: np.ndarray, vecs: np.ndarray) -> None:
        vecs = self._prep(vecs)
        frame_ids = np.asarray(frame_ids, dtype=np.int64)
        if frame_ids.shape[0] != vecs.shape[0]:
            raise ValueError("frame_ids and vectors length mismatch")
        self._ensure_capacity(vecs.shape[0])
        for fid, v in zip(frame_ids.tolist(), vecs):
            old = self._row_of.pop(fid, None)
            if old is not None:
                self._active[old] = False
                self._frame_ids[old] = -1
            row = self._count
            self._emb[row] = v
            self._frame_ids[row] = fid
            self._active[row] = True
            self._row_of[fid] = row
            self._count += 1
        self._generation += 1

    def remove(self, frame_id: int) -> bool:
        row = self._row_of.pop(int(frame_id), None)
        if row is None:
            return False
        self._active[row] = False
        self._frame_ids[row] = -1
        self._emb[row] = 0
        self._generation += 1
        return True

    def snapshot(
        self, device: str | torch.device = "cpu", device_dtype: torch.dtype | None = None
    ) -> DenseIndex:
        """Copy the current state into an immutable snapshot on `device`, stored as
        `device_dtype` (None keeps the builder's f32). Every field is a copy, so later
        builder mutations never reach the snapshot."""
        emb = torch.tensor(self._emb, device=device)
        if device_dtype is not None and emb.dtype != device_dtype:
            emb = emb.to(device_dtype)
        return DenseIndex(
            emb=emb,
            frame_ids=torch.tensor(self._frame_ids, device=device),
            active=torch.tensor(self._active, device=device),
            count=torch.tensor(self._count, dtype=torch.int32, device=device),
            similarity=self.similarity,
            contiguous=bool(self._active[: self._count].all()) if self._count else True,
        )
