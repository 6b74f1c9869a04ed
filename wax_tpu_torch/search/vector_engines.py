"""Vector engine protocol and the flat (brute-force scan) engine.

PyTorch port of the flat half of `wax_tpu.search.vector_engines`. `FlatVectorEngine`
keeps a `DenseIndexBuilder` on the host and a device snapshot cached per builder
generation; `search()` runs `flat_scan_topk` on the snapshot's device and returns
numpy arrays. The HNSW, IVF and auto engines come in later slices.

Top-k is clamped at MAX_TOP_K = 10,000, as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from wax_tpu_torch.index.dense import DenseIndexBuilder, Similarity
from wax_tpu_torch.ops.flat_scan import flat_scan_topk
from wax_tpu_torch.utils.concurrency import FreshLockOnCopyMixin
from wax_tpu_torch.utils.device import resolve_device

__all__ = ["VectorEngine", "FlatVectorEngine", "MAX_TOP_K", "BF16_AUTO_ROWS"]

MAX_TOP_K = 10_000

# device_dtype="auto" stores the embedding matrix in bfloat16 from this many rows on,
# halving its device memory; scores still accumulate in f32. Below it storage stays
# f32 and results are exact.
BF16_AUTO_ROWS = 1_000_000


@runtime_checkable
class VectorEngine(Protocol):
    kind: str

    def add(self, frame_id: int, vec: np.ndarray) -> None: ...
    def add_batch(self, frame_ids, vecs: np.ndarray) -> None: ...
    def remove(self, frame_id: int) -> bool: ...
    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]: ...
    def __len__(self) -> int: ...
    def __contains__(self, frame_id: int) -> bool: ...


class FlatVectorEngine(FreshLockOnCopyMixin):
    """Brute-force engine over the fused scan kernels (snapshot cached per builder
    generation)."""

    kind = "flat"

    def __init__(
        self,
        dim: int,
        similarity: str = Similarity.COSINE,
        device_dtype="auto",
        device: str | torch.device | None = None,
    ):
        """`device_dtype`: None keeps f32; torch.bfloat16 halves device memory; "auto"
        is f32 until BF16_AUTO_ROWS rows, then bf16. `device` holds the snapshot (None:
        the current CUDA device)."""
        self._snap_lock = threading.Lock()
        self.builder = DenseIndexBuilder(dim=dim, similarity=similarity)
        self.device_dtype = device_dtype
        self.device = resolve_device(device)
        self._snap = None
        self._snap_gen = -1
        self._snap_dtype = None
        self.snapshot_count = 0

    def _resolve_dtype(self):
        if isinstance(self.device_dtype, str) and self.device_dtype == "auto":
            return torch.bfloat16 if len(self.builder) >= BF16_AUTO_ROWS else None
        return self.device_dtype

    @property
    def dim(self) -> int:
        return self.builder.dim

    def add(self, frame_id, vec):
        self.builder.add(frame_id, vec)

    def add_batch(self, frame_ids, vecs):
        self.builder.add_batch(np.asarray(frame_ids), vecs)

    def remove(self, frame_id) -> bool:
        return self.builder.remove(frame_id)

    def snapshot(self):
        dtype = self._resolve_dtype()
        with self._snap_lock:
            if self._snap is None or self._snap_gen != self.builder.generation or self._snap_dtype != dtype:
                self._snap = self.builder.snapshot(device=self.device, device_dtype=dtype)
                self._snap_gen = self.builder.generation
                self._snap_dtype = dtype
                self.snapshot_count += 1
            return self._snap

    def search(self, queries, k: int):
        """Top-k (scores, frame_ids) as numpy arrays [B, k]; `queries` is a numpy
        array or a tensor [B, dim] (or [dim]). Missing slots carry -inf / -1."""
        k = min(k, MAX_TOP_K)
        if len(self.builder) == 0:
            b = np.atleast_2d(np.asarray(queries.cpu() if torch.is_tensor(queries) else queries)).shape[0]
            return np.full((b, k), -np.inf, np.float32), np.full((b, k), -1, np.int32)
        snap = self.snapshot()
        q = torch.as_tensor(queries, dtype=torch.float32).to(snap.device)
        q = torch.atleast_2d(q)
        kk = min(k, snap.capacity)
        vals, _, fids = flat_scan_topk(q, snap, kk)
        vals, fids = vals.cpu().numpy(), fids.cpu().numpy()
        if vals.shape[1] < k:
            pad = k - vals.shape[1]
            vals = np.pad(vals, ((0, 0), (0, pad)), constant_values=-np.inf)
            fids = np.pad(fids, ((0, 0), (0, pad)), constant_values=-1)
        return vals, fids

    def __len__(self):
        return len(self.builder)

    def __contains__(self, fid):
        return fid in self.builder
