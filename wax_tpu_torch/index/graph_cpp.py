# Copy of wax_tpu/index/graph_cpp.py with two changes: it loads the port's native
# library (wax_tpu_torch.native.build), and `snapshot` takes the port snapshot's
# `device` and passes it through; its docstrings name the port's files.
# Keep the two in step.
"""ctypes wrapper over the native C++ HNSW builder (wax_tpu_torch/native/hnsw.cpp).

Same interface as the pure-Python HNSWBuilder; construction runs ~2 orders of
magnitude faster. Snapshot/serialization round-trips through the shared state-array
format so the two builders are interchangeable on disk and in the vector engine.
"""
from __future__ import annotations

import ctypes

import numpy as np

from wax_tpu_torch.index.graph import GraphIndex, HNSWBuilder
from wax_tpu_torch.native.build import load_library

__all__ = ["CppHNSWBuilder", "best_hnsw_builder"]


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class CppHNSWBuilder:
    def __init__(
        self,
        dim: int,
        m: int = 16,
        ef_construction: int = 100,
        seed: int = 0,
        normalize: bool = True,
        extend_candidates: bool = True,
    ):
        lib = load_library()
        if lib is None:
            raise RuntimeError("native library unavailable")
        self._lib = lib
        self.dim = dim
        self.m = m
        self.ef_construction = ef_construction
        self.normalize = normalize
        self._h = lib.wax_hnsw_create(dim, m, ef_construction, seed, 1 if normalize else 0)
        # default ON: beats an hnswlib-faithful comparator on every measured regime
        # (scripts/hnsw_parity.py; numbers in graph.py HNSWBuilder.__init__)
        if extend_candidates:
            lib.wax_hnsw_set_extend_candidates(self._h, 1)

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.wax_hnsw_free(h)
            self._h = None

    # -- mutation ---------------------------------------------------------------------
    def add(self, frame_id: int, vec: np.ndarray) -> None:
        v = np.ascontiguousarray(np.asarray(vec, np.float32).ravel())
        if v.shape[0] != self.dim:
            raise ValueError(f"dim mismatch {v.shape[0]} != {self.dim}")
        self._lib.wax_hnsw_add(self._h, int(frame_id), _f32p(v))

    def add_batch(self, frame_ids, vecs: np.ndarray) -> None:
        fids = np.ascontiguousarray(np.asarray(frame_ids, np.int64))
        v = np.ascontiguousarray(np.asarray(vecs, np.float32))
        if v.shape[1] != self.dim:
            raise ValueError("dim mismatch")
        self._lib.wax_hnsw_add_batch(self._h, len(fids), _i64p(fids), _f32p(v))

    def remove(self, frame_id: int) -> bool:
        return bool(self._lib.wax_hnsw_remove(self._h, int(frame_id)))

    def set_extend_candidates(self, enable: bool) -> None:
        """Toggle the HNSW paper alg. 4 extendCandidates construction option."""
        self._lib.wax_hnsw_set_extend_candidates(self._h, 1 if enable else 0)

    def cpu_search_batch(self, queries: np.ndarray, k: int, ef: int) -> np.ndarray:
        """Classic CPU best-first search (paper alg. 5) over this builder's graph.

        Returns [nq, k] frame ids (-1 padded). Used by the construction-parity
        harness (scripts/hnsw_parity.py); production queries use the device beam
        (ops/beam_search.py)."""
        q = np.ascontiguousarray(np.asarray(queries, np.float32))
        nq = q.shape[0]
        out = np.full((nq, k), -1, np.int64)
        self._lib.wax_hnsw_search_batch(self._h, nq, _f32p(q), int(k), int(ef), _i64p(out))
        return out

    def __len__(self) -> int:
        return int(self._lib.wax_hnsw_live(self._h))

    def __contains__(self, fid: int) -> bool:
        return bool(self._lib.wax_hnsw_contains(self._h, int(fid)))

    @property
    def generation(self) -> int:
        return int(self._lib.wax_hnsw_generation(self._h))

    # -- state ------------------------------------------------------------------------
    def state_arrays(self) -> dict[str, np.ndarray]:
        n = int(self._lib.wax_hnsw_count(self._h))
        e = int(self._lib.wax_hnsw_edge_count(self._h))
        vecs = np.zeros((n, self.dim), np.float32)
        fids = np.zeros(n, np.int64)
        active = np.zeros(n, np.uint8)
        levels = np.zeros(n, np.int32)
        edges = np.zeros((e, 3), np.int64)
        meta = np.zeros(4, np.int64)
        if n:
            self._lib.wax_hnsw_export(
                self._h, _f32p(vecs), _i64p(fids), _u8p(active), _i32p(levels), _i64p(edges), _i64p(meta)
            )
        else:
            meta[:] = [-1, -1, self.m, self.ef_construction]
        return {
            "vecs": vecs,
            "frame_ids": fids,
            "active": active.astype(bool),
            "levels": levels,
            "edges": edges,
            "meta": meta,
        }

    @classmethod
    def from_state_arrays(cls, arrays: dict[str, np.ndarray], dim: int, normalize: bool = True) -> "CppHNSWBuilder":
        entry, max_level, m, efc = arrays["meta"].tolist()
        b = cls(dim=dim, m=int(m), ef_construction=int(efc), normalize=normalize)
        n = arrays["vecs"].shape[0]
        vecs = np.ascontiguousarray(arrays["vecs"], np.float32)
        fids = np.ascontiguousarray(arrays["frame_ids"], np.int64)
        active = np.ascontiguousarray(arrays["active"].astype(np.uint8))
        levels = np.ascontiguousarray(arrays["levels"], np.int32)
        edges = np.ascontiguousarray(arrays["edges"], np.int64)
        meta = np.ascontiguousarray(arrays["meta"], np.int64)
        b._lib.wax_hnsw_import(
            b._h, n, _f32p(vecs), _i64p(fids), _u8p(active), _i32p(levels), len(edges), _i64p(edges), _i64p(meta)
        )
        return b

    # -- snapshot (shared logic with the Python builder via state arrays) ---------------
    def snapshot(self, device_dtype=None, seed_cap: int = 8192, device=None) -> GraphIndex:
        py = HNSWBuilder.from_state_arrays(self.state_arrays(), dim=self.dim, normalize=self.normalize)
        return py.snapshot(device_dtype, seed_cap=seed_cap, device=device)

    def vector(self, frame_id: int) -> np.ndarray | None:
        arrays = self.state_arrays()
        idx = np.nonzero((arrays["frame_ids"] == int(frame_id)) & arrays["active"])[0]
        return arrays["vecs"][idx[0]].copy() if len(idx) else None


def best_hnsw_builder(dim: int, **kw):
    """Native builder when the toolchain produced a library, Python otherwise."""
    try:
        return CppHNSWBuilder(dim=dim, **kw)
    except RuntimeError:
        return HNSWBuilder(dim=dim, **kw)
