"""Vector engines: the flat (brute-force scan), HNSW, IVF and recall-measuring auto engines.

PyTorch port of `wax_tpu.search.vector_engines`. Each engine keeps a host-side
builder and a device snapshot cached per builder generation; `search()` runs on the
snapshot's device and returns numpy arrays. `FlatVectorEngine` scans with
`flat_scan_topk`; `HNSWVectorEngine` builds a graph on the host (`index/graph_cpp.py`,
the native builder) and answers by the batched beam search (`ops/beam_search.py`);
`IVFVectorEngine` probes k-means buckets (`index/ivf.py`, kernel K7);
`AutoVectorEngine` serves the flat scan below AUTO_ANN_ROWS rows and from there an IVF
engine whose sampled recall it has measured (it never selects HNSW, as in JAX). The
mesh-sharded flat engine comes with multi-GPU serving (ROADMAP queue 1, item 5).

Top-k is clamped at MAX_TOP_K = 10,000, as in the JAX package.
"""
from __future__ import annotations

import threading
from typing import Protocol, runtime_checkable

import numpy as np
import torch

from wax_tpu_torch.index.dense import DenseIndexBuilder, Similarity
from wax_tpu_torch.index.ivf import IVFIndex, _assign_scores, build_ivf, ivf_search_topk
from wax_tpu_torch.ops.beam_search import hnsw_search
from wax_tpu_torch.ops.flat_scan import flat_scan_topk
from wax_tpu_torch.ops.ivf_kernel import ivf_search_topk_pallas
from wax_tpu_torch.ops.topk import stable_top_k
from wax_tpu_torch.utils.concurrency import FreshLockOnCopyMixin
from wax_tpu_torch.utils.device import resolve_device

__all__ = [
    "VectorEngine",
    "AutoVectorEngine",
    "FlatVectorEngine",
    "HNSWVectorEngine",
    "IVFVectorEngine",
    "make_vector_engine",
    "MAX_TOP_K",
    "BF16_AUTO_ROWS",
    "AUTO_ANN_ROWS",
    "AUTO_RECALL_TARGET",
]

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


def _query_tensor(queries, device: torch.device) -> torch.Tensor:
    """`queries` (numpy or a tensor, [B, d] or [d]) as f32 [B, d] on `device`."""
    return torch.atleast_2d(torch.as_tensor(queries, dtype=torch.float32).to(device))


def _empty_result(queries, k: int):
    """The answer of an empty engine: -inf scores and -1 ids, [B, k]."""
    b = np.atleast_2d(np.asarray(queries.cpu() if torch.is_tensor(queries) else queries)).shape[0]
    return np.full((b, k), -np.inf, np.float32), np.full((b, k), -1, np.int32)


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

    def trace(self, snap) -> None:
        """Run the scan once on a GIVEN snapshot at B 1, k 24 (the orchestrator's
        serving shape): builds and first-launches its kernel. The orchestrator's
        warmup takes the snapshot under its read lock and calls this outside it."""
        flat_scan_topk(torch.zeros((1, snap.dim), device=snap.device), snap, min(24, snap.capacity))

    def search(self, queries, k: int):
        """Top-k (scores, frame_ids) as numpy arrays [B, k]; `queries` is a numpy
        array or a tensor [B, dim] (or [dim]). Missing slots carry -inf / -1."""
        k = min(k, MAX_TOP_K)
        if len(self.builder) == 0:
            return _empty_result(queries, k)
        snap = self.snapshot()
        kk = min(k, snap.capacity)
        vals, _, fids = flat_scan_topk(_query_tensor(queries, snap.device), snap, kk)
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


class HNSWVectorEngine(FreshLockOnCopyMixin):
    """Approximate graph engine (M 16 by default, as the reference's USearch engine).
    It builds with the native C++ builder when the native library builds, else with
    the numpy builder (host code either way); its snapshot lives on `device`."""

    kind = "hnsw"

    def __init__(
        self,
        dim: int,
        m: int = 16,
        ef_construction: int = 100,
        ef_search: int = 64,
        device: str | torch.device | None = None,
    ):
        """`device` holds the snapshot (None: the current CUDA device)."""
        from wax_tpu_torch.index.graph_cpp import best_hnsw_builder

        self._snap_lock = threading.Lock()
        self.device = resolve_device(device)
        self.builder = best_hnsw_builder(dim, m=m, ef_construction=ef_construction)
        self.ef_search = ef_search
        self._snap = None
        self._snap_gen = -1
        self.snapshot_count = 0

    @property
    def dim(self) -> int:
        return self.builder.dim

    def add(self, frame_id, vec):
        self.builder.add(frame_id, vec)

    def add_batch(self, frame_ids, vecs):
        self.builder.add_batch(frame_ids, vecs)

    def remove(self, frame_id) -> bool:
        return self.builder.remove(frame_id)

    def snapshot(self):
        with self._snap_lock:
            if self._snap is None or self._snap_gen != self.builder.generation:
                self._snap = self.builder.snapshot(device=self.device)
                self._snap_gen = self.builder.generation
                self.snapshot_count += 1
            return self._snap

    def trace(self, snap) -> None:
        """One B 1 search on a GIVEN snapshot (see FlatVectorEngine.trace)."""
        hnsw_search(torch.zeros((1, snap.dim), device=snap.device), snap, k=1, ef=max(self.ef_search, 1))

    def search(self, queries, k: int):
        """Top-k (scores, frame_ids) as numpy arrays [B, k] (see FlatVectorEngine), by
        the beam search at ef = max(ef_search, k)."""
        k = min(k, MAX_TOP_K)
        if len(self.builder) == 0:
            return _empty_result(queries, k)
        graph = self.snapshot()
        vals, fids = hnsw_search(_query_tensor(queries, graph.device), graph, k=k, ef=max(self.ef_search, k))
        return vals.cpu().numpy(), fids.cpu().numpy()

    def __len__(self):
        return len(self.builder)

    def __contains__(self, fid):
        return fid in self.builder


class IVFVectorEngine(FreshLockOnCopyMixin):
    """Approximate bucketed engine (see index/ivf.py).

    Adds accumulate in a dense builder and the IVF snapshot re-packs lazily. New
    vectors since the last snapshot slot into the existing buckets (the first of their
    8 preferred centroids with room) while the corpus is at most twice the size k-means
    last trained on; removals, upserts, a spilled index or no room left force a full
    rebuild with a new training."""

    kind = "ivf"

    def __init__(
        self,
        dim: int,
        n_clusters: int | None = None,
        nprobe: int = 8,
        seed: int = 0,
        bucket_dtype: torch.dtype | None = None,
        spill: float | str = 0.0,
        device: str | torch.device | None = None,
    ):
        """`spill` enables boundary copies at full rebuilds (build_ivf(spill=...)); it
        takes the bucket slack that incremental adds would use, so a spilled engine
        always re-packs on new adds. `device` holds the snapshot (None: the current
        CUDA device)."""
        self._snap_lock = threading.Lock()
        self.builder = DenseIndexBuilder(dim=dim, similarity=Similarity.COSINE)
        self.n_clusters = n_clusters
        self.nprobe = nprobe
        self.seed = seed
        self.bucket_dtype = bucket_dtype
        self.spill = spill
        self.device = resolve_device(device)
        self._snap: IVFIndex | None = None
        self._snap_gen = -1
        self._trained_count = 0
        self.snapshot_count = 0
        self._pending_adds: list[tuple[int, np.ndarray]] = []
        self._needs_full = False
        self.incremental_count = 0

    @property
    def dim(self) -> int:
        return self.builder.dim

    def add(self, frame_id, vec):
        if int(frame_id) in self.builder._row_of:
            self._needs_full = True  # upsert: the stale copy must leave the buckets
        else:
            self._pending_adds.append((int(frame_id), self.builder._prep(vec)[0]))
        self.builder.add(frame_id, vec)

    def add_batch(self, frame_ids, vecs):
        frame_ids = np.asarray(frame_ids)
        fid_list = frame_ids.tolist()
        if len(set(fid_list)) != len(fid_list) or any(int(f) in self.builder._row_of for f in fid_list):
            self._needs_full = True  # upsert, against the index or within the batch
        else:
            prepped = self.builder._prep(vecs)
            self._pending_adds.extend((int(f), v) for f, v in zip(fid_list, prepped))
        self.builder.add_batch(frame_ids, vecs)

    def remove(self, frame_id) -> bool:
        ok = self.builder.remove(frame_id)
        if ok:
            self._needs_full = True
        return ok

    def _try_incremental(self) -> IVFIndex | None:
        """The snapshot with the pending adds slotted into its buckets (the first of
        each vector's 8 preferred centroids with room, else the emptiest bucket; live
        rows stay a prefix of each bucket), or None when every bucket is full."""
        snap = self._snap
        c, s = snap.n_clusters, snap.bucket_size
        fids = np.asarray([f for f, _ in self._pending_adds], np.int64)
        vecs = torch.from_numpy(np.stack([v for _, v in self._pending_adds]).astype(np.float32)).to(snap.device)
        _, prefs = stable_top_k(_assign_scores(vecs, snap.centroids), min(8, c))
        prefs = prefs.cpu().numpy()
        fills = (snap.ids >= 0).sum(dim=1).cpu().numpy()
        b_idx = np.empty(len(fids), np.int64)
        s_idx = np.empty(len(fids), np.int64)
        for i in range(len(fids)):
            for cand in prefs[i]:
                if fills[cand] < s:
                    b = int(cand)
                    break
            else:
                b = int(np.argmin(fills))
                if fills[b] >= s:
                    return None
            b_idx[i] = b
            s_idx[i] = fills[b]
            fills[b] += 1
        bi, si = torch.from_numpy(b_idx).to(snap.device), torch.from_numpy(s_idx).to(snap.device)
        emb, ids, bias = snap.emb.clone(), snap.ids.clone(), snap.bias.clone()  # snapshots stay immutable
        emb[bi, si] = vecs.to(emb.dtype)
        ids[bi, si] = torch.from_numpy(fids).to(snap.device, torch.int32)
        bias[bi, si] = 0.0
        return IVFIndex(centroids=snap.centroids, emb=emb, ids=ids, bias=bias, spilled=snap.spilled)

    def snapshot(self) -> IVFIndex:
        # building consumes the pending adds, so it is exclusive under concurrent readers
        with self._snap_lock:
            if self._snap is None or self._snap_gen != self.builder.generation:
                incremental = None
                if (
                    self._snap is not None
                    and not self._needs_full
                    and not self.spill
                    and self._pending_adds
                    and len(self.builder) <= 2 * max(self._trained_count, 1)
                ):
                    incremental = self._try_incremental()
                if incremental is not None:
                    self._snap = incremental
                    self.incremental_count += 1
                else:
                    state = self.builder.state_arrays()
                    live = state["active"]
                    vecs = state["emb"][live]
                    self._snap = build_ivf(vecs, state["frame_ids"][live], n_clusters=self.n_clusters,
                                           seed=self.seed, bucket_dtype=self.bucket_dtype, spill=self.spill,
                                           device=self.device)
                    self._trained_count = len(vecs)
                    self._needs_full = False
                self._pending_adds.clear()
                self._snap_gen = self.builder.generation
                self.snapshot_count += 1
            return self._snap

    def trace(self, snap: IVFIndex) -> None:
        """One B 1, k 24 search on a GIVEN snapshot (see FlatVectorEngine.trace)."""
        self._search_snapshot(snap, torch.zeros((1, self.dim), device=snap.device), 24)

    def search(self, queries, k: int):
        """Top-k (scores, frame_ids) as numpy arrays [B, k] (see FlatVectorEngine):
        through K7 (`ivf_search_topk_pallas`) when the bucket size is 128-aligned, else
        the plain probe loop."""
        k = min(k, MAX_TOP_K)
        if len(self.builder) == 0:
            return _empty_result(queries, k)
        snap = self.snapshot()
        vals, fids = self._search_snapshot(snap, _query_tensor(queries, snap.device), k)
        return vals.cpu().numpy(), fids.cpu().numpy()

    def _search_snapshot(self, snap: IVFIndex, q: torch.Tensor, k: int):
        if snap.bucket_size % 128 == 0:
            return ivf_search_topk_pallas(q, snap, k=k, nprobe=self.nprobe)
        return ivf_search_topk(q, snap, k=k, nprobe=self.nprobe)

    def __len__(self):
        return len(self.builder)

    def __contains__(self, fid):
        return fid in self.builder


AUTO_ANN_ROWS = 2_097_152  # the exact scan serves below this many rows
AUTO_RECALL_TARGET = 0.95
_AUTO_NPROBE_LADDER = (8, 16, 32, 64)
_AUTO_SAMPLE_Q = 64
_AUTO_SAMPLE_K = 10


class AutoVectorEngine(FreshLockOnCopyMixin):
    """Recall-aware engine selection.

    Below `ann_rows` the corpus serves from the exact flat scan. From there the engine
    measures sampled recall@10 of IVF against the exact scan on perturbed corpus rows,
    climbing the nprobe ladder (8, 16, 32, 64) and then boundary spill at nprobe 64
    until the measured recall reaches `recall_target`; if no IVF configuration does, it
    serves the exact scan. The decision, its measured recall and its reason are in
    `stats()`, and are taken again at each new builder generation."""

    kind = "auto"

    def __init__(
        self,
        dim: int,
        similarity: str = Similarity.COSINE,
        device_dtype="auto",
        ann_rows: int = AUTO_ANN_ROWS,
        recall_target: float = AUTO_RECALL_TARGET,
        seed: int = 0,
        device: str | torch.device | None = None,
    ):
        """`device` holds every snapshot (None: the current CUDA device)."""
        self._flat = FlatVectorEngine(dim=dim, similarity=similarity, device_dtype=device_dtype, device=device)
        self.ann_rows = int(ann_rows)
        self.recall_target = float(recall_target)
        self.seed = int(seed)
        self._ann: IVFVectorEngine | None = None
        self._route_gen = -1
        self.selection = {"engine": "flat", "reason": "empty corpus", "measured_recall": None}

    @property
    def builder(self) -> DenseIndexBuilder:
        return self._flat.builder

    @builder.setter
    def builder(self, b: DenseIndexBuilder) -> None:
        self._flat.builder = b
        self._flat._snap = None
        self._flat._snap_gen = -1
        self._ann = None
        self._route_gen = -1

    @property
    def dim(self) -> int:
        return self._flat.dim

    @property
    def device(self) -> torch.device:
        return self._flat.device

    @property
    def device_dtype(self):
        return self._flat.device_dtype

    @property
    def snapshot_count(self) -> int:
        """Snapshots built by the flat lane and the IVF engine now served."""
        return self._flat.snapshot_count + (self._ann.snapshot_count if self._ann is not None else 0)

    def add(self, frame_id, vec):
        self._flat.add(frame_id, vec)

    def add_batch(self, frame_ids, vecs):
        self._flat.add_batch(frame_ids, vecs)

    def remove(self, frame_id) -> bool:
        return self._flat.remove(frame_id)

    def __len__(self):
        return len(self._flat)

    def __contains__(self, fid):
        return fid in self._flat

    def stats(self) -> dict:
        """The current routing decision: engine, measured sampled recall, reason."""
        return dict(self.selection)

    def _sample_queries(self, rng: np.random.Generator) -> np.ndarray:
        state = self.builder.state_arrays()
        live_rows = np.nonzero(state["active"])[0]
        rows = rng.choice(live_rows, size=min(_AUTO_SAMPLE_Q, len(live_rows)), replace=False)
        q = state["emb"][rows].astype(np.float32)
        q = q + rng.normal(0.0, 0.05, q.shape).astype(np.float32)
        return q / np.maximum(np.linalg.norm(q, axis=1, keepdims=True), 1e-9)

    @staticmethod
    def _recall(exact_f, got_f) -> float:
        hits = total = 0
        for e_row, g_row in zip(exact_f, got_f):
            ref = {int(f) for f in e_row if f >= 0}
            if not ref:
                continue
            hits += len(ref & {int(f) for f in g_row if f >= 0})
            total += len(ref)
        return hits / max(total, 1)

    def _decide(self) -> None:
        gen = self.builder.generation
        if self._route_gen == gen:
            return
        n = len(self.builder)
        self._ann = None
        if n == 0:
            self.selection = {"engine": "flat", "reason": "empty corpus", "measured_recall": None}
            self._route_gen = gen
            return
        if n < self.ann_rows:
            self.selection = {"engine": "flat", "reason": f"{n} rows < ann_rows={self.ann_rows}: exact fused scan",
                              "measured_recall": 1.0}
            self._route_gen = gen
            return
        rng = np.random.default_rng(self.seed ^ (gen & 0x7FFFFFFF))
        q = self._sample_queries(rng)
        _, exact_f = self._flat.search(q, _AUTO_SAMPLE_K)
        plain = IVFVectorEngine(dim=self.dim, seed=self.seed, device=self.device)
        spilled = IVFVectorEngine(dim=self.dim, seed=self.seed, spill="auto", device=self.device)
        best = (-1.0, None)
        for eng, ladder in ((plain, _AUTO_NPROBE_LADDER), (spilled, _AUTO_NPROBE_LADDER[-1:])):
            eng.builder = self.builder
            for nprobe in ladder:
                eng.nprobe = int(nprobe)
                _, got_f = eng.search(q, _AUTO_SAMPLE_K)
                rec = self._recall(exact_f, got_f)
                if rec > best[0]:
                    best = (rec, nprobe)
                if rec >= self.recall_target:
                    self._ann = eng
                    self.selection = {
                        "engine": "ivf",
                        "reason": (f"measured recall@{_AUTO_SAMPLE_K} {rec:.3f} >= {self.recall_target} at "
                                   f"nprobe={nprobe}" + (", spill=auto" if eng is spilled else "")),
                        "measured_recall": round(rec, 4),
                        "nprobe": int(nprobe),
                    }
                    self._route_gen = gen
                    return
        self.selection = {
            "engine": "flat",
            "reason": (f"no ANN config reached recall {self.recall_target} on this geometry "
                       f"(best {best[0]:.3f} at nprobe={best[1]}): serving the exact scan"),
            "measured_recall": 1.0,
        }
        self._route_gen = gen

    def _route(self):
        self._decide()
        return self._ann if self._ann is not None else self._flat

    def snapshot(self):
        return self._route().snapshot()

    def trace(self, snap) -> None:
        """One serving-shape search on a GIVEN snapshot of the current route (see
        FlatVectorEngine.trace)."""
        (self._ann if isinstance(snap, IVFIndex) else self._flat).trace(snap)

    def search(self, queries, k: int):
        return self._route().search(queries, k)


def make_vector_engine(preference: str, dim: int, **kw):
    """preference: "auto" (AutoVectorEngine: the exact scan below AUTO_ANN_ROWS, then
    measured-recall IVF with an exact fallback), "flat", "hnsw" or "ivf"; keyword
    arguments go to the engine (`device` among them)."""
    if preference == "auto":
        return AutoVectorEngine(dim=dim, **kw)
    if preference == "flat":
        return FlatVectorEngine(dim=dim, **kw)
    if preference == "hnsw":
        return HNSWVectorEngine(dim=dim, **kw)
    if preference == "ivf":
        return IVFVectorEngine(dim=dim, **kw)
    if preference == "sharded":
        raise NotImplementedError("the sharded flat engine is not ported yet (ROADMAP queue 1, item 5: multi-GPU)")
    raise ValueError(f"unknown vector engine preference {preference!r}")
