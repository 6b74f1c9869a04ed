"""HNSW graph index: host-side builder and padded-adjacency device snapshot.

PyTorch port of `wax_tpu.index.graph`. Construction runs on the host in numpy (the
standard HNSW insert: level l = floor(-ln(U)/ln(M)), greedy descent through the upper
layers, an ef_construction beam at the insert layers, links pruned to M, 2M at level
0, by the diversity heuristic). `HNSWBuilder` is the JAX package's builder unchanged,
so the same adds give the same graph. Only `snapshot()` differs: it returns a frozen
dataclass of torch tensors on an explicit device.

The search-time structure is one padded fixed-degree adjacency matrix [N_pad, 3M]
(each node's upper-level links first, then its level-0 links, cut at 3M) plus a set of
entry seeds, consumed by the batched beam search in `ops/beam_search.py`. The device search is
non-hierarchical: it scores every seed densely and runs a wide beam on the flattened
graph.
"""
from __future__ import annotations

import heapq
import math
from dataclasses import dataclass

import numpy as np
import torch

from wax_tpu_torch.ops.topk import NEG_INF
from wax_tpu_torch.utils.device import resolve_device

__all__ = ["GraphIndex", "HNSWBuilder", "graph_index_from_numpy"]


@dataclass(frozen=True)
class GraphIndex:
    """Graph snapshot on one device.

    adjacency: [N_pad, 3M] int32 neighbour row ids, -1 padded (upper-level links
               first, then level-0 links, cut at 3M = 2M + M; N_pad is the row
               count rounded up to 128).
    emb:       [N_pad, dim] vectors (L2-normalised for cosine), f32 or bf16.
    frame_ids: [N_pad] int32, -1 for padding and tombstones.
    bias:      [N_pad] f32 additive score bias (0 live, NEG_INF dead).
    entries:   [E] int32 search entry rows, E a multiple of 8.
    """

    adjacency: torch.Tensor
    emb: torch.Tensor
    frame_ids: torch.Tensor
    bias: torch.Tensor
    entries: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.emb.shape[0]

    @property
    def dim(self) -> int:
        return self.emb.shape[1]

    @property
    def max_degree(self) -> int:
        return self.adjacency.shape[1]

    @property
    def device(self) -> torch.device:
        return self.emb.device


def graph_index_from_numpy(adjacency, emb, frame_ids, bias, entries, device: str | torch.device | None = None):
    """A `GraphIndex` on `device` (None: the current CUDA device) from numpy arrays of
    the same layout, e.g. a `wax_tpu` GraphIndex's fields as numpy (bf16 rows
    included)."""
    device = resolve_device(device)

    def put(a):  # a copy: the arrays may be read-only views
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.tensor(a.view(np.int16), device=device).view(torch.bfloat16)
        return torch.tensor(a, device=device)

    return GraphIndex(adjacency=put(adjacency).to(torch.int32), emb=put(emb), frame_ids=put(frame_ids).to(torch.int32),
                      bias=put(bias).float(), entries=put(entries).to(torch.int32))


class HNSWBuilder:
    """Host-side HNSW construction (numpy). Upsert = remove-then-add
    (USearchVectorEngine.swift:82-100)."""

    def __init__(
        self,
        dim: int,
        m: int = 16,
        ef_construction: int = 100,
        seed: int = 0,
        normalize: bool = True,
        extend_candidates: bool = True,
    ):
        self.dim = dim
        self.m = m
        self.m0 = 2 * m
        self.ef_construction = ef_construction
        self.normalize = normalize
        # HNSW paper alg. 4 extendCandidates: measured on 20K x 384 vs an
        # hnswlib-faithful comparator at matched alg-5 search (scripts/hnsw_parity.py)
        # recall@10 @ef=256: hard-clustered 0.56 -> 0.91 (ref 0.71), loose 0.95
        # (ref 0.88), uniform 0.70 (ref 0.61) — construction beats reference quality
        # on every regime, at ~1.5x build time.
        self.extend_candidates = extend_candidates
        self._ml = 1.0 / math.log(m)
        self._rng = np.random.default_rng(seed)
        cap = 1024
        self._vecs = np.zeros((cap, dim), np.float32)
        self._frame_ids = np.full(cap, -1, np.int64)
        self._active = np.zeros(cap, bool)
        self._levels = np.zeros(cap, np.int32)
        # neighbors[level][node] -> list[int]; level 0 stored for every node
        self._neighbors: list[dict[int, list[int]]] = [dict()]
        self._count = 0
        self._entry: int = -1
        self._max_level = -1
        self._row_of: dict[int, int] = {}
        self.generation = 0

    def __len__(self) -> int:
        return len(self._row_of)

    def __contains__(self, fid: int) -> bool:
        return int(fid) in self._row_of

    # ----------------------------------------------------------------- internals ----
    def _grow(self, need: int) -> None:
        cap = self._vecs.shape[0]
        if need <= cap:
            return
        while cap < need:
            cap *= 2
        grow = cap - self._vecs.shape[0]
        self._vecs = np.vstack([self._vecs, np.zeros((grow, self.dim), np.float32)])
        self._frame_ids = np.concatenate([self._frame_ids, np.full(grow, -1, np.int64)])
        self._active = np.concatenate([self._active, np.zeros(grow, bool)])
        self._levels = np.concatenate([self._levels, np.zeros(grow, np.int32)])

    def _sim(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        return self._vecs[rows] @ q

    def _search_layer(self, q: np.ndarray, entries: list[int], ef: int, level: int) -> list[tuple[float, int]]:
        """Beam search on one layer; returns up to ef (sim, row) best-first."""
        neigh = self._neighbors[level]
        visited = set(entries)
        sims = {e: float(self._vecs[e] @ q) for e in entries}
        # max-heap on similarity for candidates; min-heap for result pool
        cand = [(-sims[e], e) for e in entries]
        heapq.heapify(cand)
        best = [(sims[e], e) for e in entries]
        heapq.heapify(best)  # min-heap: worst of pool at top
        while len(best) > ef:
            heapq.heappop(best)
        while cand:
            negs, node = heapq.heappop(cand)
            if -negs < best[0][0] and len(best) >= ef:
                break
            nbrs = [n for n in neigh.get(node, ()) if n not in visited and self._active[n]]
            if not nbrs:
                continue
            visited.update(nbrs)
            arr = np.asarray(nbrs)
            s = self._sim(q, arr)
            for sim, n in zip(s.tolist(), nbrs):
                if len(best) < ef or sim > best[0][0]:
                    heapq.heappush(cand, (-sim, n))
                    heapq.heappush(best, (sim, n))
                    if len(best) > ef:
                        heapq.heappop(best)
        return sorted(best, reverse=True)

    def _select_neighbors(self, q: np.ndarray, candidates: list[tuple[float, int]], m: int) -> list[int]:
        """Heuristic neighbor selection (keep diverse links, HNSW paper alg. 4)."""
        out: list[int] = []
        for sim, node in candidates:
            if len(out) >= m:
                break
            ok = True
            for chosen in out:
                if float(self._vecs[node] @ self._vecs[chosen]) > sim:
                    ok = False
                    break
            if ok:
                out.append(node)
        # backfill with nearest skipped if diversity pruned too many
        if len(out) < m:
            for sim, node in candidates:
                if node not in out:
                    out.append(node)
                    if len(out) >= m:
                        break
        return out

    def _link(self, a: int, b: int, level: int) -> None:
        neigh = self._neighbors[level]
        cap = self.m0 if level == 0 else self.m
        for x, y in ((a, b), (b, a)):
            lst = neigh.setdefault(x, [])
            if y in lst:
                continue
            lst.append(y)
            if len(lst) > cap:
                # diversity-heuristic prune (plain most-similar severs long-range
                # links and detaches cluster islands)
                sims = self._sim(self._vecs[x], np.asarray(lst))
                order = np.argsort(-sims)
                scored = [(float(sims[i]), lst[i]) for i in order]
                neigh[x] = self._select_neighbors(self._vecs[x], scored, cap)

    # -------------------------------------------------------------------- mutation ----
    def add(self, frame_id: int, vec: np.ndarray) -> None:
        fid = int(frame_id)
        if fid in self._row_of:
            self.remove(fid)
        vec = np.asarray(vec, np.float32).ravel()
        if self.normalize:
            n = np.linalg.norm(vec)
            if n > 0:
                vec = vec / n
        row = self._count
        self._grow(row + 1)
        self._vecs[row] = vec
        self._frame_ids[row] = fid
        self._active[row] = True
        self._row_of[fid] = row
        self._count += 1

        level = int(-math.log(max(self._rng.random(), 1e-12)) * self._ml)
        self._levels[row] = level
        while len(self._neighbors) <= level:
            self._neighbors.append(dict())

        if self._entry < 0:
            self._entry = row
            self._max_level = level
            self.generation += 1
            return

        # greedy descend from the top to level+1
        cur = self._entry
        for lvl in range(self._max_level, level, -1):
            improved = True
            while improved:
                improved = False
                nbrs = [n for n in self._neighbors[lvl].get(cur, ()) if self._active[n]]
                if nbrs:
                    arr = np.asarray(nbrs)
                    s = self._sim(vec, arr)
                    j = int(np.argmax(s))
                    if s[j] > float(self._vecs[cur] @ vec):
                        cur = nbrs[j]
                        improved = True

        # insert with ef_construction beam at each level from min(level, max) down to 0
        entries = [cur]
        for lvl in range(min(level, self._max_level), -1, -1):
            cands = self._search_layer(vec, entries, self.ef_construction, lvl)
            if self.extend_candidates:
                # alg. 4 option: widen the working set with candidates' neighbors so
                # the diversity prune can pick cross-basin links (see __init__ note)
                seen = {n for _, n in cands}
                extended = list(cands)
                for _, c in cands:
                    for nb in self._neighbors[lvl].get(c, ()):
                        if nb not in seen and self._active[nb]:
                            seen.add(nb)
                            extended.append((float(self._vecs[nb] @ vec), nb))
                extended.sort(key=lambda t: -t[0])
                cands = extended
            m = self.m0 if lvl == 0 else self.m
            for nb in self._select_neighbors(vec, cands, m):
                self._link(row, nb, lvl)
            entries = [n for _, n in cands[: self.m]] or entries

        if level > self._max_level:
            self._max_level = level
            self._entry = row
        self.generation += 1

    def add_batch(self, frame_ids, vecs: np.ndarray) -> None:
        vecs = np.asarray(vecs, np.float32)
        for fid, v in zip(np.asarray(frame_ids).tolist(), vecs):
            self.add(int(fid), v)

    def remove(self, frame_id: int) -> bool:
        row = self._row_of.pop(int(frame_id), None)
        if row is None:
            return False
        self._active[row] = False
        self._frame_ids[row] = -1
        if self._entry == row:
            # move the entry to any live node at the highest available level
            live = np.nonzero(self._active)[0]
            if len(live):
                best = live[int(np.argmax(self._levels[live]))]
                self._entry = int(best)
                self._max_level = int(self._levels[best])
            else:
                self._entry, self._max_level = -1, -1
        self.generation += 1
        return True

    def vector(self, frame_id: int) -> np.ndarray | None:
        row = self._row_of.get(int(frame_id))
        return None if row is None else self._vecs[row].copy()

    # -------------------------------------------------------------------- snapshot ----
    def snapshot(self, device_dtype: torch.dtype | None = None, seed_cap: int = 8192,
                 device: str | torch.device | None = None) -> GraphIndex:
        """The current graph as a `GraphIndex` on `device` (None: the current CUDA
        device), its rows stored as `device_dtype` (None keeps f32). The arrays are the
        JAX builder's (`snapshot_arrays`); every field is a copy."""
        device = resolve_device(device)
        g = graph_index_from_numpy(**self.snapshot_arrays(seed_cap), device=device)
        if device_dtype is not None and g.emb.dtype != device_dtype:
            g = GraphIndex(adjacency=g.adjacency, emb=g.emb.to(device_dtype), frame_ids=g.frame_ids, bias=g.bias,
                           entries=g.entries)
        return g

    def snapshot_arrays(self, seed_cap: int = 8192) -> dict[str, np.ndarray]:
        """The snapshot's numpy arrays (`adjacency`, `emb` f32, `frame_ids`, `bias`,
        `entries`), as the JAX builder's snapshot computes them."""
        seed_cap = max(1, int(seed_cap))  # the beam always needs >= 1 entry seed

        n = max(self._count, 1)
        n_pad = ((n + 127) // 128) * 128
        # flatten ALL levels into one fixed-degree adjacency: higher-level (long-range)
        # links first, then level-0 links — the flat graph stays navigable across
        # clusters without data-dependent level descent on device (max degree 2M + M)
        max_deg = self.m0 + self.m
        adj = np.full((n_pad, max_deg), -1, np.int32)
        merged: dict[int, list[int]] = {}
        for lvl in range(len(self._neighbors) - 1, -1, -1):
            for node, nbrs in self._neighbors[lvl].items():
                dst = merged.setdefault(node, [])
                for x in nbrs:
                    if self._active[x] and x not in dst:
                        dst.append(x)
        for node, nbrs in merged.items():
            live = nbrs[:max_deg]
            adj[node, : len(live)] = live
        emb = self._vecs[:n_pad] if self._vecs.shape[0] >= n_pad else np.vstack(
            [self._vecs, np.zeros((n_pad - self._vecs.shape[0], self.dim), np.float32)]
        )
        emb = emb[:n_pad]
        fids = np.full(n_pad, -1, np.int32)
        fids[: self._count] = self._frame_ids[: self._count].astype(np.int32)
        active = np.zeros(n_pad, bool)
        active[: self._count] = self._active[: self._count]
        bias = np.where(active, 0.0, NEG_INF).astype(np.float32)

        # Entry seeds: the level >= 1 net (a coarse navigable net of ~N/m nodes),
        # sampled evenly down to seed_cap, or filled up to it with evenly sampled
        # level-0 rows. The search scores every seed in one small matrix product and
        # starts the beam from the best: dense coarse probing in place of a
        # data-dependent level descent. Seed count is the recall lever on clustered
        # data (scripts/probe_hnsw_seeds.py; recall tables in docs/benchmarks.md).
        def _uniform_sample(arr: np.ndarray, m: int) -> np.ndarray:
            # linspace (not a python stride) hits m exactly: `arr[::len//m+1]`
            # undershoots by up to ~50% just above the cap. Rounding collisions
            # near len(arr)==m shed at most a handful of rows via unique.
            if len(arr) <= m or m <= 0:
                return arr[:max(m, 0)] if m < len(arr) else arr
            idx = np.unique(np.linspace(0, len(arr) - 1, m).round().astype(np.int64))
            return arr[idx]

        if self._count:
            seeds = np.nonzero(self._active[: self._count] & (self._levels[: self._count] >= 1))[0]
            if len(seeds) == 0:
                seeds = np.nonzero(self._active[: self._count])[0][:1]
            elif len(seeds) > seed_cap:
                # level assignment is i.i.d. random, so a uniform sample is unbiased
                seeds = _uniform_sample(seeds, seed_cap)
            elif len(seeds) < seed_cap:
                l0 = np.nonzero(self._active[: self._count] & (self._levels[: self._count] == 0))[0]
                if len(l0):
                    fill = _uniform_sample(l0, seed_cap - len(seeds))
                    seeds = np.concatenate([seeds, fill])
        else:
            seeds = np.zeros(1, np.int64)
        pad = (-len(seeds)) % 8
        if pad:
            seeds = np.concatenate([seeds, np.repeat(seeds[:1], pad)])
        entries = np.asarray(seeds, np.int32)
        return {"adjacency": adj, "emb": emb, "frame_ids": fids, "bias": bias, "entries": entries}

    # -------------------------------------------------------- serialization hooks ----
    def state_arrays(self) -> dict[str, np.ndarray]:
        n = self._count
        flat_neigh = []
        for lvl, neigh in enumerate(self._neighbors):
            for node in sorted(neigh):
                for nb in neigh[node]:
                    flat_neigh.append((lvl, node, nb))
        edges = np.asarray(flat_neigh, np.int64).reshape(-1, 3) if flat_neigh else np.zeros((0, 3), np.int64)
        return {
            "vecs": self._vecs[:n],
            "frame_ids": self._frame_ids[:n],
            "active": self._active[:n],
            "levels": self._levels[:n],
            "edges": edges,
            "meta": np.asarray([self._entry, self._max_level, self.m, self.ef_construction], np.int64),
        }

    @classmethod
    def from_state_arrays(cls, arrays: dict[str, np.ndarray], dim: int, normalize: bool = True) -> "HNSWBuilder":
        entry, max_level, m, efc = arrays["meta"].tolist()
        b = cls(dim=dim, m=int(m), ef_construction=int(efc), normalize=normalize)
        n = arrays["vecs"].shape[0]
        b._grow(max(n, 1))
        b._vecs[:n] = arrays["vecs"]
        b._frame_ids[:n] = arrays["frame_ids"]
        b._active[:n] = arrays["active"]
        b._levels[:n] = arrays["levels"]
        b._count = n
        b._entry = int(entry)
        b._max_level = int(max_level)
        b._row_of = {
            int(fid): i for i, fid in enumerate(arrays["frame_ids"]) if fid >= 0 and arrays["active"][i]
        }
        max_lvl_seen = int(arrays["edges"][:, 0].max()) if len(arrays["edges"]) else 0
        top = max(max_lvl_seen, int(max_level), int(arrays["levels"].max()) if n else 0, 0)
        while len(b._neighbors) <= top:
            b._neighbors.append(dict())
        for lvl, node, nb in arrays["edges"].tolist():
            b._neighbors[int(lvl)].setdefault(int(node), []).append(int(nb))
        return b
