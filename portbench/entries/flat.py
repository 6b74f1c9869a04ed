"""The exact flat lane: `ops/flat_scan.flat_scan_topk(backend="auto")` over a contiguous
`index/dense.DenseIndex`, which routes a corpus of 524,288 rows or more, at a capacity
that is a multiple of 2,048, to chunkmax (K6 chunk maxima, then K7 rescoring the best
chunks). The index holds the corpus's rows at the front of a capacity rounded up to
2,048 rows; the rows past them are padding, which the index marks inactive.

The check holds the returned top-k against the exact top-k over every live row: a
wrong chunk choice of K6 shows there as a missing member.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data import unit_rows
from portbench.refs.dense import chunk_topk, dense_score_of, dense_topk, topk_err
from portbench.roofline import Work, k6_work, k7_work
from wax_tpu_torch.index.dense import DenseIndex
from wax_tpu_torch.ops.flat_scan import flat_scan_topk

TAPS = ()
CHECKS = ("flat_err",)
ALIGN = 2048  # rows: the chunkmax lane's alignment of the index's capacity


class Entry:
    def __init__(self, cfg: dict, workload: dict, seed: int, devices: list):
        self.k = int(workload["k"])
        dev = devices[0]
        n = int(cfg["rows"])
        cap = -(-n // ALIGN) * ALIGN
        self.emb = unit_rows(n, int(cfg["dim"]), seed, dev, capacity=cap)
        self.rows = self.emb[:n]
        ids = torch.arange(cap, dtype=torch.int32, device=dev)
        self._index = DenseIndex(emb=self.emb, frame_ids=torch.where(ids < n, ids, -1), active=ids < n,
                                 count=torch.tensor(n, dtype=torch.int32, device=dev), contiguous=True)

    def call(self, batch: dict):
        vals, _, fids = flat_scan_topk(batch["queries"], self._index, self.k, backend="auto")
        return vals, fids

    def free_program(self) -> None:
        self._index = None

    def compare(self, batch: dict, pick: np.ndarray, out) -> dict:
        q = batch["queries"][torch.as_tensor(pick, device=batch["queries"].device)]
        rv, _ = dense_topk(q, self.rows, self.k)
        pv, pi = out
        return {"flat_err": topk_err(pv, pi, rv, dense_score_of(q, self.rows, pi))}

    def check(self, batch: dict, outputs, taps: dict, pick: np.ndarray) -> dict:
        return self.compare(batch, pick, tuple(np.asarray(x)[pick] for x in outputs))

    def control(self, batch: dict, pick: np.ndarray) -> dict:
        q = batch["queries"][torch.as_tensor(pick, device=batch["queries"].device)]
        return self.compare(batch, pick, dense_topk(q, self.rows, self.k, precision="bf16"))

    def work(self, batch: dict) -> dict:
        """K6 over the index's capacity, as it is handed; the batch's least work over the
        live rows."""
        q = batch["queries"]
        b, d = q.shape
        n, cap = self.rows.shape[0], self.emb.shape[0]
        distinct = int(np.unique(chunk_topk(q, self.emb, self.k)).size)
        k7 = k7_work(b, self.k, cap // 128, d, 2, self.k, distinct * 128, b * self.k * 128)
        batch_work = Work(n * d * 2 + b * d * 4 + b * self.k * 8, {"bf16": 2 * b * n * d, "fp32": k7.ops["fp32"]})
        return {"K6": k6_work(b, cap, d, 2), "K7": k7, "batch_ms": batch_work.least_ms()}
