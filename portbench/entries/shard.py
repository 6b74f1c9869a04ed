"""The corpus-sharded flat scan: `parallel/sharded_scan.sharded_flat_scan_topk` on a
`data_mesh` of one shard a card, each card's exact local top-k, then the merge on the
lead card (`parallel/merge.py`).

The rows of card c are rows c * per .. (c + 1) * per of one seeded corpus, drawn on
that card. The check reads each card's local list from the program's
`merge_topk_across_mesh` call of the checked batches (a tap) and holds it against the
exact top-k of that card's rows (`card_err`), and the merged list against the exact
top-k over the whole corpus (`shard_err`), which a merge that drops or misorders a
card's entries fails.
"""
from __future__ import annotations

import numpy as np
import torch

from portbench.data import unit_rows
from portbench.refs.dense import dense_score_of, dense_topk, topk_err
from portbench.roofline import Work
from wax_tpu_torch.parallel.mesh import data_mesh
from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex, sharded_flat_scan_topk

TAPS = (("wax_tpu_torch.parallel.sharded_scan", "merge_topk_across_mesh"),)
CHECKS = ("card_err", "shard_err")


def merge_lists(vals: list, ids: list, k: int):
    """Stable merge of score-descending lists [B, kk] in list order: (vals, ids) [B, k]."""
    av, ai = np.concatenate(vals, 1), np.concatenate(ids, 1)
    order = np.argsort(-av, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(av, order, 1), np.take_along_axis(ai, order, 1)


class Entry:
    def __init__(self, cfg: dict, workload: dict, seed: int, devices: list):
        self.k = int(workload["k"])
        n, d, s = int(cfg["rows"]), int(cfg["dim"]), int(cfg["shards"])
        if len(devices) != s or n % s:
            raise ValueError(f"{s} shards of {n} rows need {s} devices, got {len(devices)}")
        self.per = n // s
        self.blocks = [unit_rows(self.per, d, seed, dev, first_row=c * self.per) for c, dev in enumerate(devices)]
        self._mesh = data_mesh(list(devices))
        self._index = ShardedDenseIndex(
            emb=tuple(self.blocks),
            frame_ids=tuple(torch.arange(c * self.per, (c + 1) * self.per, dtype=torch.int32, device=b.device)
                            for c, b in enumerate(self.blocks)),
            bias=tuple(torch.zeros(self.per, device=b.device) for b in self.blocks), contiguous=True)

    def call(self, batch: dict):
        return sharded_flat_scan_topk(batch["queries"], self._index, self.k, self._mesh)

    def free_program(self) -> None:
        self._index = None

    def compare(self, batch: dict, pick: np.ndarray, merged, local) -> dict:
        q = batch["queries"][torch.as_tensor(pick, device=batch["queries"].device)]
        card_err, ref_v, ref_i = 0.0, [], []
        for c, (rows, (lv, li)) in enumerate(zip(self.blocks, local)):
            rv, ri = dense_topk(q, rows, self.k, first_id=c * self.per)
            ref_v.append(rv)
            ref_i.append(ri)
            card_err = max(card_err, topk_err(lv, li, rv, dense_score_of(q, rows, li, first_id=c * self.per)))
        mv, mi = merged
        gv, _ = merge_lists(ref_v, ref_i, self.k)
        of_glob = np.full(mi.shape, np.nan)
        for c, rows in enumerate(self.blocks):
            own = (mi >= c * self.per) & (mi < (c + 1) * self.per)
            of_glob = np.where(own, dense_score_of(q, rows, np.where(own, mi, -1), first_id=c * self.per), of_glob)
        return {"card_err": card_err, "shard_err": topk_err(mv, mi, gv, of_glob)}

    def check(self, batch: dict, outputs, taps: dict, pick: np.ndarray) -> dict:
        seen = taps[TAPS[0][1]]
        if len(seen) != 1:
            raise RuntimeError(f"expected one merge across the mesh in a call, saw {len(seen)}")
        args, _ = seen[0]
        vals, fids = args[0], args[1]
        local = [(v.cpu().numpy()[pick].astype(np.float64), f.cpu().numpy()[pick]) for v, f in zip(vals, fids)]
        return self.compare(batch, pick, tuple(np.asarray(x)[pick] for x in outputs), local)

    def control(self, batch: dict, pick: np.ndarray) -> dict:
        q = batch["queries"][torch.as_tensor(pick, device=batch["queries"].device)]
        local = [dense_topk(q, rows, self.k, first_id=c * self.per, precision="bf16")
                 for c, rows in enumerate(self.blocks)]
        return self.compare(batch, pick, merge_lists([v for v, _ in local], [i for _, i in local], self.k), local)

    def card_work(self, b: int) -> Work:
        """One card's share of a batch: its rows read once, the queries, its local list
        written; its bf16 products."""
        d = self.blocks[0].shape[1]
        return Work(self.per * d * 2 + b * d * 4 + b * self.k * 8, {"bf16": 2 * b * self.per * d})

    def work(self, batch: dict) -> dict:
        card = self.card_work(batch["queries"].shape[0])
        return {"card_bytes_ms": Work(card.nbytes).least_ms(), "batch_ms": card.least_ms()}
