"""Weighted Reciprocal Rank Fusion (host).

Port of `rrf_fuse` from wax_tpu/ops/fusion.py, unchanged: each lane contributes
weight / (rrf_k + rank) per hit (rank is 1-based), and fused results order by
(rrf score desc, best lane rank asc, frame_id asc). The device variant
`rrf_fuse_device` has no caller in the JAX package and is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Mapping, Sequence

__all__ = ["FusedHit", "rrf_fuse", "DEFAULT_RRF_K"]

DEFAULT_RRF_K = 60.0


@dataclass(frozen=True)
class FusedHit:
    frame_id: int
    score: float
    best_rank: int
    lane_ranks: dict[str, int]
    lane_scores: dict[str, float]

    @property
    def sources(self) -> tuple[str, ...]:
        return tuple(sorted(self.lane_ranks))


def rrf_fuse(
    lanes: Mapping[str, Sequence[tuple[int, float]]],
    weights: Mapping[str, float],
    rrf_k: float = DEFAULT_RRF_K,
    top_k: int | None = None,
) -> list[FusedHit]:
    """Fuse ranked lanes of (frame_id, lane_score) into a single deterministic list.

    Hits with frame_id < 0 are ignored. A lane absent from `weights` gets weight 0
    (still recorded in diagnostics). Duplicate frame ids within one lane keep their
    best (first) rank.
    """
    acc: dict[int, FusedHit] = {}
    for lane_name in sorted(lanes):
        w = float(weights.get(lane_name, 0.0))
        seen: set[int] = set()
        rank = 0
        for fid, lane_score in lanes[lane_name]:
            fid = int(fid)
            if fid < 0 or fid in seen:
                continue
            seen.add(fid)
            rank += 1
            inc = w / (rrf_k + rank)
            prev = acc.get(fid)
            if prev is None:
                acc[fid] = FusedHit(
                    frame_id=fid,
                    score=inc,
                    best_rank=rank,
                    lane_ranks={lane_name: rank},
                    lane_scores={lane_name: float(lane_score)},
                )
            else:
                lane_ranks = dict(prev.lane_ranks)
                lane_ranks[lane_name] = rank
                lane_scores = dict(prev.lane_scores)
                lane_scores[lane_name] = float(lane_score)
                acc[fid] = FusedHit(
                    frame_id=fid,
                    score=prev.score + inc,
                    best_rank=min(prev.best_rank, rank),
                    lane_ranks=lane_ranks,
                    lane_scores=lane_scores,
                )
    out = sorted(acc.values(), key=lambda h: (-h.score, h.best_rank, h.frame_id))
    return out[:top_k] if top_k is not None else out
