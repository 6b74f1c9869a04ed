"""The one traffic generator: batch i of a workload, made on the device from the seed.

A workload file (`workloads/<cell>.json`) gives the batch size (`batch`); the
configuration gives the queries' width (`dim`). A query is a unit vector rounded to
bf16 (the embedder serves bf16) and handed over as f32. Batch i depends only on
(seed, i), so the reference makes it again for the batches it checks, and every seed
gives the same sizes in another draw.
"""
from __future__ import annotations

import torch

from portbench.data import generator


def make_batch(workload: dict, cfg: dict, seed: int, i: int, device) -> dict:
    """Batch i: {"queries": [B, d] f32 unit rows (bf16 values)}."""
    b, d = int(workload["batch"]), int(cfg["dim"])
    g = generator(seed, 10_000_000 + i, device)
    x = torch.randn((b, d), generator=g, device=device)
    return {"queries": (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16).float()}
