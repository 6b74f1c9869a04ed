"""Corpus rows made from the seed on the card.

Both sides (the program and the reference) are handed what `unit_rows` makes. It is a
copy of `chip_smoke.unit_rows` (`chip_smoke.py:2185-2197`) with its own normalisation.
"""
from __future__ import annotations

import torch

ROW_CHUNK = 1 << 20  # rows drawn at once: no f32 temporary holds more than this many


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one named stream of draws of this seed."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + stream * 7_919) % (2**63 - 1))


def unit_rows(n: int, d: int, seed: int, device, first_row: int = 0, capacity: int | None = None) -> torch.Tensor:
    """Rows first_row .. first_row + n of a seeded corpus of unit rows, bf16 on
    `device`, at the front of `capacity` rows (n by default) whose rest are zero; chunk
    c of the corpus comes from its own generator, so a row is the same whichever block
    of the corpus a card holds."""
    if first_row % ROW_CHUNK:
        raise ValueError("a block of the corpus starts at a multiple of ROW_CHUNK")
    capacity = n if capacity is None else capacity
    out = torch.empty((capacity, d), dtype=torch.bfloat16, device=device)
    out[n:] = 0
    for lo in range(0, n, ROW_CHUNK):
        hi = min(n, lo + ROW_CHUNK)
        g = generator(seed, 1_000 + (first_row + lo) // ROW_CHUNK, device)
        x = torch.randn((hi - lo, d), generator=g, device=device)
        out[lo:hi] = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    return out
