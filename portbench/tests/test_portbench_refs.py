"""The plain references against brute force at tiny sizes, and the comparison of top-k
lists."""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench.refs.dense import DEAD, chunk_topk, dense_score_of, dense_topk, topk_err


def _rows(n, d, seed):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn((n, d), generator=g)
    return (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)


def test_dense_topk_equals_brute_force(monkeypatch):
    monkeypatch.setattr("portbench.refs.dense.BLOCK_ROWS", 256)  # several blocks merge
    rows, q = _rows(1000, 16, 1), _rows(5, 16, 2).float()
    s = q.double().numpy() @ rows.double().numpy().T
    want = np.argsort(-s, axis=1, kind="stable")[:, :7]
    vals, ids = dense_topk(q, rows, 7, first_id=50)
    assert np.array_equal(ids - 50, want)
    assert np.allclose(vals, np.take_along_axis(s, want, 1), rtol=0, atol=1e-12)
    assert np.allclose(dense_score_of(q, rows, ids, first_id=50), vals, rtol=0, atol=1e-12)
    assert np.isnan(dense_score_of(q, rows, np.full((5, 1), -1))).all()
    chunks = chunk_topk(q, rows[:896], 3)
    cmax = s[:, :896].reshape(5, 7, 128).max(2)
    assert np.array_equal(np.sort(chunks, 1), np.sort(np.argsort(-cmax, 1)[:, :3], 1))


def test_dense_topk_bf16_control_rounds_scores():
    rows, q = _rows(512, 64, 3), _rows(4, 64, 4).float()
    exact, _ = dense_topk(q, rows, 5)
    low, _ = dense_topk(q, rows, 5, precision="bf16")
    assert 0 < np.abs(low - exact).max() < 1e-2


def test_topk_err_reads_swaps_gaps_and_faults():
    r = np.array([[0.9, 0.8, 0.8, 0.5]])
    of = {1: 0.9, 2: 0.8, 3: 0.8, 4: 0.5, 5: 0.4}
    score = lambda ids: np.array([[of.get(int(i), np.nan) for i in row] for row in ids])
    same = np.array([[1, 3, 2, 4]])  # a tie swapped
    assert topk_err(r, same, r, score(same)) == 0.0
    missing = np.array([[1, 2, 3, 5]])
    assert math.isclose(topk_err(np.array([[0.9, 0.8, 0.8, 0.4]]), missing, r, score(missing)), 0.1)
    lying = np.array([[0.9, 0.8, 0.8, 0.5]])  # claims 0.5 for the 0.4 document
    assert math.isclose(topk_err(lying, missing, r, score(missing)), 0.1)
    assert topk_err(r, np.array([[1, 1, 2, 4]]), r, score(np.array([[1, 1, 2, 4]]))) == math.inf
    short = np.array([[0.9, 0.8, 0.8, DEAD]])
    assert topk_err(short, np.array([[1, 2, 3, -1]]), r, score(np.array([[1, 2, 3, -1]]))) == math.inf
