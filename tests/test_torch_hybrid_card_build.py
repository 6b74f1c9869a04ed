"""The lexical index built with torch ops on the postings' device, the fused hybrid
program against the plain reference, and `auto`'s BM25 route on a chunked snapshot.

* `shard_lex_postings`, handed a builder's CSR postings as CPU tensors (and its own
  mean length, `index/lex.mean_doc_len`), equals the JAX package's `shard_lex_index` on the same
  documents (the host path the port's sharded index is held to) in every array of
  every shard, on one and two corpus shards, in four cases: exact postings, a budget
  that truncates, the budget with tombstoned rows, and the budget with a row over
  FWD_WIDTH_CAP. On one shard of the snapshot's row space it equals the port's own
  `LexIndexBuilder.snapshot` arrays too.
* `sharded_hybrid_topk` through the CPU twins (K4 + K3 on a budgeted snapshot with
  impact chunks, and the plain harness) against `reference/hybrid_plain.py` on seeded
  random postings and exact-arithmetic rows: the dense list, the BM25 list and the
  fused list.
* `kernels_take` keeps the TPU's plane guard for a chunked or unbudgeted snapshot on
  a card, and sends a truncated snapshot without chunks (2^23 rows a shard and more)
  to K8's selection mode while that plane fits; `_resolve_lex_backend` asks it on a
  card only.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from portbench.refs.dense import topk_err
from reference import hybrid_plain as ref
from wax_tpu.index.lex import LexIndexBuilder as JaxLex
from wax_tpu.parallel import sharded_hybrid as jsh
from wax_tpu.parallel.mesh import data_mesh as jax_mesh
from wax_tpu_torch.index import lex as tlex
from wax_tpu_torch.index.lex import FWD_WIDTH_CAP
from wax_tpu_torch.index.lex import LexIndexBuilder as TorchLex
from wax_tpu_torch.ops import bm25_lane
from wax_tpu_torch.ops.bm25_candidates_pallas import kernels_take
from wax_tpu_torch.parallel import sharded_hybrid as tsh
from wax_tpu_torch.parallel.mesh import data_mesh as torch_mesh
from wax_tpu_torch.parallel.sharded_scan import ShardedDenseIndex

TOPICS = ["fox", "quantum", "market", "recipe", "rover", "cat", "river", "music"]
N, BUDGET = 1500, 40


def _docs(case):
    rng = np.random.default_rng(11)
    out = []
    for i in range(N):
        words = [TOPICS[i % 8], TOPICS[(i * 5) % 8], "domain" if i % 3 else "detail", str(i % 13)]
        words += list(rng.choice(TOPICS, int(rng.integers(0, 5))))
        out.append((i, " ".join(words)))
    if case == "wide-row":  # one row with more unique terms than the forward index keeps
        out[7] = (7, " ".join([f"w{j}" for j in range(FWD_WIDTH_CAP + 90)] + ["fox fox quantum"]))
        out[9] = (9, "w3 w4 w5 w600 fox")
    return out


def _builders(case):
    budget = None if case == "exact" else BUDGET
    jl, tl = JaxLex(postings_budget=budget), TorchLex(postings_budget=budget)
    docs = _docs(case)
    jl.add_batch(docs)
    tl.add_batch(docs)
    if case == "tombstones":
        for fid in (0, 5, 6, 300, 301, 1499):
            jl.remove(fid)
            tl.remove(fid)
    return jl, tl


def _card_path(tl, mesh, n_rows):
    """`shard_lex_postings` on the builder's postings as CPU tensors, mean length
    computed by the builder function itself."""
    offsets, rows, tfs = (torch.from_numpy(np.array(a)) for a in tl.csr())
    doc_len, frame_ids, active = (torch.from_numpy(a) for a in tl.row_arrays())
    return tsh.shard_lex_postings(mesh, n_rows, offsets, rows, tfs, doc_len, frame_ids, active,
                                  postings_budget=tl.resolve_postings_budget(len(doc_len)))


CASES = ["exact", "budgeted", "tombstones", "wide-row"]


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("case", CASES)
def test_card_builder_equals_host_path(case, shards):
    jl, tl = _builders(case)
    n_rows = tl.row_space()
    js = jsh.shard_lex_index(jl, jax_mesh(shards), n_rows)
    ts = _card_path(tl, torch_mesh(["cpu"] * shards), n_rows)
    offs = np.asarray(js.offsets)
    for s in range(shards):
        p = int(offs[s, -1])
        for f in ("doc_rows", "tfs", "wnorm"):
            np.testing.assert_array_equal(getattr(ts, f)[s].numpy()[:p], np.asarray(getattr(js, f))[s, :p],
                                          err_msg=f"{f} shard {s}")
        for f in ("offsets", "idf", "doc_len", "frame_ids", "live", "row_base", "fwd_tids", "fwd_wnorm",
                  "fwd_fused", "pk_chunks", "chunk_base", "chunk_counts"):
            j, t = getattr(js, f), getattr(ts, f)
            assert (j is None) == (t is None), f
            if j is not None:
                np.testing.assert_array_equal(t[s].numpy(), np.asarray(j)[s], err_msg=f"{f} shard {s}")
    for f in ("max_df", "pk_qb", "pk_max_chunks", "fwd_width"):
        assert getattr(ts, f) == getattr(js, f), f
    assert float(ts.avgdl) == float(np.asarray(js.avgdl))
    assert (ts.pk_chunks is not None) == (case != "exact")
    if case == "wide-row":
        assert ts.fwd_width == FWD_WIDTH_CAP
    if shards == 1:  # one shard over the snapshot's row space is the snapshot itself
        snap = tl.snapshot(device="cpu")
        for f, g in (("doc_rows", "doc_rows"), ("tfs", "tfs"), ("offsets", "offsets"), ("idf", "idf"),
                     ("doc_len", "doc_len"), ("frame_ids", "frame_ids"), ("live", "active"), ("wnorm", "wnorm"),
                     ("fwd_tids", "fwd_tids"), ("fwd_wnorm", "fwd_wnorm"), ("fwd_fused", "fwd_fused"),
                     ("pk_chunks", "pk_chunks"), ("chunk_base", "chunk_base"), ("chunk_counts", "chunk_counts")):
            t, want = getattr(ts, f), getattr(snap, g)
            assert (t is None) == (want is None), f
            if want is not None:
                assert torch.equal(t[0][: want.shape[0]], want), f
        for f in ("max_df", "pk_qb", "pk_max_chunks", "fwd_width"):
            assert getattr(ts, f) == getattr(snap, f), f
        assert torch.equal(ts.avgdl, snap.avgdl)


@pytest.mark.parametrize("case", ["exact", "budgeted"])
def test_shard_view_is_the_snapshot(case):
    """On a one-shard mesh over the snapshot's row space, `ShardedLexIndex.shard(0)`,
    the view every shard's BM25 lane runs on, is `LexIndexBuilder.snapshot()`: every
    field equal, tensors bit for bit in dtype, shape and bytes."""
    _, tl = _builders(case)
    view = tsh.shard_lex_index(tl, torch_mesh("cpu"), tl.row_space()).shard(0)
    snap = tl.snapshot(device="cpu")
    assert (snap.fwd_tids is None) == (case == "exact")
    for f in dataclasses.fields(tlex.LexIndex):
        got, want = getattr(view, f.name), getattr(snap, f.name)
        if torch.is_tensor(want):
            assert got.dtype == want.dtype and got.shape == want.shape, f.name
            assert got.numpy().tobytes() == want.numpy().tobytes(), f.name
        else:
            assert got == want, f.name


# ------------------------------------------------- the program against the reference

ND, D, T = 3000, 16, 600


def _postings(seed):
    """Seeded random CSR postings (Zipf-like terms, lengths 3-40, repeats as tf)."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(3, 41, ND)
    row = np.repeat(np.arange(ND), lens)
    p = 1.0 / np.arange(1, T + 1)
    tid = rng.choice(T, size=row.shape[0], p=p / p.sum())
    key, tf = np.unique(row * T + tid, return_counts=True)
    r, t = key // T, key % T
    order = np.argsort(t, kind="stable")
    offsets = np.zeros(T + 1, np.int64)
    offsets[1:] = np.cumsum(np.bincount(t, minlength=T))
    return (torch.from_numpy(offsets), torch.from_numpy(r[order].astype(np.int32)),
            torch.from_numpy(tf[order].astype(np.int32)), torch.from_numpy(lens.astype(np.float32)))


def _queries(seed, b=12):
    rng = np.random.default_rng(seed + 1)
    q = (rng.integers(-4, 5, (b, D)) / 4.0).astype(np.float32)
    tids = np.full((b, 16), -1, np.int32)
    for i in range(b):
        n = int(rng.integers(1, 9))
        p = 1.0 / np.arange(1, T + 1)
        t = rng.choice(T, size=n, replace=False, p=p / p.sum())
        tids[i, :n] = t
    return torch.from_numpy(q), torch.from_numpy(tids)


@pytest.mark.parametrize("shards", [1, 2])
@pytest.mark.parametrize("budget,backend", [(None, "candidates"), (100, "candidates"), (100, "candidates_pallas")])
def test_hybrid_matches_plain_reference(monkeypatch, budget, backend, shards):
    seed = 5
    offsets, rows, tfs, dl = _postings(seed)
    rows_emb = torch.from_numpy((np.random.default_rng(seed + 2).integers(-4, 5, (ND, D)) / 4.0).astype(np.float32))
    mesh = torch_mesh(["cpu"] * shards)
    active = torch.ones(ND, dtype=torch.bool)
    ids = torch.arange(ND, dtype=torch.int32)
    lex = tsh.shard_lex_postings(mesh, ND, offsets, rows, tfs, dl, ids, active, postings_budget=budget)
    assert (lex.pk_chunks is not None) == (budget is not None)
    per = ND // shards
    dense = ShardedDenseIndex(emb=tuple(rows_emb[s * per:(s + 1) * per] for s in range(shards)),
                              frame_ids=tuple(ids[s * per:(s + 1) * per] for s in range(shards)),
                              bias=tuple(torch.zeros(per) for _ in range(shards)), contiguous=False)
    merged = []
    merge = tsh.merge_topk_across_mesh

    def keep(*a, **kw):
        out = merge(*a, **kw)
        merged.append(tuple(x.numpy() for x in out))
        return out

    monkeypatch.setattr(tsh, "merge_topk_across_mesh", keep)
    q, tids = _queries(seed)
    k, fetch = 5, 16
    fv, fi = tsh.sharded_hybrid_topk(q, tids, dense, lex, k, mesh, w_dense=0.7, w_bm25=0.3, rrf_k=60.0,
                                     lex_backend=backend)
    (dv, di), (lv, li) = merged
    rv, _ = ref.dense_topk(q, rows_emb, fetch)
    assert topk_err(dv, di, rv, ref.dense_score_of(q, rows_emb, di)) == 0.0
    bm25 = ref.PlainBM25(offsets, rows, tfs, dl, active)
    recall = []
    for j in range(q.shape[0]):
        s = bm25.scores(tids[j].numpy())
        live = li[j] >= 0
        exact = s[torch.from_numpy(li[j][live]).long()].numpy()
        np.testing.assert_allclose(lv[j][live], exact, rtol=2e-6, atol=0)
        top = torch.topk(s, 10).values.numpy()
        top = top[top > 0]
        if len(top):
            recall.append(min(int(np.sum(exact[:10] >= top[-1] * (1 - 1e-12))), len(top)) / len(top))
    assert np.mean(recall) >= (1.0 if budget is None else 0.97), recall
    rrf_v, rrf_i = ref.rrf(di, li, 2 * fetch, 0.7, 0.3, 60.0)
    of = np.array([[dict(zip(rrf_i[j].tolist(), rrf_v[j])).get(int(x), np.nan) for x in fi[j]]
                   for j in range(len(fi))])
    assert topk_err(fv.numpy(), fi.numpy(), rrf_v[:, :k], of) < 1e-7
    want_v, want_i = ref.rrf(di, li, k, 0.7, 0.3, 60.0)
    np.testing.assert_array_equal(fi.numpy(), want_i)


# ------------------------------------------------------------------------ routing


def test_auto_routes_chunked_snapshots_to_k4():
    """On a card, `auto` routes a snapshot with impact chunks (K4 + K3) or without a
    budget as the TPU does: the kernels while the plane guard passes, else the plain
    harness. A truncated snapshot without chunks (2^23 rows a shard and more) takes
    the kernels, K8 in its selection mode, while that plane fits and K8 has a slot for
    every term. CPU postings take the plain harness."""
    _, tl = _builders("budgeted")
    ts = tsh.shard_lex_index(tl, torch_mesh("cpu"), tl.row_space())
    assert ts.pk_chunks is not None and ts.pk_qb >= 8 and tsh._resolve_lex_backend(ts, "auto") == "candidates"
    card = dataclasses.replace(ts, doc_rows=(types.SimpleNamespace(device=torch.device("cuda")),))
    assert tsh._resolve_lex_backend(card, "auto", q2=16) == "candidates_pallas"
    chunked = ts.shard(0)
    for max_df, q, want in ((128, 16, True), (30_720, 16, True), (32_768, 16, False), (200_000, 16, False),
                            (128, 256, True), (128, 512, False)):
        assert kernels_take(dataclasses.replace(chunked, max_df=max_df), q) == want
    unchunked = dataclasses.replace(chunked, pk_chunks=None, chunk_base=None, chunk_counts=None, pk_qb=0)
    for max_df, q, want in ((34_560, 16, True), (65_536, 16, True), (262_144, 16, True), (524_288, 16, False),
                            (34_560, 128, True), (34_560, 256, False), (1_024, 1_024, True), (1_024, 2_048, False)):
        assert kernels_take(dataclasses.replace(unchunked, max_df=max_df), q) == want
    exact = dataclasses.replace(unchunked, fwd_tids=None, fwd_wnorm=None, fwd_fused=None)
    assert kernels_take(exact, 16) and not kernels_take(dataclasses.replace(exact, max_df=65_536), 16)
    assert tsh._resolve_lex_backend(dataclasses.replace(card, max_df=200_000), "candidates_pallas") == \
        "candidates_pallas"


def test_coarse_chunks_generate_with_k8(monkeypatch):
    """A shard whose chunks would keep fewer than `PK_MIN_QB` packed bits gets none
    (here the floor is raised past every shard's bits) and every other array as
    before; its kernel lane generates candidates with K8's exact sums (its plain twin
    here) and never K4, and answers as the same lane on the chunked snapshot with its
    chunks taken out."""
    _, tl = _builders("budgeted")
    mesh = torch_mesh("cpu")
    ts = tsh.shard_lex_index(tl, mesh, tl.row_space())
    monkeypatch.setattr(tlex, "PK_MIN_QB", 13)
    coarse = tsh.shard_lex_index(tl, mesh, tl.row_space())
    assert coarse.pk_chunks is None and coarse.chunk_base is None and coarse.pk_qb == 0 and coarse.fwd_tids is not None
    for f in ("doc_rows", "tfs", "offsets", "idf", "wnorm", "fwd_tids", "fwd_wnorm", "fwd_fused"):
        assert torch.equal(getattr(coarse, f)[0], getattr(ts, f)[0]), f
    tids = torch.full((4, 16), -1, dtype=torch.int32)
    tids[:, :3] = torch.tensor(tl.term_ids(["fox", "quantum", "detail", "market", "cat", "7"])[:3])
    tids[1, :2] = torch.tensor(tl.term_ids(["river", "music"]))
    want = tsh.sharded_bm25_topk(tids, dataclasses.replace(ts, pk_chunks=None), 10, mesh,
                                 backend="candidates_pallas")

    def no_k4(*a, **k):
        raise AssertionError("K4 ran without chunks")

    monkeypatch.setattr(bm25_lane, "chunked_candidates_sel", no_k4)
    got = tsh.sharded_bm25_topk(tids, coarse, 10, mesh, backend="candidates_pallas")
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]) and (got[1][:, 0] >= 0).all()


def test_benchmark_copy_of_the_reference_is_verbatim():
    """The benchmark holds its own copy of the plain reference (`portbench/refs/`),
    byte for byte this one."""
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    assert (root / "portbench/refs/hybrid.py").read_bytes() == (root / "reference/hybrid_plain.py").read_bytes()
