"""Plain models of the schedules of kernels K4 and K7, held against torch and the twins.

The CUDA kernels run only on a card. These models replay, in torch on the CPU, the
order in which the kernels move and compare values, so that a fault of the schedule
(a stage on the wrong partner, a wrong sort direction, an address map that is not one
to one or not conflict-free, a tie taken in the wrong order) shows here:

* K4 (`csrc/bm25_chunked.cu`, 32 slots): T = 32768 / V threads of V values each; the
  bitonic levels with their stages in columnar, warp-columnar or blocked registers,
  descending warps on complemented values; the layout changes through the padded
  shared plane; then the column walk. Held against `torch.sort` and `_chunked_sel_plain` on impact chunks
  built by the JAX package's `build_impact_chunks`.
* K7 (`csrc/ivf_kernel.cu`): warps that take slabs of rows in turn, each keeping a
  sorted list of its best keys and merging only rows that beat its k-th, then the
  warps' lists merged. Held against `stable_top_k`, with ties at the k-th value that
  fall in different warps and different probes.
"""
import numpy as np
import pytest
import torch

from wax_tpu.index import lex as jlex
from wax_tpu_torch.index.lex import PK_CHUNK
from wax_tpu_torch.ops import bm25_chunked_pallas as ck
from wax_tpu_torch.ops import ivf_kernel as ivf
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k

N32 = 32 * PK_CHUNK

# ------------------------------------------------------------------------------- K4


def pad(i):
    """The shared-plane word of plane position i: rows of 32 positions padded to 33."""
    return i + (i >> 5)


def _cas(regs, lo, hi, asc):
    """Compare-exchange of register columns lo[j] and hi[j]; the lower index keeps the
    minimum where asc (a bool tensor broadcast over the rest)."""
    a, b = regs[..., lo], regs[..., hi]
    mn, mx = torch.minimum(a, b), torch.maximum(a, b)
    regs[..., lo] = torch.where(asc, mn, mx)
    regs[..., hi] = torch.where(asc, mx, mn)


def k4_layouts(v: int):
    """[T, V] plane positions of thread t's register r in the columnar, warp-columnar and
    blocked layouts."""
    t_n = N32 // v
    t = torch.arange(t_n)[:, None]
    r = torch.arange(v)[None, :]
    return r * t_n + t, (t // 32) * 32 * v + r * 32 + t % 32, t * v + r


def k4_merge_model(win, pk, v: int):
    """K4's gather and merge for 32 slots with v values per thread, through the padded
    shared plane. Returns (the plane in logical order, the stage log [(level, d,
    place)], the block barrier count)."""
    t_n = N32 // v
    b = win.shape[0]
    col, wcol, blk = k4_layouts(v)
    ch, o = col // PK_CHUNK, col % PK_CHUNK
    regs = pk[win.long()[:, ch] * PK_CHUNK + torch.where(ch % 2 == 1, PK_CHUNK - 1 - o, o)]  # odd chunks reversed
    assert torch.equal(pad(col), pad(col[:, :1]) + torch.arange(v)[None, :] * (t_n + t_n // 32))
    assert torch.equal(pad(wcol), (torch.arange(t_n)[:, None] // 32) * 33 * v + torch.arange(t_n)[:, None] % 32
                       + torch.arange(v)[None, :] * 33)
    assert torch.equal(pad(blk), pad(blk[:, :1]) + pad(torch.arange(v))[None, :])  # the kernel's address forms
    for lay in (wcol, blk):  # a warp's own positions in both warp layouts
        assert torch.equal(torch.sort(lay.reshape(-1, 32 * v), dim=1).values,
                           torch.sort(wcol.reshape(-1, 32 * v), dim=1).values)
    plane = torch.empty((b, N32 + N32 // 32), dtype=pk.dtype)
    t = torch.arange(t_n)[:, None]
    stages, barriers = [], 0
    for lvl in range(5):
        k = 2048 << lvl
        d = k // 2
        while d >= 32 * v:  # columnar registers c and c ^ d / T
            m = d // t_n
            lo = [x for x in range(v) if not x & m]
            _cas(regs, lo, [x | m for x in lo], torch.tensor([(x * t_n) & k == 0 for x in lo]))
            stages.append((lvl, d, "columnar registers"))
            d //= 2
        plane[:, pad(col).reshape(-1)] = regs.reshape(b, -1)
        barriers += 1
        flip = torch.where(((t * v) & k) != 0, -1, 0).to(pk.dtype)  # [T, 1]: one value per warp
        assert (flip.reshape(-1, 32) == flip.reshape(-1, 32)[:, :1]).all()
        regs = plane[:, pad(wcol)] ^ flip  # a descending warp sorts the complements ascending
        asc = torch.tensor(True)
        while d >= 32:  # warp-columnar registers r and r ^ d / 32
            m = d // 32
            lo = [x for x in range(v) if not x & m]
            _cas(regs, lo, [x | m for x in lo], asc)
            stages.append((lvl, d, "warp-columnar registers"))
            d //= 2
        plane[:, pad(wcol).reshape(-1)] = regs.reshape(b, -1)  # the warp's own positions: a __syncwarp
        regs = plane[:, pad(blk)]
        while d >= 1:  # blocked registers r and r ^ d
            lo = [x for x in range(v) if not x & d]
            _cas(regs, lo, [x | d for x in lo], asc)
            stages.append((lvl, d, "blocked registers"))
            d //= 2
        plane[:, pad(blk).reshape(-1)] = (regs ^ flip).reshape(b, -1)
        barriers += 1
        if lvl < 4:
            regs = plane[:, pad(col)]
    return plane[:, pad(torch.arange(N32))], stages, barriers


def k4_walk_model(x, qb: int, seg_log2: int, mode: str, sel: int):
    """Steps 3-5 as K4's threads run them: thread p walks column p of the sorted plane
    x [B, N] (vectorised over queries and columns)."""
    b, n = x.shape
    slots = n // PK_CHUNK
    qmask = (1 << qb) - 1
    xl = x.long()
    rows, q = xl >> qb, xl & qmask
    live_at = (xl != 2**31 - 1) & (q > 0)
    tops = torch.full((b, sel, PK_CHUNK), -(2**31), dtype=torch.long)
    pays = torch.full((b, sel, PK_CHUNK), -1, dtype=torch.long)
    for c in range(slots):
        i = c * PK_CHUNK + torch.arange(PK_CHUNK)
        row = rows[:, i]
        nxt = rows[:, torch.clamp(i + 1, max=n - 1)]
        leader = (i == n - 1) | (nxt != row)
        vsum = torch.zeros_like(row)
        csum = torch.zeros_like(row)
        going = torch.ones_like(row, dtype=bool)
        for back in range(1 << seg_log2):
            jj = i - back
            ok = jj >= 0
            jc = torch.clamp(jj, min=0)
            going = going & ok & (rows[:, jc] == row)
            add = going & live_at[:, jc]
            vsum += torch.where(add, q[:, jc], 0)
            csum += add.long()
        take = leader & live_at[:, i] & (vsum > 0)
        rank = csum * 65536 + torch.clamp(vsum, max=65535) if mode == "count" else vsum
        tk = torch.where(take, rank * 128 + (127 - c), -(2**31))
        tr = torch.where(take, row, -1)
        for lvl in range(sel):  # strict '>' insertion
            better = tk > tops[:, lvl]
            t0, r0 = tops[:, lvl].clone(), pays[:, lvl].clone()
            tops[:, lvl] = torch.where(better, tk, t0)
            pays[:, lvl] = torch.where(better, tr, r0)
            tk, tr = torch.where(better, t0, tk), torch.where(better, r0, tr)
    return pays.reshape(b, -1).to(torch.int32), tops.reshape(b, -1).to(torch.int32)


def _impact_chunks(seed: int, sizes, n_rows: int):
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.sort(rng.choice(n_rows, m, replace=False)) for m in sizes]).astype(np.int32)
    wn = (rng.integers(1, 30, len(rows)) / 8.0).astype(np.float64)
    wn[rng.random(len(rows)) < 0.02] = 0.0  # tombstoned postings
    offsets = np.zeros(len(sizes) + 1, np.int64)
    offsets[1:] = np.cumsum(sizes)
    idf = (rng.integers(1, 9, len(sizes)) / 4.0).astype(np.float64)
    n_cap = -(-n_rows // 128) * 128
    pk, _, cb, cc, qb = jlex.build_impact_chunks(rows, wn, offsets, idf, n_cap)
    return torch.from_numpy(np.asarray(pk)), torch.from_numpy(np.asarray(cb)), torch.from_numpy(np.asarray(cc)), qb


def _k4_case(case: str):
    """(win [B, 32], pk, qb, seg_log2) of the JAX package's impact chunks."""
    if case == "repeat":  # one row set in every slot: runs of 32 equal rows, the full window
        rng = np.random.default_rng(3)
        base = np.sort(rng.choice(6000, 1000, replace=False))
        rows = np.concatenate([base] * 32).astype(np.int32)
        wn = (rng.integers(1, 30, len(rows)) / 8.0).astype(np.float64)
        offsets = np.arange(33, dtype=np.int64) * 1000
        idf = (rng.integers(1, 9, 32) / 4.0).astype(np.float64)
        pk, _, cb, cc, qb = jlex.build_impact_chunks(rows, wn, offsets, idf, 6016)
        pk, cb, cc = (torch.from_numpy(np.asarray(a)) for a in (pk, cb, cc))
        tids = torch.arange(32, dtype=torch.int32)[None, :].repeat(2, 1)
        tids[1, 20:] = -1  # dead slots: the sentinel block
        return ck.pack_query_chunks(tids, cb, cc, 32, int(cc.max()), pk.shape[0] // PK_CHUNK - 1), pk, qb, 5
    heavy = [3900, 3500, 3100, 2900, 2500, 2200, 2100, 1500]
    rng = np.random.default_rng(7)
    sizes = np.concatenate([heavy, rng.integers(1, 1000, 16)])
    pk, cb, cc, qb = _impact_chunks(7, sizes, 6000)
    n_terms = {"serving": 16, "sentinel": 5}[case]
    tids = torch.from_numpy(np.stack([rng.choice(24, n_terms, replace=False) for _ in range(3)]).astype(np.int32))
    if case == "serving":
        tids[0] = torch.arange(16)  # 34 live chunks for 32 slots: two are dropped
    tids[1, -1] = -1
    win = ck.pack_query_chunks(tids, cb, cc, 32, int(cc.max()), pk.shape[0] // PK_CHUNK - 1)
    seg = max(1, int(np.ceil(np.log2(2 * n_terms))))
    return win, pk, qb, seg


@pytest.mark.parametrize("v", [32, 64])
@pytest.mark.parametrize("case", ["serving", "sentinel", "repeat"])
def test_k4_schedule_sorts_and_equals_plain(case, v):
    """The register/shuffle/shared-plane schedule sorts every query's plane as
    torch.sort does, and its column walk gives `_chunked_sel_plain`'s rows and keys in
    both modes: 16-term queries, 5-term ones with the sentinel block in their windows,
    and a row set repeated in all 32 slots (runs at the full 2^seg_log2 window)."""
    win, pk, qb, seg = _k4_case(case)
    if case == "sentinel":
        assert (win == pk.shape[0] // PK_CHUNK - 1).any()
    x, stages, barriers = k4_merge_model(win, pk, v)
    want, _ = torch.sort(pk.reshape(-1, PK_CHUNK)[win.long()].reshape(win.shape[0], -1), dim=-1)
    assert torch.equal(x, want)
    if case == "repeat":
        rows = x.long() >> qb
        assert int((rows[0, 1:] == rows[0, :-1]).sum()) >= 31 * 1000  # runs of 32
    for mode in ("any", "count"):
        for sg in (seg, seg - 1) if case == "repeat" else (seg,):  # a window of the run, or half of it
            got = k4_walk_model(x, qb, sg, mode, 3)
            plain = ck._chunked_sel_plain(win, pk, qb, sg, mode, 3)
            assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1]), (mode, sg)
            assert (plain[0] >= 0).any()


@pytest.mark.parametrize("v", [32, 64])
def test_k4_schedule_places_every_stage(v):
    """65 stages: the bitonic levels of 2048 .. 32768 have 11 .. 15 stages. At V 32 the
    15 stages across warps run in columnar registers, 25 in warp-columnar registers and
    25 in blocked registers; ten block barriers in all (two a level)."""
    win = torch.zeros((1, 32), dtype=torch.int32)
    pk = torch.arange(PK_CHUNK, dtype=torch.int32)
    _, stages, barriers = k4_merge_model(win, pk, v)
    assert barriers == 10
    for lvl in range(5):
        ds = [d for (l, d, _) in stages if l == lvl]
        assert ds == [1024 << lvl >> s for s in range(11 + lvl)]
    places = [place for (_, _, place) in stages]
    counts = {p: places.count(p) for p in set(places)}
    want = {32: {"columnar registers": 15, "warp-columnar registers": 25, "blocked registers": 25},
            64: {"columnar registers": 10, "warp-columnar registers": 30, "blocked registers": 25}}[v]
    assert counts == want
    for lvl, d, place in stages:  # every stage runs where its pairs sit
        if place == "columnar registers":
            assert d >= 32 * v
        elif place == "warp-columnar registers":
            assert 32 <= d < 32 * v
        else:
            assert d < 32


def _banks_per_warp(words):
    """The most accesses one bank takes in one word access of a warp: [T, V] words."""
    worst = 0
    for w in range(words.shape[0] // 32):
        for r in range(words.shape[1]):
            worst = max(worst, int(torch.bincount(words[32 * w:32 * w + 32, r] % 32, minlength=32).max()))
    return worst


@pytest.mark.parametrize("v", [32, 64])
def test_k4_padded_plane_is_conflict_free(v):
    """The padding maps the plane one to one into N + N / 32 words; a warp's word
    accesses hit 32 banks in the columnar and warp-columnar layouts, and in the blocked
    one at V 32 (at V 64 two lanes share a bank)."""
    i = torch.arange(N32)
    assert len(torch.unique(pad(i))) == N32 and int(pad(i).max()) < N32 + N32 // 32
    col, wcol, blk = k4_layouts(v)
    assert _banks_per_warp(pad(col)) == 1 and _banks_per_warp(pad(wcol)) == 1
    assert _banks_per_warp(pad(blk)) == (1 if v == 32 else 2)


# ------------------------------------------------------------------------------- K7

CONSUMERS, ROWS_PER_WARP = 8, 4


def k7_keys(scores):
    """K7's u64 keys of scores [B, W] f32 at flat positions 0 .. W - 1: order-preserving
    score bits above the complemented position (unique, larger is better)."""
    u = scores.contiguous().numpy().view(np.uint32).astype(np.uint64)
    u = np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)
    pos = np.arange(scores.shape[1], dtype=np.uint64)
    return (u << np.uint64(32)) | (np.uint64(0xFFFFFFFF) - pos)


def k7_select_model(scores, s: int, k: int, rows_per_slab: int):
    """K7's selection for k <= 128 over the masked scores [B, nprobe * S] in slab order:
    warp w takes rows w + 8 i of each slab of `rows_per_slab` rows, inserts a key only
    if it beats its list's k-th (lists of kp = 32 or 128 keys, sorted descending), then
    the 8 lists are merged. Returns (vals [B, k] f32, positions [B, k] i32, the share
    of rows inserted)."""
    b, w_all = scores.shape
    nprobe = w_all // s
    kp = 32 if k <= 32 else 128
    keys = k7_keys(scores)
    spb = -(-s // rows_per_slab)
    out, inserted = np.zeros((b, k), np.uint64), 0
    for q in range(b):
        lists = [[] for _ in range(CONSUMERS)]
        for j in range(nprobe * spb):
            p, r0 = j // spb, (j % spb) * rows_per_slab
            rows = min(rows_per_slab, s - r0)
            for w in range(CONSUMERS):
                lst = lists[w]
                kth = lst[k - 1] if len(lst) >= k else 0
                for i in range(ROWS_PER_WARP):
                    rr = w + CONSUMERS * i
                    if rr < rows:
                        key = int(keys[q, p * s + r0 + rr])
                        if key > kth:
                            at = sum(1 for x in lst if x > key)  # the ballot count
                            lst.insert(at, key)
                            del lst[kp:]
                            kth = lst[k - 1] if len(lst) >= k else 0
                            inserted += 1
        merged = sorted((x for lst in lists for x in lst[:kp]), reverse=True)[:k]
        out[q] = merged
    hi = (out >> np.uint64(32)).astype(np.uint32)
    bits = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi & 0xFFFFFFFF).astype(np.uint32)
    vals = torch.from_numpy(bits.view(np.float32).copy())
    pos = torch.from_numpy((np.uint64(0xFFFFFFFF) - (out & np.uint64(0xFFFFFFFF))).astype(np.int32))
    return vals, pos, inserted / scores.numel()


def _k7_case(seed: int, b: int, nprobe: int, d: int, c: int = 24, s: int = 128):
    """Exact-arithmetic buckets (entries k/8 of d 4: ties are common), duplicated
    buckets (ties across probes), a bucket with no live row."""
    g = torch.Generator().manual_seed(seed)
    emb3 = (torch.randint(-2, 3, (c, s, d), generator=g) / 8.0).float()
    emb3[1] = emb3[5]
    emb3[7] = emb3[5]
    q = (torch.randint(-2, 3, (b, d), generator=g) / 8.0).float()
    probes = torch.stack([torch.randperm(c, generator=g)[:nprobe] for _ in range(b)]).to(torch.int32)
    probes[:, :3] = torch.tensor([5, 1, 7], dtype=torch.int32)  # the same rows at probe ranks 0, 1 and 2
    counts = torch.randint(1, s + 1, (c,), generator=g).to(torch.int32)
    counts[5] = counts[1] = counts[7] = s
    counts[int(probes[0, 3])] = 0
    return q, probes, counts, emb3


@pytest.mark.parametrize("k", [1, 20, 32, 33, 128])
@pytest.mark.parametrize("rows_per_slab", [32, 16, 24])
def test_k7_warp_lists_equal_stable_top_k(k, rows_per_slab):
    """The warp-list selection gives stable_top_k's values and positions (and the plain
    twin's) on tie-heavy data: equal scores at the k-th value in different warps, the
    same rows at three probe ranks, a dead bucket, slabs that do not divide the bucket."""
    q, probes, counts, emb3 = _k7_case(k * 7 + rows_per_slab, 6, 10, 4)
    s = emb3.shape[1]
    rows = emb3[probes.long()].reshape(q.shape[0], -1, emb3.shape[2])
    scores = torch.bmm(rows, q[:, :, None])[..., 0]
    live = (torch.arange(s)[None, None, :] < counts[probes.long()][..., None]).reshape(q.shape[0], -1)
    scores = torch.where(live, scores, NEG_INF).float()
    vals, pos, share = k7_select_model(scores, s, k, rows_per_slab)
    want_v, want_p = stable_top_k(scores, k)
    assert torch.equal(vals, want_v) and torch.equal(pos.long(), want_p)
    pv, pp = ivf._bucket_rescore_plain(q, probes, counts, emb3, k)
    assert torch.equal(vals, pv) and torch.equal(pos, pp)
    kth = want_v[:, k - 1:k]
    ties = (scores == kth).sum(dim=1)
    assert bool((ties > 1).any())  # the k-th value is tied somewhere
    if k <= 32:
        assert share < 0.5  # most rows cost one compare


def test_k7_ties_across_warps_and_probes_take_the_lowest_position():
    """All scores equal: the k best are the k lowest positions, whichever warp holds them."""
    scores = torch.zeros((2, 3 * 128))
    for k in (5, 40):
        vals, pos, _ = k7_select_model(scores, 128, k, 32)
        assert torch.equal(pos, torch.arange(k, dtype=torch.int32)[None, :].repeat(2, 1))
        assert bool((vals == 0).all())
