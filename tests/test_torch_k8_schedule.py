"""A plain model of K8's schedule on the card (csrc/bm25_candidates.cu), on the CPU.

K8 splits each query over G CTAs: CTA g owns the rows [x_g, x_g+1), x_g = max{x :
count(rows < x) <= g * P / G} (merge path over the query's P postings), found by an
(NC+1)-ary search over row values; its plane base is n_neg + count(rows < x_g); the
sentinel prefix [0, n_neg) and suffix [n_neg + P, Q2 * W2) are split evenly over the
G CTAs; each CTA walks its rows in tiles, sums each row's postings in slot order and
writes every posting position it owns once. With sel > 0 each CTA keeps, per slot
position, the sel best live keys it owns; the query's last CTA merges the G lists and
fills each with the dead keys of the lowest chunks not live there (closed form).

`schedule` models that per CTA with numpy, counting every plane write, and is held bit
for bit against the plain twin `_candidate_scores_plain` (which the CUDA kernel equals
on the card) for G 1 to 64, B 1 to 13, every mode and sel 0-4, queries of 1, 3 and 16
terms, empty / all -1 / one-posting queries, duplicated terms, tombstoned (weight 0)
postings and G past the postings; and against the JAX package's K8 in interpret mode.
`launch_plan` (the mirror of the C plan `wax_k8_plan`) is checked here against its
rule; the card test `test_k8_candidates_equal_plain` holds the C plan against it.

With sel > 0 the kernel walks postings, not rows (`k8_candidates_sel`): a query takes
n = min(G, ceil(P / WALK_MIN)) CTAs (at least one), each CTA its merge-path share in
windows of TW postings shared out over the slots in proportion to what each has left;
a window's bound m is the smallest last row among the slots with postings past their
window, the postings with row <= m are ready, and a counting sort over NB buckets of
[m0, m] puts them in (row, slot) order; the last of each run of equal rows is its
leader. `walk` models that with numpy and feeds `select`, held bit for bit against the
twin on sparse rows (spread over 2^23 and more against a few thousand postings), a row
held by all 16 slots, runs that end at a window's bound or at a partition, slots that
run out mid-walk, G 1-64, B 1-13, sel 1-4 and every mode.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.index import lex as jlex
from wax_tpu.ops import bm25_candidates_pallas as jk
from wax_tpu_torch.ops import bm25_candidates_pallas as tk

PK, EMPTY = 1024, np.iinfo(np.int32).min
NEG = np.float32(tk.NEG_INF)
N_ROWS, N_TERMS = 3000, 12


def _sel_key(scores: np.ndarray, chunk: np.ndarray) -> np.ndarray:
    bits = scores.astype(np.float32).view(np.int32)
    key = np.where(bits >= 0, bits, np.bitwise_not(bits) ^ EMPTY)
    return ((key & ~0x1FFF) | (0x1FFF - chunk)).astype(np.int32)


def _count_below(slot_rows, x) -> int:
    return int(sum(np.searchsorted(r, x, "left") for r in slot_rows))


def _kary_bound(slot_rows, lo: int, hi: int, target: int, nc: int) -> tuple[int, int, int]:
    """The kernel's (NC+1)-ary search for max{x : count(rows < x) <= target} with
    count(lo) <= target < count(hi), each round's lower_bounds taken only between the
    previous round's bracketing indices. Returns (x, count(rows < x), rounds)."""
    ilo = np.zeros(len(slot_rows), np.int64)
    ihi = np.array([len(r) for r in slot_rows], np.int64)
    f_lo, rounds = 0, 0
    while hi - lo > 1:
        rounds += 1
        step = -(-(hi - lo) // (nc + 1))
        cands = lo + step * np.arange(1, nc + 1)
        cands = cands[cands < hi]
        lbs = np.stack([ilo[s] + np.searchsorted(r[ilo[s]:ihi[s]], cands, "left")
                        for s, r in enumerate(slot_rows)], 1)  # [cands, slots]
        counts = lbs.sum(1)
        jl = int(np.searchsorted(counts, target, "right")) - 1  # the last count <= target
        jh = jl + 1 if jl + 1 < len(cands) else -1
        new_lo, new_hi = (int(cands[jl]) if jl >= 0 else lo), (int(cands[jh]) if jh >= 0 else hi)
        if jl >= 0:
            ilo, f_lo = lbs[jl], int(counts[jl])
        if jh >= 0:
            ihi = lbs[jh]
        lo, hi = new_lo, new_hi
    return lo, f_lo, rounds


def schedule(term_ids, rows, wn, offsets, idf, q2: int, w2: int, g_ctas: int, tile: int = tk._TILE):
    """Per query: the CTAs' row bounds and bases, and the leaders each CTA found
    (plane position, row, slot-order f32 sum, count), with a count of every plane
    write of sel 0 (each element must be written once)."""
    start, eff, idfs, n_neg, nterm = (x.numpy() for x in tk._slots(torch.from_numpy(term_ids),
                                                                    torch.from_numpy(offsets),
                                                                    torch.from_numpy(idf), q2, w2))
    nc = max(1, tk._THREADS // (2 * q2))
    n = q2 * w2
    out = []
    for b in range(term_ids.shape[0]):
        sr = [rows[start[b, s]:start[b, s] + eff[b, s]].astype(np.int64) for s in range(q2)]
        sw = [np.float32(idfs[b, s]) * wn[start[b, s]:start[b, s] + eff[b, s]] for s in range(q2)]
        p = int(eff[b].sum())
        live_rows = [r for r in sr if len(r)]
        rmin = min(int(r[0]) for r in live_rows) if live_rows else np.iinfo(np.int32).max
        rmax = max(int(r[-1]) for r in live_rows) if live_rows else -1
        # merge path: bound g is x_g (g 0: rmin, g G: rmax + 1); count(rows < x_g) <= g P / G
        xs, fs = [rmin], [0]
        for g in range(1, g_ctas):
            if p == 0:
                xs.append(rmin)
                fs.append(0)
                continue
            target = p * g // g_ctas
            x, f, _ = _kary_bound(sr, rmin, rmax + 1, target, nc)
            # the search gives the definition's x: count(x) <= target < count(x + 1)
            assert f == _count_below(sr, x) <= target < _count_below(sr, x + 1)
            xs.append(x)
            fs.append(f)
        xs.append(rmax + 1)
        fs.append(p)
        written = np.zeros(n, np.int32)
        ctas = []
        for g in range(g_ctas):
            tail = n - int(n_neg[b]) - p
            for lo, hi in ((n_neg[b] * g // g_ctas, n_neg[b] * (g + 1) // g_ctas),
                           (n_neg[b] + p + tail * g // g_ctas, n_neg[b] + p + tail * (g + 1) // g_ctas)):
                written[lo:hi] += 1
            cur = [int(np.searchsorted(r, xs[g], "left")) for r in sr]
            end = [int(np.searchsorted(r, xs[g + 1], "left")) for r in sr]
            done, first = fs[g], True
            leaders = []
            while any(c < e for c, e in zip(cur, end)):
                t0 = xs[g] if first else min(int(r[c]) for r, c, e in zip(sr, cur, end) if c < e)
                first = False
                width = min(tile, xs[g + 1] - t0)
                whole = t0 + tile >= xs[g + 1]
                th = [e if whole else c + int(np.searchsorted(r[c:e], t0 + tile, "left"))
                      for r, c, e in zip(sr, cur, end)]
                acc = np.zeros(width, np.float32)
                cnt = np.zeros(width, np.int64)
                for s in range(q2):  # slot order
                    r = sr[s][cur[s]:th[s]] - t0
                    acc[r] = acc[r] + sw[s][cur[s]:th[s]]
                    cnt[r] += 1
                incl = np.cumsum(cnt)
                base = int(n_neg[b]) + done
                rr = np.flatnonzero(cnt)
                c = cnt[rr]  # each row writes its run: c - 1 non-leaders, then its leader
                np.add.at(written, np.repeat(base + incl[rr] - c, c) + np.arange(c.sum())
                          - np.repeat(np.cumsum(c) - c, c), 1)
                leaders.append(np.stack([base + incl[rr] - 1, t0 + rr, acc[rr].view(np.int32), cnt[rr]], 1))
                done += int(incl[-1]) if width else 0
                cur = th
            assert done == fs[g + 1]  # the next CTA's base follows on
            ctas.append(np.concatenate(leaders) if leaders else np.zeros((0, 4), np.int64))
        out.append(dict(n_neg=int(n_neg[b]), nterm=int(nterm[b]), p=p, xs=xs, fs=fs, written=written, ctas=ctas))
    return out


def _plan_window(cur, end, tw: int, q2: int) -> list:
    """A window's postings a slot: of tw, what each slot has left in proportion to the
    CTA's total left, at least one while it has any (`plan_window`)."""
    rem = [e - c for c, e in zip(cur, end)]
    left = sum(rem)
    return [min(r, 1 + (tw - q2) * r // left) if r > 0 else 0 for r in rem]


def walk(term_ids, rows, wn, offsets, idf, q2: int, w2: int, g_ctas: int, tw: int = tk._TW, nb: int = 4096,
         walk_min: int = tk._WALK_MIN):
    """Per query: the CTAs the selection kernel takes, their merge-path bounds, and the
    leaders each CTA found (plane position, row, slot-order f32 sum, count), each CTA
    walking its postings in windows of `tw` sorted over `nb` buckets; `stats` counts
    what the walks met (windows, runs of several slots ending at a window's bound,
    windows in which a slot with postings left had none ready, slots run out while
    others had postings)."""
    start, eff, idfs, n_neg, nterm = (x.numpy() for x in tk._slots(torch.from_numpy(term_ids),
                                                                    torch.from_numpy(offsets),
                                                                    torch.from_numpy(idf), q2, w2))
    nc = max(1, tk._THREADS // (2 * q2))
    stats = dict(windows=0, bound_runs=0, idle_slots=0, ran_out=0, partition_runs=0)
    out = []
    for b in range(term_ids.shape[0]):
        sr = [rows[start[b, s]:start[b, s] + eff[b, s]].astype(np.int64) for s in range(q2)]
        sw = [np.float32(idfs[b, s]) * wn[start[b, s]:start[b, s] + eff[b, s]] for s in range(q2)]
        p = int(eff[b].sum())
        n = min(g_ctas, -(-p // walk_min)) if p else 1
        live_rows = [r for r in sr if len(r)]
        rmin = min(int(r[0]) for r in live_rows) if live_rows else np.iinfo(np.int32).max
        rmax = max(int(r[-1]) for r in live_rows) if live_rows else -1
        xs, fs = [rmin], [0]
        for g in range(1, n):
            x, f, _ = _kary_bound(sr, rmin, rmax + 1, p * g // n, nc)
            xs.append(x)
            fs.append(f)
            stats["partition_runs"] += max(sum(int(np.isin(y, r)) for r in sr) for y in (x - 1, x)) > 1
        xs.append(rmax + 1)
        fs.append(p)
        ctas = []
        for g in range(n):
            cur = [int(np.searchsorted(r, xs[g], "left")) for r in sr]
            end = [int(np.searchsorted(r, xs[g + 1], "left")) for r in sr]
            base = int(n_neg[b]) + fs[g]
            had = [e > c for c, e in zip(cur, end)]
            leaders = []
            while True:
                w = _plan_window(cur, end, tw, q2)
                if sum(w) == 0:
                    break
                assert sum(w) <= tw
                stats["windows"] += 1
                more = [s for s in range(q2) if w[s] and cur[s] + w[s] < end[s]]
                m = min((int(sr[s][cur[s] + w[s] - 1]) for s in more), default=np.iinfo(np.int32).max)
                mx = max(int(sr[s][cur[s] + w[s] - 1]) for s in range(q2) if w[s])
                m0 = min(int(sr[s][cur[s]]) for s in range(q2) if w[s])
                hi = min(m, mx)
                ready = [int(np.searchsorted(sr[s][cur[s]:cur[s] + w[s]], hi, "right")) for s in range(q2)]
                stats["idle_slots"] += sum(1 for s in range(q2) if w[s] and not ready[s])
                stats["ran_out"] += any(h and c == e for h, c, e in zip(had, cur, end))
                # every posting with row <= hi of the CTA's range is in the window
                for s in range(q2):
                    nxt = cur[s] + ready[s]
                    assert nxt == end[s] or sr[s][nxt] > hi
                e_idx = np.concatenate([np.arange(ready[s]) + sum(w[:s]) for s in range(q2)]).astype(np.int64)
                r_rows = np.concatenate([sr[s][cur[s]:cur[s] + ready[s]] for s in range(q2)])
                r_vals = np.concatenate([sw[s][cur[s]:cur[s] + ready[s]] for s in range(q2)]).astype(np.float32)
                big = len(r_rows)
                assert big >= 1
                shift = 0
                while (hi - m0) >> shift >= nb:
                    shift += 1
                bkt = (r_rows - m0) >> shift
                assert bkt.min() >= 0 and bkt.max() < nb
                # a posting's rank: its bucket's start plus the postings of its bucket
                # before it by (row, window index); window index order is slot order
                by_bucket = np.lexsort((e_idx, r_rows, bkt))
                np.testing.assert_array_equal(by_bucket, np.lexsort((e_idx, r_rows)))
                srt_row, srt_val = r_rows[by_bucket], r_vals[by_bucket]
                last = np.r_[srt_row[1:] != srt_row[:-1], True]  # leaders end the runs
                j1 = np.flatnonzero(last)
                j0 = np.flatnonzero(np.r_[True, srt_row[1:] != srt_row[:-1]])
                c = j1 - j0 + 1
                acc = np.zeros(len(j1), np.float32)
                for k in range(int(c.max())):  # each run summed from 0 in slot order
                    on = c > k
                    acc[on] = acc[on] + srt_val[j0[on] + k]
                stats["bound_runs"] += int(np.sum((srt_row[j1] == m) & (c > 1)))
                leaders.append(np.stack([base + j1, srt_row[j1], acc.view(np.int32), c], 1))
                cur = [c + r for c, r in zip(cur, ready)]
                base += big
            assert cur == end and base == int(n_neg[b]) + fs[g + 1]
            ctas.append(np.concatenate(leaders).astype(np.int64) if leaders else np.zeros((0, 4), np.int64))
        out.append(dict(n_neg=int(n_neg[b]), nterm=int(nterm[b]), p=p, n=n, xs=xs, fs=fs, ctas=ctas))
    return out, stats


def _live(ld: np.ndarray, mode: str, nterm: int):
    """(positions, rows, scores) of one CTA's live leaders."""
    sums, cnt = ld[:, 2].astype(np.int32).view(np.float32), ld[:, 3]
    live = (sums > 0) & ((cnt >= nterm) if mode == "all" else True)
    score = (sums + (np.float32(4096) * cnt.astype(np.float32))) if mode == "count" else sums
    return ld[live, 0], ld[live, 1].astype(np.int32), score[live].astype(np.float32)


def plane(sched, mode: str, n: int):
    rows = np.full((len(sched), n), -1, np.int32)
    scores = np.full((len(sched), n), NEG, np.float32)
    for b, q in enumerate(sched):
        assert (q["written"] == 1).all(), "every plane element is written exactly once"
        for ld in q["ctas"]:
            pos, r, s = _live(ld, mode, q["nterm"])
            rows[b, pos], scores[b, pos] = r, s
    return rows, scores


def select(sched, mode: str, sel: int, n: int):
    """Per CTA the sel best live keys of each slot position it owns; the G lists merged;
    each list filled with the dead keys of the lowest chunks not live at p."""
    nchunks = n // PK
    out_rows = np.zeros((len(sched), sel * PK), np.int32)
    out_keys = np.zeros((len(sched), sel * PK), np.int32)
    for b, q in enumerate(sched):
        g_ctas = len(q["ctas"])
        lists_k = np.full((g_ctas, PK, sel), EMPTY, np.int64)
        lists_r = np.full((g_ctas, PK, sel), -1, np.int64)
        for g, ld in enumerate(q["ctas"]):  # each CTA's list: its own live leaders only
            pos, r, s = _live(ld, mode, q["nterm"])
            keys = _sel_key(s, (pos // PK).astype(np.int32)).astype(np.int64)
            p = pos % PK
            o = np.lexsort((-keys, p))
            p, keys, r = p[o], keys[o], r[o]
            rank = np.arange(len(p)) - np.searchsorted(p, p, "left")
            m = rank < sel
            lists_k[g, p[m], rank[m]], lists_r[g, p[m], rank[m]] = keys[m], r[m]
        ak = lists_k.transpose(1, 0, 2).reshape(PK, -1)  # [PK, G * sel]: the merge
        ar = lists_r.transpose(1, 0, 2).reshape(PK, -1)
        o = np.argsort(-ak, axis=1, kind="stable")[:, :sel]
        mk, mr = np.take_along_axis(ak, o, 1), np.take_along_axis(ar, o, 1)
        nlive = (mk != EMPTY).sum(1)
        live_c = np.where(mk != EMPTY, 0x1FFF - (mk & 0x1FFF), -1)
        cand = np.arange(2 * sel)[None, :]
        taken = (cand[:, :, None] == live_c[:, None, :]).any(-1)
        dead = np.take_along_axis(np.broadcast_to(cand, taken.shape), np.argsort(taken, 1, kind="stable"), 1)
        fill = np.arange(sel)[None, :] - nlive[:, None]  # >= 0: the fill-th dead chunk
        dead = np.take_along_axis(dead, np.clip(fill, 0, None), 1)
        assert (dead[fill >= 0] < nchunks).all()
        mk = np.where(fill >= 0, _sel_key(np.full(dead.shape, NEG), dead.astype(np.int32)), mk)
        mr = np.where(fill >= 0, -1, mr)
        out_keys[b], out_rows[b] = mk.T.reshape(-1), mr.T.reshape(-1)
    return out_rows, out_keys


# ---------------------------------------------------------------------------- data


@pytest.fixture(scope="module")
def postings():
    rng = np.random.default_rng(0)
    sizes = rng.integers(1, 900, N_TERMS)
    sizes[3] = 0  # a term without postings
    sizes[4] = 1  # a one-posting term
    rows = np.concatenate([np.sort(rng.choice(N_ROWS, m, replace=False)) for m in sizes]).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    max_df = int(((sizes.max() + 127) // 128) * 128)
    exact = (rng.integers(0, 9, len(rows)) / 8.0).astype(np.float32)  # some 0: tombstoned
    rand = rng.random(len(rows)).astype(np.float32)
    rand[rng.random(len(rows)) < 0.1] = 0.0
    return rows, offsets, max_df, {"exact": (exact, np.ones(N_TERMS, np.float32)),
                                   "random": (rand, (rng.random(N_TERMS) + 0.5).astype(np.float32))}


def _queries(b: int, q: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    tids = rng.integers(-1, N_TERMS, (b, q)).astype(np.int32)
    if b > 1:
        tids[1] = -1  # an all -1 query
    if b > 2:
        tids[2, :] = 4  # one posting (a duplicated one-posting term when q > 1)
        tids[2, 1:] = -1
    if b > 3 and q > 1:
        tids[3, -1] = tids[3, 0] = 7  # a duplicated term counts once per slot
    return tids


def _q2(q: int) -> int:
    q2 = 2
    while q2 < q:
        q2 *= 2
    return q2


def _check(rows, offsets, max_df, wn, idf, tids, g_ctas, tile=tk._TILE, sels=range(5)):
    q2, w2 = _q2(tids.shape[1]), tk.dma_window(max_df)
    sched = schedule(tids, rows, wn, offsets, idf, q2, w2, g_ctas, tile)
    args = [torch.from_numpy(a) for a in (rows, wn, offsets, idf)]
    for mode in ("any", "all", "count"):
        for sel in sels:
            want = tk._candidate_scores_plain(torch.from_numpy(tids), *args, q2, w2, mode, sel)
            got = select(sched, mode, sel, q2 * w2) if sel else plane(sched, mode, q2 * w2)
            np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg=f"{mode} sel {sel} rows")
            np.testing.assert_array_equal(np.asarray(got[1]).view(np.int32), want[1].numpy().view(np.int32),
                                          err_msg=f"{mode} sel {sel} scores/keys")
    return sched


# --------------------------------------------------------------------------- tests


@pytest.mark.parametrize("q", [1, 3, 16])
@pytest.mark.parametrize("b", [1, 2, 13])
@pytest.mark.parametrize("g_ctas,tile", [(1, 8192), (1, 256), (2, 8192), (3, 512), (7, 8192), (64, 8192)])
def test_schedule_equals_plain_twin(postings, g_ctas, tile, b, q):
    """The model at G CTAs a query (and tiles of `tile` rows) gives the twin's planes
    and selections bit for bit, in every mode and at sel 0-4, on random weights."""
    rows, offsets, max_df, data = postings
    wn, idf = data["random"]
    sched = _check(rows, offsets, max_df, wn, idf, _queries(b, q, seed=b * 10 + q), g_ctas, tile)
    for qd in sched:  # postings per CTA: within Q2 of the even share
        shares = np.diff(qd["fs"])
        even = np.diff([qd["p"] * g // g_ctas for g in range(g_ctas + 1)])
        assert (np.abs(shares - even) <= _q2(q)).all() or qd["p"] == 0


def test_schedule_edges(postings):
    """Empty, all -1 and one-posting queries, a duplicated term and G far past the
    query's postings (most CTAs own no rows); exact-arithmetic weights with zeros."""
    rows, offsets, max_df, data = postings
    wn, idf = data["exact"]
    tids = np.array([[-1, -1, -1], [4, -1, -1], [4, 4, -1], [3, -1, 3], [7, 7, 2]], np.int32)
    for g_ctas in (1, 5, 200):
        sched = _check(rows, offsets, max_df, wn, idf, tids, g_ctas)
        assert [q["p"] for q in sched][:4] == [0, 1, 2, 0]
        if g_ctas == 200:  # one posting: one CTA owns it, the others write sentinels only
            assert sum(len(c) for c in sched[1]["ctas"]) == 1


def test_merge_path_search_rounds():
    """The (NC+1)-ary search takes ceil(log_{NC+1}(row span)) rounds at most: three
    at [orch_sharded]'s shard shape (25,600 rows, 16 slots: NC 32)."""
    rng = np.random.default_rng(5)
    slot_rows = [np.sort(rng.choice(25_600, 1_700, replace=False)) for _ in range(16)]
    nc = tk._THREADS // 32
    p = sum(len(r) for r in slot_rows)
    worst = 0
    for g in range(1, 132):
        x, f, rounds = _kary_bound(slot_rows, 0, 25_600, p * g // 132, nc)
        assert f == _count_below(slot_rows, x) <= p * g // 132 < _count_below(slot_rows, x + 1)
        worst = max(worst, rounds)
    assert worst == 3


def _check_walk(rows, offsets, max_df, wn, idf, tids, g_ctas, tw=tk._TW, walk_min=tk._WALK_MIN, nb=4096):
    q2, w2 = _q2(tids.shape[1]), tk.dma_window(max_df)
    sched, stats = walk(tids, rows, wn, offsets, idf, q2, w2, g_ctas, tw, nb, walk_min)
    args = [torch.from_numpy(a) for a in (rows, wn, offsets, idf)]
    for mode in ("any", "all", "count"):
        for sel in range(1, 5):
            want = tk._candidate_scores_plain(torch.from_numpy(tids), *args, q2, w2, mode, sel)
            got = select(sched, mode, sel, q2 * w2)
            np.testing.assert_array_equal(got[0], want[0].numpy(), err_msg=f"{mode} sel {sel} rows")
            np.testing.assert_array_equal(got[1], want[1].numpy(), err_msg=f"{mode} sel {sel} keys")
    return sched, stats


@pytest.mark.parametrize("q", [1, 3, 16])
@pytest.mark.parametrize("b", [1, 2, 13])
@pytest.mark.parametrize("g_ctas,tw,walk_min", [(1, 4096, 32768), (1, 64, 32768), (3, 64, 100), (7, 128, 50),
                                                (64, 64, 10), (64, 4096, 1)])
def test_walk_equals_plain_twin(postings, g_ctas, tw, walk_min, b, q):
    """The selection kernel at G CTAs a query (a query taking min(G, ceil(P /
    walk_min))), its postings walked in windows of `tw`, gives the twin's selections
    bit for bit, in every mode at sel 1-4, on random weights with tombstones, empty,
    all -1 and duplicated-term queries, sparse ones and (16 terms over 3,000 rows)
    dense ones; each CTA's share is within Q2 of the even one."""
    rows, offsets, max_df, data = postings
    wn, idf = data["random"]
    sched, stats = _check_walk(rows, offsets, max_df, wn, idf, _queries(b, q, seed=b * 10 + q), g_ctas, tw, walk_min)
    for qd in sched:
        assert qd["n"] == (min(g_ctas, -(-qd["p"] // walk_min)) if qd["p"] else 1)
        shares = np.diff(qd["fs"])
        even = np.diff([qd["p"] * g // qd["n"] for g in range(qd["n"] + 1)])
        assert (np.abs(shares - even) <= _q2(q)).all()
    assert stats["windows"] >= b * (tw == 64)


def _shared_postings(rng, n_rows, sizes, common_share, exact):
    """Term slices over n_rows rows, a `common_share` of each drawn from one common set
    of rows (so many rows are held by every term); weights on the 1/8 grid or random,
    a tenth tombstoned."""
    common = np.sort(rng.choice(n_rows, max(16, int(sizes.max() * common_share)), replace=False))
    slices = []
    for m in sizes:
        k = min(int(m * common_share), len(common))
        own = rng.choice(n_rows, m - k, replace=False)
        slices.append(np.union1d(rng.choice(common, k, replace=False), own))
    rows = np.concatenate(slices).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum([len(x) for x in slices])]).astype(np.int32)
    wn = (rng.integers(1, 9, len(rows)) / 8.0 if exact else rng.random(len(rows))).astype(np.float32)
    wn[rng.random(len(rows)) < 0.1] = 0.0
    idf = ((rng.integers(1, 5, len(sizes)) / 4.0) if exact else rng.random(len(sizes)) + 0.5).astype(np.float32)
    max_df = int(((np.diff(offsets).max() + 127) // 128) * 128)
    return rows, offsets, max_df, wn, idf


@pytest.mark.parametrize("exact", [True, False])
def test_walk_rows_every_slot_holds(exact):
    """16 terms over 4,000 rows, 60% of each slice drawn from 300 common rows (rows held
    by all 16 slots), windows of 32 and 48 postings and shares of 40 to 400: runs of
    several slots end at a window's bound and at partitions; bit-equal to the twin."""
    rng = np.random.default_rng(11 + exact)
    rows, offsets, max_df, wn, idf = _shared_postings(rng, 4000, rng.integers(200, 500, 16), 0.6, exact)
    tids = np.stack([rng.permutation(16) for _ in range(3)]).astype(np.int32)
    tids[2, 9:] = -1
    seen = {"bound_runs": 0, "partition_runs": 0}
    for g_ctas, tw, walk_min in ((1, 32, 10**6), (9, 48, 400), (64, 32, 40)):
        _, stats = _check_walk(rows, offsets, max_df, wn, idf, tids, g_ctas, tw, walk_min)
        for key in seen:
            seen[key] += stats[key]
    assert seen["bound_runs"] > 0 and seen["partition_runs"] > 0


def test_walk_sparse_rows():
    """Rows spread over 2^23 + 2^20 against a few thousand postings (the hybrid cell's
    density and lower), and slices that end early (a term over the first 50,000 rows
    runs out while the others go on), with 4,096 buckets a window and with 16."""
    rng = np.random.default_rng(23)
    n_rows = 2**23 + 2**20
    sizes = rng.integers(50, 1500, 10)
    slices = [np.sort(rng.choice(n_rows, m, replace=False)) for m in sizes]
    slices[4] = np.sort(rng.choice(50_000, 800, replace=False))
    rows = np.concatenate(slices).astype(np.int32)
    offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    offsets[5:] += 800 - sizes[4]
    wn = rng.random(len(rows)).astype(np.float32)
    idf = (rng.random(10) + 0.5).astype(np.float32)
    max_df = int(((np.diff(offsets).max() + 127) // 128) * 128)
    tids = np.array([[4, 0, 1, 2, 3, 5, 6, 7], [9, 4, 8, -1, -1, -1, -1, -1]], np.int32)
    ran_out = 0
    for g_ctas, tw, walk_min, nb in ((1, 4096, 32768, 4096), (5, 64, 900, 4096), (3, 128, 1000, 16)):
        _, stats = _check_walk(rows, offsets, max_df, wn, idf, tids, g_ctas, tw, walk_min, nb)
        ran_out += stats["ran_out"]
    assert ran_out > 0


def test_walk_edges(postings):
    """Empty, all -1 and one-posting queries, a duplicated term and G past the
    postings (the query takes one CTA); exact-arithmetic weights with zeros."""
    rows, offsets, max_df, data = postings
    wn, idf = data["exact"]
    tids = np.array([[-1, -1, -1], [4, -1, -1], [4, 4, -1], [3, -1, 3], [7, 7, 2]], np.int32)
    for g_ctas, walk_min in ((1, 1), (5, 1), (200, 1), (200, 10**6)):
        sched, _ = _check_walk(rows, offsets, max_df, wn, idf, tids, g_ctas, 64, walk_min)
        assert [q["p"] for q in sched][:4] == [0, 1, 2, 0]
        assert [q["n"] for q in sched][:4] == [1, 1, min(g_ctas, 2 // walk_min or 1), 1]


@pytest.mark.parametrize("b,q2,w2,sms,per_sm,g", [
    (1, 16, 32_768, 132, 1, 132), (2, 16, 32_768, 132, 1, 66), (13, 16, 32_768, 132, 1, 11),
    (132, 16, 32_768, 132, 1, 1), (256, 16, 32_768, 132, 1, 1), (1, 16, 32_768, 132, 2, 264),
    (1, 2, 2048, 132, 1, 4), (3, 4, 2048, 132, 1, 8), (1, 1024, 2048, 132, 8, 512), (100, 16, 32_768, 114, 2, 3),
])
def test_launch_plan(b, q2, w2, sms, per_sm, g):
    """G fills every SM's CTA slots at small B, is 1 once B does, and stays within one
    chunk of the plane a CTA and 512."""
    plan = tk.launch_plan(b, q2, w2, sms, per_sm)
    assert plan == {"g": g, "threads": tk._THREADS, "tile": tk._TILE}


@pytest.mark.parametrize("b,q2,w2,sel,g", [
    (256, 16, 262_144, 3, 32), (32, 16, 524_288, 3, 64), (512, 16, 262_144, 3, 21), (256, 16, 32_768, 3, 4),
    (1, 16, 32_768, 3, 4), (1, 2, 2048, 1, 1), (13, 1024, 2048, 4, 16), (1, 1024, 8192, 4, 64),
    (4096, 16, 32_768, 4, 2), (16_384, 16, 32_768, 4, 1),
])
def test_launch_plan_walk(b, q2, w2, sel, g):
    """sel > 0: G covers a query of Q2 slices of W2 / 2 postings at WALK_MIN a CTA,
    within the merge's 256 MiB of scratch and 512; windows of TW postings."""
    plan = tk.launch_plan(b, q2, w2, 132, 1, sel)
    assert plan == {"g": g, "threads": tk._THREADS, "tile": tk._TW}
    assert b * plan["g"] * 2 * sel * 1024 * 4 <= tk._PART_BYTES or plan["g"] == 1


def test_split_is_validated(postings):
    rows, offsets, max_df, data = postings
    args = [torch.from_numpy(a) for a in (rows, data["exact"][0], offsets, data["exact"][1])]
    tids = torch.zeros((1, 2), dtype=torch.int32)
    for bad in (0, 513):
        with pytest.raises(ValueError, match="split"):
            tk.candidate_scores_pallas(tids, *args, max_df=max_df, split=bad)
    got = tk.candidate_scores_pallas(tids, *args, max_df=max_df, split=7)  # the twin ignores it
    want = tk.candidate_scores_pallas(tids, *args, max_df=max_df)
    assert all(torch.equal(x, y) for x, y in zip(got, want))


def _jax_run(rows, offsets, wn, idf, tids, max_df, mode, sel):
    w2 = jlex.dma_window(max_df)
    p = len(rows)
    padded = ((p + w2 + 1023) // 1024) * 1024
    rp = np.zeros(padded, np.int32)
    wp = np.zeros(padded, np.float32)
    rp[:p], wp[:p] = rows, wn
    rr, wr = jlex.reverse_postings_copies(rp, wp, offsets)
    out = jk.candidate_scores_pallas(jnp.asarray(tids), jnp.asarray(rp), jnp.asarray(wp), jnp.asarray(offsets),
                                     jnp.asarray(idf), jnp.asarray(rr), jnp.asarray(wr), max_df=max_df, mode=mode,
                                     sel=sel)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("sel,mode", [(0, "all"), (3, "count")])
@pytest.mark.parametrize("kind", ["exact", "random"])
def test_schedule_equals_jax(postings, kind, sel, mode):
    """The model at G 3 against the JAX package's K8 (interpret mode) at 3-term queries:
    ids equal, scores and keys bit-equal on exact-arithmetic weights, within rtol 1e-6
    (keys: equal but at a truncation boundary) on random ones."""
    rows, offsets, max_df, data = postings
    wn, idf = data[kind]
    tids = _queries(5, 3, seed=3)
    q2, w2 = 4, tk.dma_window(max_df)
    sched = schedule(tids, rows, wn, offsets, idf, q2, w2, 3)
    jr, js = _jax_run(rows, offsets, wn, idf, tids, max_df, mode, sel)
    tr, ts = select(sched, mode, sel, q2 * w2) if sel else plane(sched, mode, q2 * w2)
    np.testing.assert_array_equal(tr, jr)
    if kind == "exact":
        np.testing.assert_array_equal(np.asarray(ts).view(np.int32), js.view(np.int32))
    elif sel == 0:
        np.testing.assert_allclose(ts, js, rtol=1e-6, atol=0)
    else:
        assert np.mean(ts == js) >= 0.999
    assert (tr >= 0).any()
