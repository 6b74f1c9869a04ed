"""A plain model of the schedule of kernels K3 and K5, held against the twins and JAX.

The CUDA kernels run only on a card. This model replays, in torch on the CPU, how the
body `rescore<SPLIT, NL, CPW>` of `csrc/bm25_rescore.cu` maps and matches a forward
row, so that a fault of the schedule (a lane loaded twice or never, a register group
skipped while a lane of it is live, a binary search that misses a slot, a repeated
query term counted once, slots added out of order) shows here:

* the launch plan (`launch_plan`, the mirror of `wax_k3k5_plan`): CPW candidates per
  warp, S = 32 / CPW lanes per candidate, NL register groups (lane sub + S * i);
* per warp round, the register groups that no lane of the warp holds live, skipped;
* each live tid looked up by the kernel's binary search in the query's live slots
  sorted by (tid, slot) and padded to a power of two; a weight loaded only on a match;
* products `w * idf[j]` written into the candidate's product row, bit j of its hit
  mask set for every slot of a repeated term, the marked slots added in slot order.

Held bit for bit against `_rescore_fused_plain` and `_rescore_split_plain` (K5's
liveness: tid >= 0 and weight > 0), and against the JAX package's `exact_rescore_fused`
and `exact_rescore` (run on the CPU as its own tests run them): counts equal, scores
within rtol 1e-6 (JAX sums per lane, then across lanes).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wax_tpu.ops import bm25_rescore as jbr
from wax_tpu_torch.ops import bm25_rescore as rs

INT_MAX = 2**31 - 1


def _pow2_at_least(x):
    p = 1
    while p < x:
        p *= 2
    return p


def rescore_model(tsrc, wsrc, width: int, cand, tids_q, idf_q, split: bool):
    """K3 (split False: tsrc / wsrc the two halves of the fused rows) or K5 (split True)
    as the kernel schedules it. Returns (scores [B, F], counts [B, F], stats): stats
    counts the register groups a warp round matched and skipped, the tid lanes loaded
    and the weights loaded."""
    b, f = cand.shape
    p = rs.launch_plan(width, b, f)
    nl, cpw = p["nl"], p["cpw"]
    s = 32 // cpw
    q = tids_q.shape[1]
    fp = -(-f // cpw) * cpw  # candidates past F: dead lanes of the last round
    cand_p = torch.full((b, fp), -1, dtype=torch.int32)
    cand_p[:, :f] = cand
    lanes = torch.arange(nl)[:, None] * s + torch.arange(s)[None, :]  # [NL, S]: register i of thread sub
    in_width = lanes < width
    assert torch.equal(torch.sort(lanes[in_width]).values, torch.arange(width))  # each lane read once
    row = cand_p.clamp(min=0).long()
    t = torch.where((cand_p >= 0)[..., None, None] & in_width, tsrc[row][..., lanes.clamp(max=tsrc.shape[1] - 1)],
                    -1)  # [B, Fp, NL, S]
    w_all = wsrc[row][..., lanes.clamp(max=wsrc.shape[1] - 1)]
    # a warp round holds cpw consecutive candidates; group i is matched if any of its lanes is live
    gl = (t >= 0).reshape(b, fp // cpw, cpw, nl, s).any(dim=(2, 4))  # [B, rounds, NL]
    gl = gl.repeat_interleave(cpw, dim=1)[..., None]  # [B, Fp, NL, 1]
    stats = {"groups_matched": int(gl.sum()) // cpw, "groups_skipped": int((~gl).sum()) // cpw,
             "tid_lanes_loaded": int(((cand_p >= 0)[..., None, None] & in_width).sum()), "weights_loaded": 0}
    scores = torch.zeros((b, fp), dtype=torch.float32)
    counts = torch.zeros((b, fp), dtype=torch.int32)
    for qb in range(b):  # one query's CTAs stage the same sorted slots
        live = [(int(v), j) for j, v in enumerate(tids_q[qb].tolist()) if v >= 0]
        st = sorted(live)
        nv, qp = len(st), _pow2_at_least(len(st))
        st_t = torch.tensor([v for v, _ in st] + [INT_MAX] * (qp - nv), dtype=torch.int64)
        sj = [j for _, j in st]
        tb = t[qb].long()  # [Fp, NL, S]
        lo = torch.zeros_like(tb)
        step = qp >> 1
        while step:  # the kernel's lower bound over the padded slots
            lo += torch.where(st_t[lo + step - 1] < tb, step, 0)
            step >>= 1
        hit = gl[qb] & (tb >= 0) & (lo < nv) & (st_t[lo] == tb)
        w = torch.where(hit, w_all[qb], 0.0)
        stats["weights_loaded"] += int(hit.sum())
        if split:
            hit &= w > 0.0
        prod = torch.zeros((fp, q), dtype=torch.float32)
        mask = torch.zeros((fp, q), dtype=torch.bool)
        for fi, i, sub in torch.nonzero(hit).tolist():
            k = int(lo[fi, i, sub])
            while k < nv and st[k][0] == int(tb[fi, i, sub]):  # every slot of a repeated term
                j = sj[k]
                assert not mask[fi, j], "two live lanes of a row hold one term"
                prod[fi, j] = w[fi, i, sub] * idf_q[qb, j]  # one f32 product
                mask[fi, j] = True
                k += 1
        acc = torch.zeros(fp, dtype=torch.float32)
        for j in range(q):  # one lane adds the marked slots in slot order
            acc = torch.where(mask[:, j], acc + prod[:, j], acc)
        scores[qb], counts[qb] = acc, mask.sum(dim=1).to(torch.int32)
    return scores[:, :f], counts[:, :f], stats


def _rows(rng, n, l, width, layout, vocab, per_row=None):
    """n forward rows of l lanes, each term at most once in the first `width` lanes:
    "packed" (tid-ascending live lanes first, then -1 pads) or "holes" (30% of the
    lanes -1 anywhere). per_row bounds the live lanes of a packed row."""
    tids = np.full((n, l), -1, np.int32)
    for r in range(n):
        terms = rng.choice(vocab, width, replace=False).astype(np.int32)
        if layout == "packed":
            m = int(rng.integers(0, (per_row or width) + 1))
            tids[r, :m] = np.sort(terms[:m])
        else:
            tids[r, :width] = np.where(rng.random(width) < 0.3, -1, terms)
    return tids


def _query(rng, b, q, vocab, repeat=True):
    """[B, Q] slot tids (-1 pads) and idf > 0; the last slot repeats the first term."""
    tq = rng.integers(-1, vocab, (b, q)).astype(np.int32)
    if repeat and q >= 2:
        tq[:, -1] = tq[:, 0]
    iq = np.where(tq >= 0, rng.random((b, q)) + 0.5, 0.0).astype(np.float32)
    return torch.from_numpy(tq), torch.from_numpy(iq)


def _cands(rng, n, b, f, dead=0.2):
    c = rng.integers(0, n, (b, f)).astype(np.int32)
    c[rng.random((b, f)) < dead] = -1
    return torch.from_numpy(c)


def _fused(tids, w):
    return torch.cat([torch.from_numpy(tids), torch.from_numpy(w).view(torch.int32)], dim=1)


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ------------------------------------------------------------------------ the plan


@pytest.mark.parametrize("width", [32, 64, 96, 128, 192, 256, 384, 512])
def test_plan_covers_each_width_with_fixed_register_groups(width):
    """NL is a power of two in {2, 4, 8, 16} and the smallest that covers the width
    with S = 32 / CPW lanes; two candidates a warp up to 128 lanes (K5's narrow form
    and hybrid_1m's L2 included), one above; 64 candidates of a query per CTA of 8
    warps."""
    for b, f in ((256, 256), (1, 1), (3, 257), (2, 63)):
        p = rs.launch_plan(width, b, f)
        s = 32 // p["cpw"]
        assert p["cpw"] == (2 if width <= 128 else 1)
        assert p["nl"] in (2, 4, 8, 16) and p["nl"] * s >= width > p["nl"] // 2 * s
        assert p["cands_per_cta"] == 64 and p["threads"] == 256
        assert (p["grid_x"], p["grid_y"]) == (-(-f // 64), b)
        assert p["cands_per_cta"] // (p["threads"] // 32) <= 32  # a warp's rows sit in its lanes
    assert rs.launch_plan(64, 256, 256)["nl"] == 4 and rs.launch_plan(128, 256, 256)["nl"] == 8


# --------------------------------------------------------------- against the twins


@pytest.mark.parametrize("layout", ["packed", "holes"])
@pytest.mark.parametrize("q", [1, 16, 33, 128])
@pytest.mark.parametrize("l2", [64, 128, 192, 512])
def test_k3_model_equals_plain_twin(l2, q, layout):
    """Bit-equal to `_rescore_fused_plain` on random weights: every register width,
    Q 1 to 128, left-packed rows and rows with holes, repeated query terms, dead
    candidates and F odd; on packed rows no live lane sits in a skipped group."""
    rng = np.random.default_rng(l2 * 1000 + q + (layout == "holes"))
    n, b, f, vocab = 300, 3, 37, 2 * l2 + 100
    tids = _rows(rng, n, l2, l2, layout, vocab)
    w = np.where(tids >= 0, rng.random((n, l2)), 0.0).astype(np.float32)
    w[tids == 7] = 0.0  # a zero weight still counts in K3
    fused = _fused(tids, w)
    cand = _cands(rng, n, b, f)
    tq, iq = _query(rng, b, q, vocab)
    tq[0, : min(q, 3)] = torch.from_numpy(tids[int(cand[0, 0].clamp(min=0)), : min(q, 3)])  # some matches
    got = rescore_model(fused[:, :l2], fused[:, l2:].contiguous().view(torch.float32), l2, cand, tq, iq, False)
    _equal(got[:2], rs._rescore_fused_plain(fused, cand, tq, iq))
    _equal(got[:2], rs.rescore_fused(fused, cand, tq, iq))  # the wrapper's CPU path
    stats = got[2]
    assert stats["weights_loaded"] <= stats["tid_lanes_loaded"]
    if layout == "packed":
        assert stats["groups_matched"] + stats["groups_skipped"] == b * -(-f // rs.launch_plan(l2, b, f)["cpw"]) * \
            rs.launch_plan(l2, b, f)["nl"]


@pytest.mark.parametrize("form", ["narrow", "wide"])
@pytest.mark.parametrize("l,q", [(64, 1), (128, 16), (256, 128), (512, 33)])
def test_k5_model_equals_plain_twin_and_k3(l, q, form):
    """Bit-equal to `_rescore_split_plain` in the narrow (the first 64 lanes) and wide
    forms, with weights 0 on live tids (tombstoned rows and single lanes: K5 skips
    them), and to K3 over the same lanes with those tids cleared."""
    rng = np.random.default_rng(l * 10 + q + (form == "wide"))
    n, b, f, vocab = 300, 3, 41, 2 * l + 100
    width = 64 if form == "narrow" else l
    tids = _rows(rng, n, l, min(width, l), "holes", vocab)
    w = np.where(tids >= 0, rng.random((n, l)) + 0.01, 0.0).astype(np.float32)
    w[rng.random(n) < 0.1] = 0.0  # tombstoned rows: live tids, weights 0
    w[rng.random((n, l)) < 0.05] = 0.0
    ft, fw = torch.from_numpy(tids), torch.from_numpy(w)
    cand = _cands(rng, n, b, f)
    tq, iq = _query(rng, b, q, vocab)
    tq[1, : min(q, 4)] = ft[int(cand[1, 2].clamp(min=0)), : min(q, 4)]
    got = rescore_model(ft, fw, width, cand, tq, iq, True)
    _equal(got[:2], rs._rescore_split_plain(ft, fw, cand, tq, iq, width))
    _equal(got[:2], rs.rescore_split(ft, fw, cand, tq, iq, width))
    k5_live = np.where(w > 0, tids, -1)[:, :width]
    l2 = -(-width // 64) * 64
    t2 = np.full((n, l2), -1, np.int32)
    w2 = np.zeros((n, l2), np.float32)
    t2[:, :width], w2[:, :width] = k5_live, w[:, :width]
    _equal(got[:2], rs._rescore_fused_plain(_fused(t2, w2), cand, tq, iq))


@pytest.mark.parametrize("l2,q", [(64, 1), (64, 16), (128, 16), (128, 33), (192, 5)])
def test_model_against_jax_twins(l2, q):
    """The model against the JAX package's K3 (`exact_rescore_fused`) and K5
    (`exact_rescore`, narrow where the real width allows) on the same numpy inputs:
    counts equal, scores within rtol 1e-6."""
    rng = np.random.default_rng(l2 + q)
    n, b, f, vocab = 200, 2, 8, 400
    width = 48 if l2 == 64 else l2
    tids = _rows(rng, n, l2, width, "packed", vocab)
    w = np.where(tids >= 0, rng.random((n, l2)) + 0.01, 0.0).astype(np.float32)
    idf = (rng.random(vocab) + 0.5).astype(np.float32)
    cand = _cands(rng, n, b, f).numpy()
    term_ids = rng.integers(-1, vocab, (b, q)).astype(np.int32)
    term_ids[:, 0] = tids[np.maximum(cand[:, 0], 0), 0]
    tq, iq = rs._query_planes(torch.from_numpy(term_ids), torch.from_numpy(idf))
    fused = _fused(tids, w)
    ms, mc, _ = rescore_model(fused[:, :l2], fused[:, l2:].contiguous().view(torch.float32), l2,
                              torch.from_numpy(cand), tq, iq, False)
    jv, jc = jbr.exact_rescore_fused(jnp.asarray(term_ids), jnp.asarray(cand), jnp.asarray(fused.numpy()),
                                     jnp.asarray(idf))
    np.testing.assert_array_equal(mc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ms.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    lk = max(l2, 128)  # the JAX narrow form needs L >= 128
    ft = np.full((n, lk), -1, np.int32)
    fw = np.zeros((n, lk), np.float32)
    ft[:, :l2], fw[:, :l2] = tids, w
    fwd_width = width if width <= 64 else 0
    width5 = 64 if 0 < fwd_width <= 64 and f % 2 == 0 else lk
    ks, kc, _ = rescore_model(torch.from_numpy(ft), torch.from_numpy(fw), width5, torch.from_numpy(cand), tq, iq, True)
    jv, jc = jbr.exact_rescore(jnp.asarray(term_ids), jnp.asarray(cand), jnp.asarray(ft), jnp.asarray(fw),
                               jnp.asarray(idf), fwd_width=fwd_width)
    np.testing.assert_array_equal(kc.numpy(), np.asarray(jc))
    np.testing.assert_allclose(ks.numpy(), np.asarray(jv), rtol=1e-6, atol=0)
    assert (mc.numpy() > 0).any()


# ------------------------------------------------------------------ the schedule


def test_dead_groups_skipped_on_left_packed_rows():
    """hybrid_1m's rows (about 35 live lanes of 128, left-packed): K3's warps (two
    candidates each, 8 groups of 16 lanes) match at most three groups and skip the
    rest; the same terms spread over the row skip fewer, and give the same scores."""
    rng = np.random.default_rng(3)
    n, b, f, l2, vocab = 400, 2, 64, 128, 1000
    packed = _rows(rng, n, l2, l2, "packed", vocab, per_row=40)
    w = np.where(packed >= 0, rng.random((n, l2)) + 0.01, 0.0).astype(np.float32)
    cand = _cands(rng, n, b, f, dead=0.0)
    tq, iq = _query(rng, b, 16, vocab)
    fp = _fused(packed, w)
    ks, kc, st = rescore_model(fp[:, :l2], fp[:, l2:].contiguous().view(torch.float32), l2, cand, tq, iq, False)
    rounds = b * f // 2
    assert st["groups_matched"] <= 3 * rounds and st["groups_skipped"] >= 5 * rounds
    # the same terms in a spread layout: every group holds a live lane
    perm = rng.permutation(l2)
    spread, wsp = packed[:, perm], w[:, perm]
    fs = _fused(spread, wsp)
    ks2, kc2, st2 = rescore_model(fs[:, :l2], fs[:, l2:].contiguous().view(torch.float32), l2, cand, tq, iq, False)
    assert st2["groups_skipped"] < st["groups_skipped"]
    assert torch.equal(kc, kc2)
    # slot order, not lane order: the sums agree bit for bit whatever the layout
    assert torch.equal(ks, ks2)
    _equal((ks2, kc2), rs._rescore_fused_plain(fs, cand, tq, iq))


def test_weights_loaded_only_on_matched_lanes():
    """A weight is fetched only where a live tid matched a slot: as many weight loads
    as (lane, term) matches, far fewer than the live lanes."""
    rng = np.random.default_rng(4)
    n, b, f, l2, vocab = 300, 2, 32, 128, 600
    tids = _rows(rng, n, l2, l2, "packed", vocab, per_row=40)
    w = np.where(tids >= 0, rng.random((n, l2)) + 0.01, 0.0).astype(np.float32)
    cand = _cands(rng, n, b, f, dead=0.0)
    tq, iq = _query(rng, b, 16, vocab, repeat=False)
    tq[:, :4] = torch.from_numpy(tids[cand[:, 0].numpy(), :4])
    fz = _fused(tids, w)
    ks, kc, st = rescore_model(fz[:, :l2], fz[:, l2:].contiguous().view(torch.float32), l2, cand, tq, iq, False)
    live = int((torch.from_numpy(tids)[cand.long()] >= 0).sum())
    matched = sum(len(set(tids[r].tolist()) & set(tq[qb].tolist()) - {-1})
                  for qb in range(b) for r in cand[qb].tolist())  # lanes holding a query term
    assert st["weights_loaded"] == matched <= int(kc.sum()) and 0 < matched < live // 4


def test_repeated_query_term_counts_lane_slot_pairs():
    """A query that holds one term in three slots: a row holding it counts 3 matches and
    adds the three products in slot order, between the slots of another term."""
    tids = np.full((4, 64), -1, np.int32)
    tids[0, :3] = [5, 9, 11]
    tids[1, 10] = 9
    w = np.where(tids >= 0, np.float32(0.3), np.float32(0.0)).astype(np.float32)
    w[0, 2] = 0.7
    tq = torch.tensor([[9, 11, 9, -1, 9], [2, -1, -1, -1, -1]], dtype=torch.int32)
    iq = torch.tensor([[1.1, 0.9, 1.3, 0.0, 0.7], [1.0, 0.0, 0.0, 0.0, 0.0]], dtype=torch.float32)
    cand = torch.tensor([[0, 1, -1], [0, 1, 2]], dtype=torch.int32)
    fz = _fused(tids, w)
    ks, kc, _ = rescore_model(fz[:, :64], fz[:, 64:].contiguous().view(torch.float32), 64, cand, tq, iq, False)
    assert kc.tolist() == [[4, 3, 0], [0, 0, 0]]
    w0, w2 = torch.tensor(0.3, dtype=torch.float32), torch.tensor(0.7, dtype=torch.float32)
    want = ((w0 * iq[0, 0] + w2 * iq[0, 1]) + w0 * iq[0, 2]) + w0 * iq[0, 4]
    assert ks[0, 0] == want
    _equal((ks, kc), rs._rescore_fused_plain(fz, cand, tq, iq))


@pytest.mark.parametrize("b,f", [(1, 1), (2, 63), (3, 65), (0, 5), (4, 0)])
def test_dead_ragged_and_empty_batches(b, f):
    """F = 1, F around the 64 candidates of a CTA, all-dead candidates, a query with no
    live slot, and B * F = 0 (no launch): 0 / 0 where nothing can match."""
    rng = np.random.default_rng(b * 100 + f)
    n, l2, vocab = 100, 64, 300
    tids = _rows(rng, n, l2, l2, "holes", vocab)
    w = np.where(tids >= 0, rng.random((n, l2)) + 0.01, 0.0).astype(np.float32)
    fz = _fused(tids, w)
    cand = _cands(rng, n, b, f)
    if b >= 2:
        cand[1] = -1
    tq, iq = _query(rng, b, 8, vocab)
    if b >= 3:
        tq[2], iq[2] = -1, 0.0
    want = rs._rescore_fused_plain(fz, cand, tq, iq)
    _equal(rs.rescore_fused(fz, cand, tq, iq), want)
    if b and f:
        _equal(rescore_model(fz[:, :l2], fz[:, l2:].contiguous().view(torch.float32), l2, cand, tq, iq, False)[:2],
               want)
        if b >= 2:
            assert not want[0][1].any() and not want[1][1].any()
        if b >= 3:
            assert not want[0][2].any() and not want[1][2].any()
    assert want[0].shape == (b, f)


def test_narrow_form_never_reads_past_64_lanes():
    """K5's narrow form over a 512-lane array: lanes 64 and up are never loaded, so
    terms there do not count (the TPU kernel's narrow form reads the first 64)."""
    rng = np.random.default_rng(6)
    n, l, vocab = 200, 512, 1200
    tids = _rows(rng, n, l, l, "holes", vocab)
    w = np.where(tids >= 0, rng.random((n, l)) + 0.01, 0.0).astype(np.float32)
    ft, fw = torch.from_numpy(tids), torch.from_numpy(w)
    cand = _cands(rng, n, 2, 16)
    tq = torch.from_numpy(tids[np.maximum(cand[:, :1].numpy(), 0)[:, 0], 100:116].copy())  # terms past lane 64
    iq = torch.where(tq >= 0, 1.0, 0.0).float()
    narrow, wide = (rescore_model(ft, fw, width, cand, tq, iq, True) for width in (64, l))
    assert narrow[2]["tid_lanes_loaded"] == int((cand >= 0).sum()) * 64
    assert int(wide[1].sum()) > int(narrow[1].sum())
    _equal(narrow[:2], rs._rescore_split_plain(ft, fw, cand, tq, iq, 64))
    _equal(wide[:2], rs._rescore_split_plain(ft, fw, cand, tq, iq, l))
