"""Exact forward-index BM25 rescore of a candidate set.

PyTorch port of `wax_tpu.ops.bm25_rescore`. A postings budget bounds candidate
generation to each term's impact head, so multi-term scores of documents outside a
head are underestimated there; the final scores come from an exact rescore of the
top-F candidates against the doc-major forward index, each document's complete term
list, which no budget truncates.

  * `exact_rescore_fused`: against the fused forward index (`fuse_forward`), one row
    gather per candidate. Its wrapper `rescore_fused` launches kernel K3
    (`csrc/bm25_rescore.cu`) on CUDA tensors and runs the plain twin
    `_rescore_fused_plain` on CPU tensors. `K3_LAUNCHES` counts launches.
  * `exact_rescore`: against separate `fwd_tids` / `fwd_wnorm`. Its wrapper
    `rescore_split` launches kernel K5 (`csrc/bm25_rescore.cu`) on CUDA tensors and
    runs the plain twin `_rescore_split_plain` on CPU tensors. `K5_LAUNCHES` counts
    launches. A lane matches only with a weight > 0, as in the TPU kernel. A truncated
    snapshot always carries `fwd_fused`, so the serving paths take K3; K5 serves
    `exact_rescore` and `rescore_topk(fwd_fused=None)`.
  * `rescore_topk`: the stable top-k over rescored candidates, ties to the lowest row.

Both kernels are one templated body (`rescore<SPLIT, NL, CPW>`) and add the query
slots in slot order, so on the same forward index K5 and K3 agree bit for bit.
`launch_plan` is the plain mirror of the C launch choice (`wax_k3k5_plan`, read on a
card by `device_plan`): register groups a thread, candidates per warp and per CTA, grid.
"""
from __future__ import annotations

import ctypes

import torch

from wax_tpu_torch.ops._build import launch, load_library, on_cpu
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k

__all__ = ["exact_rescore", "exact_rescore_fused", "rescore_fused", "rescore_split", "rescore_topk",
           "launch_plan", "device_plan", "K3_LAUNCHES", "K5_LAUNCHES"]

K3_LAUNCHES = 0
K5_LAUNCHES = 0
_QMAX = 128
_L2MAX = 512  # the forward width cap (FWD_WIDTH_CAP); K3 holds a row in registers
_NARROW = 64  # K5's narrow form: the first 64 lanes, two candidates per warp
_CTA_CANDS = 64  # csrc/bm25_rescore.cu CTA_CANDS: candidates of one query per CTA
_CTA_WARPS = 8  # csrc/bm25_rescore.cu CTA_WARPS
_CPW2_MAX = 128  # csrc/bm25_rescore.cu CPW2_MAX: two candidates a warp up to this width
_PLAN_KEYS = ("nl", "cpw", "cands_per_cta", "threads", "grid_x", "grid_y")


def _pow2_at_least(x: int) -> int:
    p = 1
    while p < x:
        p *= 2
    return p


def launch_plan(width: int, b: int, f: int) -> dict:
    """How K3 and K5 launch for rows read over `width` lanes (K3: L2; K5: 64 or L), B
    queries and F candidates, as `plan_for` in csrc/bm25_rescore.cu chooses: `cpw`
    candidates per warp (two at widths up to 128, else one), each thread holding `nl`
    register groups of 32 / cpw lanes (the width rounded up to a power of two), a CTA of
    `threads` serving `cands_per_cta` candidates of one query, grid (grid_x, grid_y)."""
    cpw = 2 if width <= _CPW2_MAX else 1
    s = 32 // cpw
    nl = _pow2_at_least(-(-width // s))
    warps = min(_CTA_WARPS, _CTA_CANDS // cpw)
    return dict(zip(_PLAN_KEYS, (nl, cpw, _CTA_CANDS, 32 * warps, -(-f // _CTA_CANDS), b)))


def device_plan(split: bool, width: int, b: int, f: int) -> dict:
    """`launch_plan` as the built library reports it (`wax_k3k5_plan`; builds the
    kernels, needs a card), with the CTAs an SM holds of that instance."""
    out = (ctypes.c_int * 7)()
    err = load_library().wax_k3k5_plan(int(split), width, b, f, ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"wax_k3k5_plan failed: CUDA error {err}")
    return dict(zip(_PLAN_KEYS + ("ctas_per_sm",), out))


def _query_planes(term_ids, idf):
    """(slot tids [B, Q] i32 with -1 pads, slot idf [B, Q] f32 with 0 on pads)."""
    valid = term_ids >= 0
    idf_q = torch.where(valid, idf[term_ids.clamp(min=0).long()], 0.0)
    return torch.where(valid, term_ids, -1).to(torch.int32), idf_q.float()


def _match_sums(tids, weights, tids_q, idf_q):
    """Shared arithmetic of both rescores: tids / weights [B, F, L] against the query
    slots [B, Q] -> (scores, counts) [B, F]. A forward row holds each term once, so
    each slot's contribution comes from at most one lane (its sum over lanes is
    exact), and the slots are added in slot order: K3's order, on any device."""
    m = (tids >= 0)[..., None] & (tids[..., None] == tids_q[:, None, None, :]) & (tids_q >= 0)[:, None, None, :]
    per_slot = torch.where(m, weights[..., None] * idf_q[:, None, None, :], 0.0).sum(dim=2)  # [B, F, Q]
    score = per_slot[..., 0]
    for j in range(1, per_slot.shape[-1]):
        score = score + per_slot[..., j]
    return score, m.sum(dim=(-1, -2)).to(torch.int32)


def _rescore_fused_plain(fwd_fused, cand_rows, tids_q, idf_q):
    """Plain twin of K3: (scores [B, F] f32, counts [B, F] i32), 0 for dead rows."""
    l2 = fwd_fused.shape[1] // 2
    fz = fwd_fused[cand_rows.clamp(min=0).long()]  # [B, F, 2*L2]
    tids = fz[..., :l2]
    weights = fz[..., l2:].contiguous().view(torch.float32)
    scores, counts = _match_sums(tids, weights, tids_q, idf_q)
    dead = cand_rows < 0
    return torch.where(dead, 0.0, scores), torch.where(dead, 0, counts)


def rescore_fused(fwd_fused, cand_rows, tids_q, idf_q):
    """K3 wrapper: fwd_fused [N, 2*L2] i32, cand_rows [B, F] i32 (-1 dead), query
    slots tids_q [B, Q] i32 (-1 pad) and idf_q [B, Q] f32 -> (scores [B, F] f32,
    counts [B, F] i32)."""
    global K3_LAUNCHES
    if on_cpu(fwd_fused, cand_rows, tids_q, idf_q):
        return _rescore_fused_plain(fwd_fused, cand_rows, tids_q, idf_q)
    for name, t, dt in (("fwd_fused", fwd_fused, torch.int32), ("cand_rows", cand_rows, torch.int32),
                        ("tids_q", tids_q, torch.int32), ("idf_q", idf_q, torch.float32)):
        if t.dtype != dt or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dt} tensor, got {t.dtype} {tuple(t.shape)}")
    (b, f), q, w = cand_rows.shape, tids_q.shape[1], fwd_fused.shape[1]
    if w % 128 or w // 2 > _L2MAX or tids_q.shape != idf_q.shape or tids_q.shape[0] != b or q > _QMAX:
        raise ValueError(f"bad shapes: fwd_fused {tuple(fwd_fused.shape)}, cand_rows {(b, f)}, "
                         f"tids_q {tuple(tids_q.shape)}, idf_q {tuple(idf_q.shape)} "
                         f"(2*L2 a multiple of 128, L2 <= {_L2MAX}, Q <= {_QMAX})")
    scores = torch.empty((b, f), dtype=torch.float32, device=cand_rows.device)
    counts = torch.empty((b, f), dtype=torch.int32, device=cand_rows.device)
    if b and f:
        launch("wax_k3_rescore_fused", cand_rows.device, fwd_fused.data_ptr(), cand_rows.data_ptr(),
               tids_q.data_ptr(), idf_q.data_ptr(), scores.data_ptr(), counts.data_ptr(), b, f, q, w // 2)
        K3_LAUNCHES += 1
    return scores, counts


def exact_rescore_fused(term_ids, cand_rows, fwd_fused, idf):
    """Exact BM25 scores and matched-slot counts of candidate rows, against the fused
    forward index.

    Args:
      term_ids: [B, Q] i32 query term ids, -1 padding; duplicate ids count once per
        slot.
      cand_rows: [B, F] i32 candidate rows, -1 dead.
      fwd_fused: [N_cap, 2*L2] i32 (tids | f32 weight bits).
      idf: [T] f32.

    Returns (scores [B, F] f32, counts [B, F] i32), 0 on dead candidates.
    """
    tids_q, idf_q = _query_planes(term_ids, idf)
    return rescore_fused(fwd_fused, cand_rows.to(torch.int32).contiguous(), tids_q.contiguous(),
                         idf_q.contiguous())


def _rescore_split_plain(fwd_tids, fwd_wnorm, cand_rows, tids_q, idf_q, width: int):
    """Plain twin of K5: (scores [B, F] f32, counts [B, F] i32), 0 for dead rows."""
    safe = cand_rows.clamp(min=0).long()
    tids, weights = fwd_tids[safe][..., :width], fwd_wnorm[safe][..., :width]
    scores, counts = _match_sums(torch.where(weights > 0.0, tids, -1), weights, tids_q, idf_q)
    dead = cand_rows < 0
    return torch.where(dead, 0.0, scores), torch.where(dead, 0, counts)


def rescore_split(fwd_tids, fwd_wnorm, cand_rows, tids_q, idf_q, width: int):
    """K5 wrapper: fwd_tids [N, L] i32 and fwd_wnorm [N, L] f32 read over their first
    `width` lanes (64, the narrow form, or L), cand_rows [B, F] i32 (-1 dead), query
    slots tids_q [B, Q] i32 (-1 pad) and idf_q [B, Q] f32 -> (scores [B, F] f32,
    counts [B, F] i32)."""
    global K5_LAUNCHES
    if on_cpu(fwd_tids, fwd_wnorm, cand_rows, tids_q, idf_q):
        return _rescore_split_plain(fwd_tids, fwd_wnorm, cand_rows, tids_q, idf_q, width)
    for name, t, dt in (("fwd_tids", fwd_tids, torch.int32), ("fwd_wnorm", fwd_wnorm, torch.float32),
                        ("cand_rows", cand_rows, torch.int32), ("tids_q", tids_q, torch.int32),
                        ("idf_q", idf_q, torch.float32)):
        if t.dtype != dt or t.dim() != 2 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 2-D {dt} tensor, got {t.dtype} {tuple(t.shape)}")
    (b, f), q, l = cand_rows.shape, tids_q.shape[1], fwd_tids.shape[1]
    if (fwd_wnorm.shape != fwd_tids.shape or l % 32 or l > _L2MAX or width not in (_NARROW, l)
            or width > l or tids_q.shape != idf_q.shape or tids_q.shape[0] != b or q > _QMAX):
        raise ValueError(f"bad shapes: fwd_tids {tuple(fwd_tids.shape)}, fwd_wnorm {tuple(fwd_wnorm.shape)}, "
                         f"width {width}, cand_rows {(b, f)}, tids_q {tuple(tids_q.shape)}, idf_q "
                         f"{tuple(idf_q.shape)} (L a multiple of 32, L <= {_L2MAX}, width {_NARROW} or L, "
                         f"Q <= {_QMAX})")
    scores = torch.empty((b, f), dtype=torch.float32, device=cand_rows.device)
    counts = torch.empty((b, f), dtype=torch.int32, device=cand_rows.device)
    if b and f:
        launch("wax_k5_rescore_split", cand_rows.device, fwd_tids.data_ptr(), fwd_wnorm.data_ptr(),
               cand_rows.data_ptr(), tids_q.data_ptr(), idf_q.data_ptr(), scores.data_ptr(), counts.data_ptr(),
               b, f, q, l, width)
        K5_LAUNCHES += 1
    return scores, counts


def exact_rescore(term_ids, cand_rows, fwd_tids, fwd_wnorm, idf, fwd_width: int = 0):
    """`exact_rescore_fused` against separate forward arrays fwd_tids [N_cap, L] i32
    and fwd_wnorm [N_cap, L] f32 (kernel K5). `fwd_width`, the real forward width,
    selects the narrow form (the first 64 lanes) under the TPU kernel's condition:
    0 < fwd_width <= 64, L >= 128 and an even F."""
    tids_q, idf_q = _query_planes(term_ids, idf)
    l, f = fwd_tids.shape[1], cand_rows.shape[1]
    narrow = 0 < fwd_width <= _NARROW and l >= 128 and f % 2 == 0
    return rescore_split(fwd_tids, fwd_wnorm, cand_rows.to(torch.int32).contiguous(), tids_q.contiguous(),
                         idf_q.contiguous(), _NARROW if narrow else l)


def rescore_topk(term_ids, cand_rows, fwd_tids, fwd_wnorm, idf, k: int, mode: str,
                 fwd_width: int = 0, fwd_fused=None):
    """Top-k over exactly rescored candidates. Candidates are sorted by row first, so
    the stable top-k resolves ties to the lowest document row. Returns (vals [B, k],
    rows [B, k]) with NEG_INF / -1 on dead slots."""
    big = 2**30
    rows_sorted, _ = torch.sort(torch.where(cand_rows < 0, big, cand_rows.to(torch.int64)), dim=-1)
    rows_sorted = torch.where(rows_sorted >= big, -1, rows_sorted).to(torch.int32)
    if fwd_fused is not None:
        scores, counts = exact_rescore_fused(term_ids, rows_sorted, fwd_fused, idf)
    else:
        scores, counts = exact_rescore(term_ids, rows_sorted, fwd_tids, fwd_wnorm, idf, fwd_width)
    live = (rows_sorted >= 0) & (scores > 0.0)
    if mode == "all":
        nterm = (term_ids >= 0).sum(dim=1, keepdim=True).to(torch.int32)
        live = live & (counts >= nterm)
    masked = torch.where(live, scores, NEG_INF)
    kk = min(int(k), cand_rows.shape[-1])
    vals, pos = stable_top_k(masked, kk)
    sel = torch.gather(rows_sorted, 1, pos)
    sel = torch.where(vals > NEG_INF * 0.5, sel, -1)
    if kk < k:
        # the candidate window is narrower than the request: pad dead slots
        vals = torch.nn.functional.pad(vals, (0, k - kk), value=NEG_INF)
        sel = torch.nn.functional.pad(sel, (0, k - kk), value=-1)
    return vals, sel
