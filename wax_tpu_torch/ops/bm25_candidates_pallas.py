"""Unchunked candidate-set BM25: kernel K8 and the top-k around it.

PyTorch port of `wax_tpu.ops.bm25_candidates_pallas` (the module keeps its name for
parity). Per query, each term slot's CSR slice (rows ascending, tf-normalised weight
precomputed) stands in a window of W2 = `dma_window(max_df)` plane positions, the
windows merge into one row-sorted plane of Q2 * W2 elements, each row's postings are
summed and counted at the row's last plane position (its leader), and the plane, or in
`sel` mode the top 3 leaders of each of its 1,024 slot positions, comes back.

`candidate_scores_pallas` is the kernel wrapper: on CUDA tensors it launches K8
(`csrc/bm25_candidates.cu`), on CPU tensors it runs the plain twin
`_candidate_scores_plain`. The two agree bit for bit on any data; `K8_LAUNCHES` counts
launches. Neither runs the TPU's merge network: the plane is fixed by the multiset of
postings, so both compute each leader's position directly, and both sum a row's
postings in query-slot order (the TPU sums them in network order, which can differ in
the last bit: ROADMAP, deliberate differences).

Left out: the per-term reversed postings copies `doc_rows_rev` / `wnorm_rev` and the
window padding of the postings arrays, TPU-only layout the TPU kernel's DMAs read.
"""
from __future__ import annotations

import torch

from wax_tpu_torch.index.lex import LexIndex
from wax_tpu_torch.ops._build import launch, on_cpu
from wax_tpu_torch.ops.bm25_candidates import wide_topk
from wax_tpu_torch.ops.bm25_chunked_pallas import _SEL_LEVELS, chunked_candidates_sel
from wax_tpu_torch.ops.bm25_rescore import rescore_topk
from wax_tpu_torch.ops.topk import NEG_INF, stable_top_k

__all__ = ["bm25_candidates_topk_pallas", "candidate_scores_pallas", "dma_window", "K8_LAUNCHES"]

K8_LAUNCHES = 0
_ALIGN = 1024  # plane positions per chunk (the TPU's (8, 128) tile)
_SEL_MAX = 4
_MAX_SLOTS = 1024  # the kernel sets up one term slot per thread
_MAX_SEL_CHUNKS = 8192  # the selection key holds the chunk index in 13 bits
_IMIN = -(2**31)
_MODES = {"any": 0, "all": 1, "count": 2}


def dma_window(max_df: int) -> int:
    """The per-term window of the candidate plane: the power of two >= max_df + 1024
    (at least 2048), so a slice starting anywhere in a 1,024-aligned block fits."""
    w = 2048
    while w < max_df + 1024:
        w *= 2
    return w


def _slots(term_ids, offsets, idf, q2: int, w2: int):
    """Per (query, slot): slice start and length of the postings the window holds
    (odd slots hold a slice's tail, as the TPU's reversed copies do), the slot's idf,
    and per query the count of leading -1 plane sentinels and of valid terms."""
    b, q = term_ids.shape
    valid = term_ids >= 0
    safe = term_ids.clamp(min=0).long()
    off_all = offsets.long()
    offs = torch.where(valid, off_all[safe], 0)
    lens = torch.where(valid, off_all[safe + 1] - off_all[safe], 0)
    idfs = torch.where(valid, idf[safe], 0.0).float()
    if q2 > q:
        pad = (0, q2 - q)
        offs, lens, idfs = (torch.nn.functional.pad(x, pad) for x in (offs, lens, idfs))
    dlt = offs % _ALIGN
    eff = torch.minimum(lens, w2 - dlt)
    odd = (torch.arange(q2, device=term_ids.device) % 2 == 1)[None, :]
    start = torch.where(odd, offs + lens - eff, offs)
    n_neg = torch.where(odd, w2 - dlt - eff, dlt).sum(dim=1)
    return start, eff, idfs, n_neg, valid.sum(dim=1)


def _candidate_scores_plain(term_ids, doc_rows, wnorm, offsets, idf, q2: int, w2: int, mode: str, sel: int):
    """Plain twin of K8: the same outputs as `candidate_scores_pallas`."""
    b = term_ids.shape[0]
    dev = doc_rows.device
    start, eff, idfs, n_neg, nterm = _slots(term_ids, offsets, idf, q2, w2)
    n_rows = int(doc_rows.max()) + 1 if doc_rows.numel() else 1
    acc = torch.zeros(b * n_rows, dtype=torch.float32, device=dev)
    cnt = torch.zeros(b * n_rows, dtype=torch.int32, device=dev)
    width = int(eff.max()) if eff.numel() else 0
    j = torch.arange(width, device=dev)[None, :]
    qrow = torch.arange(b, device=dev)[:, None] * n_rows
    for s in range(q2):  # slot order: the kernel's summation order
        m = j < eff[:, s, None]
        idx = (start[:, s, None] + j).clamp(0, max(doc_rows.shape[0] - 1, 0))
        flat = (qrow + doc_rows[idx].long())[m]  # rows are unique within a slot
        acc[flat] = acc[flat] + (idfs[:, s, None] * wnorm[idx])[m]
        cnt[flat] = cnt[flat] + 1
    acc, cnt = acc.reshape(b, n_rows), cnt.reshape(b, n_rows)
    live = (cnt > 0) & (acc > 0.0)
    if mode == "all":
        live = live & (cnt >= nterm[:, None])
    score = acc + 4096.0 * cnt.float() if mode == "count" else acc
    pos = n_neg[:, None] + torch.cumsum(cnt, dim=1) - 1
    bi, ri = live.nonzero(as_tuple=True)
    n = q2 * w2
    rows = torch.full((b, n), -1, dtype=torch.int32, device=dev)
    scores = torch.full((b, n), NEG_INF, dtype=torch.float32, device=dev)
    rows[bi, pos[bi, ri]] = ri.to(torch.int32)
    scores[bi, pos[bi, ri]] = score[bi, ri]
    if not sel:
        return rows, scores
    bits = scores.view(torch.int32)
    key = torch.where(bits >= 0, bits, torch.bitwise_not(bits) ^ _IMIN)
    chunk = (torch.arange(n, device=dev) // _ALIGN).to(torch.int32)
    key = (key & ~0x1FFF) | (0x1FFF - chunk)
    # per slot position the `sel` largest keys over the chunks: keys are unique within
    # a position (the chunk is part of the key), so a sort gives the kernel's insertion
    top, order = torch.sort(key.reshape(b, n // _ALIGN, _ALIGN), dim=1, descending=True, stable=True)
    pays = torch.gather(rows.reshape(b, n // _ALIGN, _ALIGN), 1, order[:, :sel])
    return pays.reshape(b, sel * _ALIGN), top[:, :sel].reshape(b, sel * _ALIGN)


def candidate_scores_pallas(term_ids, doc_rows, wnorm, offsets, idf, *, max_df: int, mode: str = "any",
                            sel: int = 0):
    """K8 wrapper, the TPU kernel's raw-array entry without its reversed copies:
    [B, Q] term ids -> (rows, scores) [B, Q2*W2], Q2 the power of two >= max(Q, 2) and
    W2 = dma_window(max_df); max_df must hold every queried term's postings.

    Scores carry NEG_INF and rows -1 on every position but a live leader (sum > 0;
    "all": every valid query term matched; "count": score + 4096 * matched count).

    sel > 0 (rescore-fetch mode): (rows [B, sel*1024] with -1 dead, keys [B, sel*1024]
    i32), per slot position p at l * 1024 + p the l-th largest key of the plane
    positions c * 1024 + p, key = (sortable score bits & ~0x1FFF) | (0x1FFF - c): monotone
    in the score truncated to 2^-10 relative, ties toward the lower plane position."""
    global K8_LAUNCHES
    if term_ids.dim() == 1:
        term_ids = term_ids[None, :]
    if mode not in _MODES:
        raise ValueError(f"unknown mode {mode!r}")
    b, q = term_ids.shape
    q2 = 2
    while q2 < q:
        q2 *= 2
    w2 = dma_window(int(max_df))
    if q2 > _MAX_SLOTS or not 0 <= sel <= _SEL_MAX:
        raise ValueError(f"K8 takes at most {_MAX_SLOTS} query terms and 0 <= sel <= {_SEL_MAX}, got Q={q}, sel={sel}")
    if q2 * w2 >= 2**31:
        raise ValueError(f"K8 indexes its plane with 32-bit positions: Q2 * W2 must stay below 2^31, got "
                         f"Q2={q2} x W2={w2}")
    if sel and q2 * w2 // _ALIGN > _MAX_SEL_CHUNKS:
        raise ValueError(f"sel mode needs Q2 * W2 <= {_MAX_SEL_CHUNKS * _ALIGN} plane positions (the key's "
                         f"13 chunk bits), got Q2={q2} x W2={w2}")
    term_ids = term_ids.to(doc_rows.device, torch.int32).contiguous()
    if on_cpu(term_ids, doc_rows, wnorm, offsets, idf):
        return _candidate_scores_plain(term_ids, doc_rows, wnorm, offsets, idf, q2, w2, mode, sel)
    for name, t, dt in (("doc_rows", doc_rows, torch.int32), ("wnorm", wnorm, torch.float32),
                        ("offsets", offsets, torch.int32), ("idf", idf, torch.float32)):
        if t.dtype != dt or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D {dt} tensor, got {t.dtype} {tuple(t.shape)}")
    width = sel * _ALIGN if sel else q2 * w2
    rows = torch.empty((b, width), dtype=torch.int32, device=doc_rows.device)
    scores = torch.empty((b, width), dtype=torch.int32 if sel else torch.float32, device=doc_rows.device)
    if b:
        launch("wax_k8_candidates", doc_rows.device, term_ids.data_ptr(), offsets.data_ptr(), idf.data_ptr(),
               doc_rows.data_ptr(), wnorm.data_ptr(), rows.data_ptr(), 0 if sel else scores.data_ptr(),
               scores.data_ptr() if sel else 0, b, q, q2, w2, _MODES[mode], sel)
        K8_LAUNCHES += 1
    return rows, scores


def bm25_candidates_topk_pallas(term_ids, index: LexIndex, k: int, mode: str = "any", fetch: int | None = None):
    """Candidate-set BM25 top-k through the kernels, the contract of `bm25_topk`.

    Unbudgeted snapshot: K8, then the stable wide top-k. Budgeted (a forward index is
    present): candidates are generated OR-mode ("count"-ranked for AND queries), by K4
    when the snapshot carries impact chunks, else by K8 with in-kernel selection, and
    the top-`fetch` (default max(4k, 256)) are rescored exactly (K3).

    Returns (scores [B, k], rows [B, k], frame_ids [B, k]); non-matches (NEG_INF, -1, -1)."""
    if index.wnorm is None:
        raise ValueError("snapshot has no precomputed wnorm")
    k = int(min(k, index.frame_ids.shape[0]))
    term_ids = torch.as_tensor(term_ids).to(index.device, torch.int32)
    if term_ids.dim() == 1:
        term_ids = term_ids[None, :]
    if index.fwd_tids is not None:
        gen_mode = "count" if mode == "all" else "any"
        if index.pk_chunks is not None:
            cand_rows, keys = chunked_candidates_sel(term_ids, index.pk_chunks, index.chunk_base,
                                                     index.chunk_counts, qb=index.pk_qb,
                                                     max_chunks=index.pk_max_chunks, mode=gen_mode, sel=_SEL_LEVELS)
        else:
            cand_rows, keys = candidate_scores_pallas(term_ids, index.doc_rows, index.wnorm, index.offsets,
                                                      index.idf, max_df=int(index.max_df), mode=gen_mode,
                                                      sel=_SEL_LEVELS)
        f = int(min(fetch if fetch is not None else max(4 * k, 256), keys.shape[-1]))
        _, cpos = stable_top_k(keys, f)
        crows = torch.gather(cand_rows, 1, cpos)
        vals, sel = rescore_topk(term_ids, crows, index.fwd_tids, index.fwd_wnorm, index.idf, k, mode,
                                 fwd_width=index.fwd_width, fwd_fused=index.fwd_fused)
    else:
        out_rows, out_scores = candidate_scores_pallas(term_ids, index.doc_rows, index.wnorm, index.offsets,
                                                       index.idf, max_df=int(index.max_df), mode=mode)
        vals, pos = wide_topk(out_scores, k)
        sel = torch.gather(out_rows, 1, pos)
    ok = vals > NEG_INF * 0.5
    sel = torch.where(ok, sel, 0).long()
    fids = torch.where(ok, index.frame_ids[sel], -1).to(torch.int32)
    return vals, torch.where(ok, sel, -1).to(torch.int32), fids
