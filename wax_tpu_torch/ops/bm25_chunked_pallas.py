"""Chunked packed-postings BM25 candidate selection: kernel K4.

PyTorch port of `wax_tpu.ops.bm25_chunked_pallas` (the module keeps its name for
parity). A budget-truncated snapshot stores each term's postings as impact chunks of
PK_CHUNK = 1024 packed values `(row << qb) | quantized(idf * wnorm)`
(`index/lex.py build_impact_chunks`). A query's chunks are water-filled into a
fixed number of merge slots (all chunk-0s, then chunk-1s, ...: `pack_query_chunks`),
and the kernel merges the slots into one row-sorted plane, sums and counts each
row's postings, ranks them, and keeps the top 3 per slot position. Candidate RANKING
is quantized; the exact scores come from the forward-index rescore (K3).

`chunked_sel` is the kernel wrapper: on CUDA tensors it launches K4
(`csrc/bm25_chunked.cu`), on CPU tensors it runs the plain twin `_chunked_sel_plain`.
All arithmetic is integer, so the two agree bit for bit with each other and with the
JAX package. `K4_LAUNCHES` counts launches. The per-block reversed chunk copy the TPU
kernel reads (`pk_chunks_rev`) is not needed here.
"""
from __future__ import annotations

import ctypes

import torch

from wax_tpu_torch.index.lex import PK_CHUNK
from wax_tpu_torch.ops._build import launch, load_library, on_cpu

__all__ = ["chunked_candidates_sel", "chunked_sel", "pack_query_chunks", "slots_for_query", "launch_plan",
           "MIN_SLOTS", "K4_LAUNCHES"]

K4_LAUNCHES = 0
MIN_SLOTS = 32
_SEL_LEVELS = 3
_I32_MAX = 2**31 - 1
_I32_MIN = -(2**31)
_DEAD_RANK = 2**30


def pack_query_chunks(term_ids, chunk_base, chunk_counts, slots: int, max_chunks: int, dead_block: int):
    """Water-fill the query terms' impact chunks into `slots` merge slots: chunk (term
    i, impact level j) has fill rank j * Q + i, the first `slots` ranked live chunks
    get a slot, the rest are dropped; dead slots point at the sentinel block.
    Returns win [B, slots] i32 block indices."""
    if term_ids.dim() == 1:
        term_ids = term_ids[None, :]
    b, q = term_ids.shape
    dev = term_ids.device
    valid = term_ids >= 0
    safe = term_ids.clamp(min=0).long()
    counts = torch.where(valid, chunk_counts[safe], 0)  # [B, Q]
    base = chunk_base[safe]
    maxc = max(1, max_chunks)
    j = torch.arange(maxc, device=dev, dtype=torch.int32)[None, :, None]
    qi = torch.arange(q, device=dev, dtype=torch.int32)[None, None, :]
    live = j < counts[:, None, :]
    rank = torch.where(live, j * q + qi, _DEAD_RANK).reshape(b, maxc * q)
    blk = torch.where(live, base[:, None, :] + j, dead_block).reshape(b, maxc * q)
    _, order = torch.sort(rank, dim=-1, stable=True)
    blk_s = torch.gather(blk, 1, order)
    if maxc * q >= slots:
        win = blk_s[:, :slots]
    else:
        win = torch.nn.functional.pad(blk_s, (0, slots - maxc * q), value=dead_block)
    return win.to(torch.int32).contiguous()


def slots_for_query(q: int) -> int:
    """Merge-plane slot count: every term lands at least its top impact chunk
    (slots >= q), with a floor of 32; at most 128 (the rank key keeps the plane chunk
    index in 7 bits)."""
    s = MIN_SLOTS
    while s < q:
        s *= 2
    if s > 128:
        raise ValueError(f"chunked BM25 kernel supports at most 128 query terms, got {q}")
    return s


def _chunked_sel_plain(win, pk, qb: int, seg_log2: int, mode: str, sel: int):
    """Plain twin of K4: (rows, keys) [B, sel * 1024] i32."""
    b, slots = win.shape
    n = slots * PK_CHUNK
    plane = pk.reshape(-1, PK_CHUNK)[win.long()].reshape(b, n)
    x, _ = torch.sort(plane, dim=-1)  # equal values are identical: the order is unique
    rows = x >> qb  # packed values are non-negative
    qcon = x & ((1 << qb) - 1)
    live = (x != _I32_MAX) & (qcon > 0)
    val = torch.where(live, qcon, 0)
    cnt = live.to(torch.int32)
    flat = torch.arange(n, device=x.device)
    d = 1
    for _ in range(seg_log2):  # Hillis-Steele segmented sum and count (integers)
        ok = (flat >= d) & (torch.roll(rows, d, dims=-1) == rows)
        val = val + torch.where(ok, torch.roll(val, d, dims=-1), 0)
        cnt = cnt + torch.where(ok, torch.roll(cnt, d, dims=-1), 0)
        d *= 2
    leader = (rows != torch.roll(rows, -1, dims=-1)) | (flat == n - 1)
    live = leader & live & (val > 0)
    rank = cnt * 65536 + torch.clamp(val, max=65535) if mode == "count" else val
    chunk = (flat // PK_CHUNK).to(torch.int32)
    key = torch.where(live, rank * 128 + (127 - chunk), _I32_MIN).to(torch.int32)
    pay = torch.where(live, rows, -1).to(torch.int32)
    # per slot position, the `sel` largest keys over the chunks; live keys are unique
    # within a position (the chunk index is part of the key) and dead ones all carry
    # row -1, so a sort gives what the kernel's strict-'>' insertion gives
    kc = key.reshape(b, slots, PK_CHUNK)
    top, order = torch.sort(kc, dim=1, descending=True, stable=True)
    tops = top[:, :sel]
    pays = torch.gather(pay.reshape(b, slots, PK_CHUNK), 1, order[:, :sel])
    return pays.reshape(b, sel * PK_CHUNK), tops.reshape(b, sel * PK_CHUNK)


def chunked_sel(win, pk, *, qb: int, seg_log2: int, mode: str = "any", sel: int = _SEL_LEVELS):
    """K4 wrapper: win [B, slots] i32 chunk blocks of pk [PB * 1024] i32 -> (rows,
    keys) [B, sel * 1024] i32: per (slot position p, level l) at l * 1024 + p the
    l-th best rank key of the positions c * 1024 + p, with its row (-1 dead)."""
    global K4_LAUNCHES
    if on_cpu(win, pk):
        return _chunked_sel_plain(win, pk, qb, seg_log2, mode, sel)
    b, slots = win.shape
    if win.dtype != torch.int32 or pk.dtype != torch.int32 or not (win.is_contiguous() and pk.is_contiguous()):
        raise ValueError("win and pk must be contiguous int32 tensors")
    if slots not in (32, 64, 128) or pk.shape[0] % PK_CHUNK or not 1 <= sel <= 4 or not 6 <= qb <= 12:
        raise ValueError(f"bad K4 arguments: slots={slots}, pk {tuple(pk.shape)}, sel={sel}, qb={qb}")
    rows = torch.empty((b, sel * PK_CHUNK), dtype=torch.int32, device=win.device)
    keys = torch.empty_like(rows)
    # 32 slots: the plane lives in registers and shared memory; 64 and 128 slots merge
    # in a global scratch plane
    scratch = None if slots == MIN_SLOTS else torch.empty((b, slots * PK_CHUNK), dtype=torch.int32, device=win.device)
    if b:
        launch("wax_k4_chunked_sel", win.device, win.data_ptr(), pk.data_ptr(), rows.data_ptr(),
               keys.data_ptr(), 0 if scratch is None else scratch.data_ptr(), b, slots, qb, seg_log2,
               int(mode == "count"), sel)
        K4_LAUNCHES += 1
    return rows, keys


def launch_plan() -> dict:
    """How K4's 32-slot body launches on the current CUDA device (builds the kernels;
    needs a card)."""
    out = (ctypes.c_int * 3)()
    err = load_library().wax_k4_plan(ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"wax_k4_plan failed: CUDA error {err}")
    return dict(zip(("threads", "smem_bytes", "ctas_per_sm"), out))


def chunked_candidates_sel(term_ids, pk_chunks, chunk_base, chunk_counts, *, qb: int, max_chunks: int,
                           mode: str = "any", sel: int = _SEL_LEVELS):
    """[B, Q] term ids -> (rows, keys) [B, sel * 1024]: the per-slot top-`sel`
    candidates as i32 keys monotone in (quantized budgeted score | matched count),
    rows -1 dead. mode "count" ranks by matched count first (AND queries)."""
    if term_ids.dim() == 1:
        term_ids = term_ids[None, :]
    term_ids = term_ids.to(pk_chunks.device, torch.int32)
    q = term_ids.shape[1]
    slots = slots_for_query(q)
    win = pack_query_chunks(term_ids, chunk_base, chunk_counts, slots, max_chunks,
                            pk_chunks.shape[0] // PK_CHUNK - 1)
    seg_log2 = 1  # a row repeats at most once per query term slot
    while (1 << seg_log2) < 2 * q:
        seg_log2 += 1
    return chunked_sel(win, pk_chunks, qb=qb, seg_log2=seg_log2, mode=mode, sel=sel)
