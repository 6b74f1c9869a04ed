"""Brute-force dense scan with top-k: the port's performance core.

PyTorch port of `wax_tpu.ops.flat_scan`. Backends, as in the JAX package:

  * "xla":      full f32 score matrix + stable top-k (the name is kept for parity;
                here it is plain torch). Correctness oracle.
  * "pallas" / "pallas_exact": kernel K2 (csrc/flat_scan.cu `wax_k2_scan_topk`), the
                fused scan with per-tile top-k by (score desc, column asc). Its scores
                are 3xTF32 tensor-core sums: exact on data TF32 holds (the 1/8 grid,
                any bf16), within ~1e-6 of the f32 sums elsewhere, where ids may differ
                from the plain twin's only among near-ties of the k-th score.
  * "pallas_packed_sel": kernel K1 (csrc/flat_scan.cu `wax_k1_packed_sel`), per-tile
                top-k over packed i32 keys whose scores are truncated to 2^-12
                relative. What "auto" picks at mid N. K1 and K2 share one body on
                3xTF32 tensor-core scores; a (query block, tile) pair is split over a
                cluster of `scan_plan(...)["split"]` CTAs to fill the card.
  * "blockmax" / "blockmax16": exact chunk-max pruned top-k in plain torch (the
                second with a bf16 coarse pass and an exact f32 rescore).
  * "chunkmax": kernels K6 (per-128-row chunk maxima) and K7 (exact rescore of the
                winning chunks), `ops/chunkmax_scan.py`. What "auto" picks at 512K
                rows and more on a contiguous index.
  * "pallas_packed": kernel K9 (csrc/packed_topk.cu `wax_k9_packed_topk`), K1's
                per-tile packed-key top-k with the scores on tensor cores (3xTF32,
                within ~1e-6 of the f32 sums). It returns K1's keys except between
                scores that straddle a 2^-12 bucket edge by that much (K1 does the
                same since it moved onto the tensor cores).

Each kernel wrapper takes its plain torch twin (`_packed_sel_topk_plain` for K1 and
K9, `_scan_topk_plain` for K2) only when its tensors lie on the CPU; for CUDA tensors
it launches the kernel or raises. `K1_LAUNCHES`, `K2_LAUNCHES` and `K9_LAUNCHES` count
launches.

Masking: tombstones and padding are excluded through an additive bias row (0 for
live rows, NEG_INF otherwise).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from wax_tpu_torch.index.dense import DenseIndex, Similarity
from wax_tpu_torch.ops._build import launch, load_library, on_cpu
from wax_tpu_torch.ops.topk import NEG_INF, blockmax_topk, masked_top_k, stable_top_k
from wax_tpu_torch.utils.device import full_f32_matmul

__all__ = [
    "flat_scan_topk",
    "scan_scores",
    "normalize_rows",
    "packed_sel_tiles",
    "packed_topk_tiles",
    "scan_topk_tiles",
    "scan_plan",
    "launch_plan",
    "K1_LAUNCHES",
    "K2_LAUNCHES",
    "K9_LAUNCHES",
]

# Launch counters of the kernels: each wrapper adds one where it launches.
K1_LAUNCHES = 0
K2_LAUNCHES = 0
K9_LAUNCHES = 0

# Corpus tile width: the widest candidate dividing the capacity (the builder keeps
# capacity a multiple of 512). The packed key's 11 column bits cap it at 2048.
_TN = 512
_TN_CANDIDATES = (2048, 1024, 512)
_KMAX = 128  # per-tile lists hold at most 128 entries

_IMIN = -(2**31)
_COL_BITS = 11
_COL_MASK = (1 << _COL_BITS) - 1


def _pick_tn(capacity: int) -> int:
    for t in _TN_CANDIDATES:
        if capacity % t == 0:
            return t
    return min(_TN, capacity)


def normalize_rows(x: torch.Tensor, eps: float = 1e-30) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return torch.where(n > 0, x / n.clamp(min=eps), x)


def _index_bias(index: DenseIndex) -> torch.Tensor:
    """[capacity] f32 additive bias: 0 for live rows, NEG_INF for padding/tombstones."""
    rows = torch.arange(index.capacity, device=index.device)
    live = index.active & (rows < index.count)
    zero = torch.zeros((), dtype=torch.float32, device=index.device)
    return torch.where(live, zero, NEG_INF)


# rows widened at once: a bf16 block is widened to f32 before its product, and 2.6M
# rows at d 768 would take an 8 GB temporary
_ROW_BLOCK = 1 << 20


@full_f32_matmul
def _scores_f32(q: torch.Tensor, emb: torch.Tensor, bias: torch.Tensor | None = None) -> torch.Tensor:
    """[B, N] f32 dot products, plus the row bias when given. bf16 operands are
    widened first, _ROW_BLOCK rows at a time (their products are exact in f32), so
    every path accumulates in f32, TF32 turned on or not."""
    qf, n = q.float(), emb.shape[0]
    if n <= _ROW_BLOCK:
        scores = torch.matmul(qf, emb.float().t())
        return scores if bias is None else scores + bias[None, :]
    out = torch.empty((q.shape[0], n), dtype=torch.float32, device=emb.device)
    for lo in range(0, n, _ROW_BLOCK):
        hi = min(n, lo + _ROW_BLOCK)
        out[:, lo:hi] = torch.matmul(qf, emb[lo:hi].float().t())
        if bias is not None:
            out[:, lo:hi] += bias[None, lo:hi]
    return out


def scan_scores(queries: torch.Tensor, index: DenseIndex) -> torch.Tensor:
    """Full [B, capacity] masked score matrix (the "xla" path's building block)."""
    scores = _scores_f32(queries.to(index.emb.dtype), index.emb)
    if index.similarity == Similarity.EUCLIDEAN:
        # ||q - d||^2 = ||q||^2 - 2 q.d + ||d||^2 ; rank by negated distance.
        qn = (queries.float() ** 2).sum(dim=-1, keepdim=True)
        dn = (index.emb.float() ** 2).sum(dim=-1)[None, :]
        scores = -(qn - 2.0 * scores + dn)
    return scores + _index_bias(index)[None, :]


def _merge_tiles(vals: torch.Tensor, rows: torch.Tensor, k: int):
    """Merge per-tile candidates laid out (tile asc, rank) with a stable top-k, so
    ties resolve to the lowest global row; dead slots get row -1."""
    mv, pos = stable_top_k(vals, k)
    mi = torch.gather(rows, 1, pos)
    mi = torch.where(mv <= NEG_INF * 0.5, -1, mi)
    return mv, mi.to(torch.int32)


def _check_kernel_args(q, emb, bias, k: int, tn: int) -> None:
    if q.dim() != 2 or emb.dim() != 2 or q.shape[1] != emb.shape[1]:
        raise ValueError(f"need q [B, d] and emb [N, d], got {tuple(q.shape)} and {tuple(emb.shape)}")
    if q.dtype != emb.dtype or q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q and emb must both be float32 or both bfloat16, got {q.dtype}, {emb.dtype}")
    if bias.dtype != torch.float32 or bias.shape != (emb.shape[0],):
        raise ValueError(f"bias must be f32 [N], got {bias.dtype} {tuple(bias.shape)}")
    if not (q.is_contiguous() and emb.is_contiguous() and bias.is_contiguous()):
        raise ValueError("q, emb and bias must be contiguous")
    if tn % 128 or tn > _COL_MASK + 1 or emb.shape[0] % tn:
        raise ValueError(f"tile width {tn} must be a multiple of 128, <= 2048 and divide N={emb.shape[0]}")
    if not 1 <= k <= min(_KMAX, tn):
        raise ValueError(f"k={k} outside [1, {min(_KMAX, tn)}]")


# ---------------------------------------------------------------------------------
# K1 and K2's launch: the cluster split
# ---------------------------------------------------------------------------------

_QB = 64  # queries per CTA
_SPLITS = (1, 2, 4, 8)  # CTAs per (query block, tile) pair: a thread-block cluster


def scan_plan(b: int, n: int, tn: int, k: int, sms: int) -> dict:
    """How K1 and K2 split their work for b queries over n rows in tiles of tn, k per
    tile, on a card of `sms` SMs: each (64-query block, tile) pair goes to a cluster of
    `split` CTAs, each over tn / split rows (a multiple of 128). The split is the
    smallest whose grid reaches `sms` CTAs, else the largest allowed.

    Returns {"split": S, "grid": (S, query blocks, tiles), "ctas": their product}."""
    if not 1 <= k <= min(_KMAX, tn):
        raise ValueError(f"k={k} outside [1, {min(_KMAX, tn)}]")
    pairs = -(-b // _QB) * (n // tn)
    allowed = [s for s in _SPLITS if tn % (128 * s) == 0]
    split = next((s for s in allowed if pairs * s >= sms), allowed[-1])
    return {"split": split, "grid": (split, -(-b // _QB), n // tn), "ctas": pairs * split}


@functools.lru_cache(maxsize=None)
def _sms(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _split_for(q, emb, k: int, tn: int, split: int | None) -> int:
    if split is None:
        return scan_plan(q.shape[0], emb.shape[0], tn, k, _sms(q.device.index or 0))["split"]
    if split not in _SPLITS or tn % (128 * split):
        raise ValueError(f"split {split} must be one of {_SPLITS} with tile width {tn} a multiple of 128 * split")
    return split


def launch_plan(b: int, n: int, tn: int, k: int, *, dtype=torch.float32, exact: bool = False,
                device=None) -> dict:
    """scan_plan on this card, with what the C side reports for K1's (K2's with
    `exact`) launch: dynamic shared memory per CTA, CTAs per SM, co-resident clusters,
    threads, ring stages and warp counts. Launches nothing; needs a card."""
    dev = torch.device(device if device is not None else "cuda")
    plan = scan_plan(b, n, tn, k, _sms(dev.index or 0))
    out = (ctypes.c_int * 7)()
    with torch.cuda.device(dev):
        err = load_library().wax_flat_scan_plan(int(exact), int(dtype == torch.bfloat16), b, n, tn, k,
                                                plan["split"], ctypes.cast(out, ctypes.c_void_p))
    if err:
        raise RuntimeError(f"wax_flat_scan_plan failed: CUDA error {err}")
    keys = ("smem_bytes", "ctas_per_sm", "max_active_clusters", "threads", "stages", "consumer_warps",
            "producer_warps")
    return {**plan, **dict(zip(keys, out))}


# ---------------------------------------------------------------------------------
# K1: packed-key per-tile top-k
# ---------------------------------------------------------------------------------


def _packed_keys(scores: torch.Tensor, tn: int) -> torch.Tensor:
    """[B, N] f32 -> i32 keys: sortable score bits with the low 11 bits replaced by
    (2047 - column within the tile). Unique within a tile, ordered like the scores
    at 2^-12 relative precision, ties to the lowest column."""
    bits = scores.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, torch.bitwise_not(bits) ^ _IMIN)
    cols = torch.arange(scores.shape[1], device=scores.device, dtype=torch.int32) % tn
    return (key & ~_COL_MASK) | (_COL_MASK - cols)


def _packed_sel_topk_plain(q, emb, bias, k: int, tn: int) -> torch.Tensor:
    """Plain twin of K1: per-tile k largest packed keys, [B, N/tn * k] i32, each
    tile's k sorted descending."""
    b, n = q.shape[0], emb.shape[0]
    keys = _packed_keys(_scores_f32(q, emb) + bias[None, :], tn).reshape(b, n // tn, tn)
    top, _ = torch.sort(keys, dim=-1, descending=True, stable=True)
    return top[:, :, :k].reshape(b, -1)


def packed_sel_tiles(q, emb, bias, k: int, tn: int, split: int | None = None) -> torch.Tensor:
    """K1 wrapper: per-tile packed keys [B, N/tn * k] (kernel on CUDA, plain twin on
    the CPU). `split` forces the CTAs per (query block, tile) pair; by default
    `scan_plan` picks it. Equal to the plain twin bit for bit where TF32 holds the
    inputs exactly (the 1/8 grid, any bf16 data); elsewhere a key may differ at a
    2^-12 bucket edge."""
    global K1_LAUNCHES
    if on_cpu(q, emb, bias):
        return _packed_sel_topk_plain(q, emb, bias, k, tn)
    _check_kernel_args(q, emb, bias, k, tn)
    b, (n, d) = q.shape[0], emb.shape
    out = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
    if b:
        launch("wax_k1_packed_sel", q.device, q.data_ptr(), emb.data_ptr(), bias.data_ptr(),
               out.data_ptr(), b, n, d, tn, k, int(q.dtype == torch.bfloat16), _split_for(q, emb, k, tn, split))
        K1_LAUNCHES += 1
    return out


def _decode_packed(keys: torch.Tensor, k: int, tn: int):
    """[B, nn*k] packed keys -> (truncated f32 scores, global rows), same layout."""
    b = keys.shape[0]
    p = keys.reshape(b, -1, k)
    local = _COL_MASK - (p & _COL_MASK)
    gcol = torch.arange(p.shape[1], device=keys.device, dtype=torch.int32)[None, :, None] * tn + local
    keym = p & ~_COL_MASK
    sbits = torch.where(keym >= 0, keym, torch.bitwise_not(keym ^ _IMIN))
    return sbits.view(torch.float32).reshape(b, -1), gcol.reshape(b, -1)


def _packed_sel_scan_topk(q, emb, bias, k: int, tn: int):
    svals, gcol = _decode_packed(packed_sel_tiles(q, emb, bias, k, tn), k, tn)
    return _merge_tiles(svals, gcol, k)


# ---------------------------------------------------------------------------------
# K9: packed-key per-tile top-k on tensor cores
# ---------------------------------------------------------------------------------


def packed_topk_tiles(q, emb, bias, k: int, tn: int) -> torch.Tensor:
    """K9 wrapper: K1's function, [B, N/tn * k] i32 per-tile packed keys, with 3xTF32
    tensor-core scores (kernel on CUDA, the shared plain twin `_packed_sel_topk_plain`
    on the CPU). Equal to K1 bit for bit where TF32 holds the inputs exactly (the 1/8
    grid, any bf16 data); elsewhere a key may differ at a 2^-12 bucket edge."""
    global K9_LAUNCHES
    if on_cpu(q, emb, bias):
        return _packed_sel_topk_plain(q, emb, bias, k, tn)
    _check_kernel_args(q, emb, bias, k, tn)
    b, (n, d) = q.shape[0], emb.shape
    out = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
    if b:
        launch("wax_k9_packed_topk", q.device, q.data_ptr(), emb.data_ptr(), bias.data_ptr(),
               out.data_ptr(), b, n, d, tn, k, int(q.dtype == torch.bfloat16))
        K9_LAUNCHES += 1
    return out


def _packed_scan_topk(q, emb, bias, k: int, tn: int):
    svals, gcol = _decode_packed(packed_topk_tiles(q, emb, bias, k, tn), k, tn)
    return _merge_tiles(svals, gcol, k)


# ---------------------------------------------------------------------------------
# K2: exact per-tile top-k
# ---------------------------------------------------------------------------------


def _scan_topk_plain(q, emb, bias, k: int, tn: int):
    """Plain twin of K2: per tile the k best by (f32 score desc, column asc) as
    (vals f32, global rows i32), each [B, N/tn * k]."""
    b, n = q.shape[0], emb.shape[0]
    scores = (_scores_f32(q, emb) + bias[None, :]).reshape(b, n // tn, tn)
    vals, local = stable_top_k(scores, k)
    base = torch.arange(n // tn, device=q.device)[None, :, None] * tn
    return vals.reshape(b, -1), (local + base).to(torch.int32).reshape(b, -1)


def scan_topk_tiles(q, emb, bias, k: int, tn: int, split: int | None = None):
    """K2 wrapper: per-tile (vals, rows) [B, N/tn * k] (kernel on CUDA, plain twin on
    the CPU); `split` as for K1. The kernel's values are 3xTF32 sums: equal to the
    twin's on the 1/8 grid and bf16 data, within ~1e-6 elsewhere."""
    global K2_LAUNCHES
    if on_cpu(q, emb, bias):
        return _scan_topk_plain(q, emb, bias, k, tn)
    _check_kernel_args(q, emb, bias, k, tn)
    b, (n, d) = q.shape[0], emb.shape
    vals = torch.empty((b, n // tn * k), dtype=torch.float32, device=q.device)
    rows = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
    if b:
        launch("wax_k2_scan_topk", q.device, q.data_ptr(), emb.data_ptr(), bias.data_ptr(),
               vals.data_ptr(), rows.data_ptr(), b, n, d, tn, k, int(q.dtype == torch.bfloat16),
               _split_for(q, emb, k, tn, split))
        K2_LAUNCHES += 1
    return vals, rows


def _pallas_scan_topk(q, emb, bias, k: int, tn: int):
    vals, rows = scan_topk_tiles(q, emb, bias, k, tn)
    return _merge_tiles(vals, rows, k)


# ---------------------------------------------------------------------------------
# Block-max top-k (exact, plain torch)
# ---------------------------------------------------------------------------------


def _blockmax_topk(q, emb, bias, k: int):
    vals, rows = blockmax_topk(_scores_f32(q, emb) + bias[None, :], k)
    rows = torch.where(vals <= NEG_INF * 0.5, -1, rows)
    return vals, rows


@full_f32_matmul
def _blockmax16_topk(q, emb, bias, k: int):
    """blockmax over bf16-rounded scores, then an exact f32 rescore of the top
    max(2k, k+16) candidates, ranked by (exact score desc, row asc); the rescore in f32
    whatever the TF32 setting."""
    n = emb.shape[0]
    coarse = (_scores_f32(q, emb) + bias[None, :]).to(torch.bfloat16)
    rw = int(min(max(2 * k, k + 16), n))
    _, cand = blockmax_topk(coarse, rw)  # [B, RW] distinct rows
    cand = cand.long()
    rows = emb[cand].float()  # [B, RW, d]
    exact = torch.einsum("brd,bd->br", rows, q.float()) + bias[cand]
    # (exact desc, row asc): order by row first, then a stable sort by score
    o1 = torch.argsort(cand, dim=-1, stable=True)
    cand, exact = torch.gather(cand, 1, o1), torch.gather(exact, 1, o1)
    vals, o2 = stable_top_k(exact, k)
    out_rows = torch.gather(cand, 1, o2)
    out_rows = torch.where(vals <= NEG_INF * 0.5, -1, out_rows)
    return vals, out_rows.to(torch.int32)


# ---------------------------------------------------------------------------------
# Public API
# ---------------------------------------------------------------------------------


def _frame_ids(index: DenseIndex, rows: torch.Tensor) -> torch.Tensor:
    safe = rows.clamp(min=0).long()
    return torch.where(rows >= 0, index.frame_ids[safe], -1).to(torch.int32)


def _xla_scan_topk(queries, index: DenseIndex, k: int):
    vals, idx = masked_top_k(scan_scores(queries, index), k)
    return vals, idx, _frame_ids(index, idx)


def flat_scan_topk(queries: torch.Tensor, index: DenseIndex, k: int, *, backend: str = "auto"):
    """Batched dense top-k scan.

    Args:
      queries: [B, dim] query matrix (normalised by the caller for cosine), on the
        index's device.
      index: DenseIndex snapshot.
      k: top-k.
      backend: "auto" | "xla" | "pallas" / "pallas_exact" (K2, exact) |
        "pallas_packed_sel" (K1; scores compared and returned at 2^-12 relative, ties
        to the lowest row) | "pallas_packed" (K9; K1's ids, except between keys within
        one 2^-12 bucket) | "blockmax" | "blockmax16" | "chunkmax" (K6 + K7, exact;
        needs capacity % 2048 == 0 and a contiguous index).

    Returns:
      (scores [B, k] f32, rows [B, k] int32 row indices into index.emb,
       frame_ids [B, k] int32); empty slots carry score NEG_INF and index -1.
    """
    if queries.dim() == 1:
        queries = queries[None, :]
    b, d = queries.shape
    if d != index.dim:
        raise ValueError(f"query dim {d} != index dim {index.dim}")
    k = int(min(k, index.capacity))

    if backend == "auto":
        # The JAX package's thresholds, kept for parity of behaviour. They were set on
        # another device and still await measurement on this one (ROADMAP queue 1,
        # item 1: the port bench).
        if index.similarity == Similarity.EUCLIDEAN or index.capacity <= 2048 or k > _KMAX:
            backend = "xla"
        elif index.capacity <= 131072:
            backend = "pallas_packed_sel"
        elif index.capacity >= 524288 and index.capacity % 2048 == 0 and index.contiguous and k <= 100:
            backend = "chunkmax"
        else:
            backend = "blockmax"

    if backend in ("pallas", "pallas_packed", "pallas_packed_sel", "pallas_exact") and k > _KMAX:
        backend = "xla"  # the per-tile lists hold at most 128 entries

    if backend == "xla":
        return _xla_scan_topk(queries, index, k)

    if index.similarity == Similarity.EUCLIDEAN:
        raise ValueError("kernel backends support cosine/dot only")
    if backend == "chunkmax" and not index.contiguous:
        # the rescore masks each 128-row chunk with a prefix live count, which only
        # holds when the live rows form a dense prefix
        raise ValueError("chunkmax backend requires a contiguous (tombstone-free) index")

    tn = _pick_tn(index.capacity)
    q = queries.to(index.emb.dtype).contiguous()
    bias = _index_bias(index)
    if backend == "blockmax":
        vals, rows = _blockmax_topk(q, index.emb, bias, k)
    elif backend == "blockmax16":
        vals, rows = _blockmax16_topk(q, index.emb, bias, k)
    elif backend == "chunkmax":
        from wax_tpu_torch.ops.chunkmax_scan import chunkmax_scan_topk

        vals, rows = chunkmax_scan_topk(q, index.emb, bias, k)
    elif backend == "pallas_packed_sel":
        vals, rows = _packed_sel_scan_topk(q, index.emb, bias, k, tn)
    elif backend == "pallas_packed":
        vals, rows = _packed_scan_topk(q, index.emb, bias, k, tn)
    elif backend in ("pallas", "pallas_exact"):
        vals, rows = _pallas_scan_topk(q, index.emb, bias, k, tn)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return vals, rows, _frame_ids(index, rows)
