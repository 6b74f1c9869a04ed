"""Brute-force dense scan with top-k: the port's performance core.

PyTorch port of `wax_tpu.ops.flat_scan`. Backends, as in the JAX package:

  * "xla":      full f32 score matrix + stable top-k (the name is kept for parity;
                here it is plain torch). Correctness oracle.
  * "pallas" / "pallas_exact": kernel K2 (csrc/flat_scan.cu `wax_k2_scan_topk`), the
                exact fused scan with per-tile top-k by (score desc, column asc).
  * "pallas_packed_sel": kernel K1 (csrc/flat_scan.cu `wax_k1_packed_sel`), per-tile
                top-k over packed i32 keys whose scores are truncated to 2^-12
                relative. What "auto" picks at mid N.
  * "blockmax" / "blockmax16": exact chunk-max pruned top-k in plain torch (the
                second with a bf16 coarse pass and an exact f32 rescore).
  * "chunkmax" (K6/K7) and "pallas_packed" (K9) are not ported yet and raise.

Each kernel wrapper takes its plain torch twin (`_packed_sel_topk_plain`,
`_scan_topk_plain`) only when its tensors lie on the CPU; for CUDA tensors it
launches the kernel or raises. `K1_LAUNCHES` and `K2_LAUNCHES` count launches.

Masking: tombstones and padding are excluded through an additive bias row (0 for
live rows, NEG_INF otherwise).
"""
from __future__ import annotations

import torch

from wax_tpu_torch.index.dense import DenseIndex, Similarity
from wax_tpu_torch.ops.topk import NEG_INF, blockmax_topk, masked_top_k, stable_top_k

__all__ = [
    "flat_scan_topk",
    "scan_scores",
    "normalize_rows",
    "packed_sel_tiles",
    "scan_topk_tiles",
    "K1_LAUNCHES",
    "K2_LAUNCHES",
]

# Launch counters of the two kernels: each wrapper adds one where it launches.
K1_LAUNCHES = 0
K2_LAUNCHES = 0

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


def _scores_f32(q: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
    """[B, N] f32 dot products. bf16 operands are widened first (their products are
    exact in f32), so every path accumulates in f32."""
    return torch.matmul(q.float(), emb.float().t())


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


def _on_cpu(*tensors: torch.Tensor) -> bool:
    """True for CPU tensors (plain twin), False for CUDA tensors (kernel)."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise ValueError(f"tensors must all be on the CPU or on one CUDA device, got {kinds}")


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


def _launch(fn, q, *args) -> None:
    with torch.cuda.device(q.device):
        err = fn(*args, torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        from wax_tpu_torch.ops._build import load_library

        msg = load_library().wax_cuda_error_string(err).decode()
        raise RuntimeError(f"{fn.__name__} launch failed: CUDA error {err} ({msg})")


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


def packed_sel_tiles(q, emb, bias, k: int, tn: int) -> torch.Tensor:
    """K1 wrapper: per-tile packed keys [B, N/tn * k] (kernel on CUDA, plain twin on
    the CPU)."""
    global K1_LAUNCHES
    if _on_cpu(q, emb, bias):
        return _packed_sel_topk_plain(q, emb, bias, k, tn)
    _check_kernel_args(q, emb, bias, k, tn)
    from wax_tpu_torch.ops._build import load_library

    lib = load_library()
    b, (n, d) = q.shape[0], emb.shape
    out = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
    if b:
        _launch(lib.wax_k1_packed_sel, q, q.data_ptr(), emb.data_ptr(), bias.data_ptr(),
                out.data_ptr(), b, n, d, tn, k, int(q.dtype == torch.bfloat16))
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


def scan_topk_tiles(q, emb, bias, k: int, tn: int):
    """K2 wrapper: per-tile (vals, rows) [B, N/tn * k] (kernel on CUDA, plain twin on
    the CPU)."""
    global K2_LAUNCHES
    if _on_cpu(q, emb, bias):
        return _scan_topk_plain(q, emb, bias, k, tn)
    _check_kernel_args(q, emb, bias, k, tn)
    from wax_tpu_torch.ops._build import load_library

    lib = load_library()
    b, (n, d) = q.shape[0], emb.shape
    vals = torch.empty((b, n // tn * k), dtype=torch.float32, device=q.device)
    rows = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
    if b:
        _launch(lib.wax_k2_scan_topk, q, q.data_ptr(), emb.data_ptr(), bias.data_ptr(),
                vals.data_ptr(), rows.data_ptr(), b, n, d, tn, k, int(q.dtype == torch.bfloat16))
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


def _blockmax16_topk(q, emb, bias, k: int):
    """blockmax over bf16-rounded scores, then an exact f32 rescore of the top
    max(2k, k+16) candidates, ranked by (exact score desc, row asc)."""
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
        to the lowest row) | "blockmax" | "blockmax16". "chunkmax" and
        "pallas_packed" raise NotImplementedError until ported.

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
        # another device and still await measurement on this one (ROADMAP item 4).
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
    if backend == "chunkmax":
        raise NotImplementedError(
            "backend 'chunkmax' (TPU kernels K6/K7) is not ported yet: ROADMAP item 8"
        )
    if backend == "pallas_packed":
        raise NotImplementedError(
            "backend 'pallas_packed' (TPU kernel K9) is not ported yet: ROADMAP, "
            "'TPU kernels to port', K9"
        )

    tn = _pick_tn(index.capacity)
    q = queries.to(index.emb.dtype).contiguous()
    bias = _index_bias(index)
    if backend == "blockmax":
        vals, rows = _blockmax_topk(q, index.emb, bias, k)
    elif backend == "blockmax16":
        vals, rows = _blockmax16_topk(q, index.emb, bias, k)
    elif backend == "pallas_packed_sel":
        vals, rows = _packed_sel_scan_topk(q, index.emb, bias, k, tn)
    elif backend in ("pallas", "pallas_exact"):
        vals, rows = _pallas_scan_topk(q, index.emb, bias, k, tn)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return vals, rows, _frame_ids(index, rows)
