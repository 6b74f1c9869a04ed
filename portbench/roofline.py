"""The yardstick's arithmetic: published peaks, the least time of a piece of work, and
the operations and bytes of each kernel and of a whole batch.

Frozen copies, so that no later change to the program or to `chip_smoke.py` moves
the yardstick:

  * `HBM_BYTES_PER_S`, `PEAK_OPS_PER_S` and `bound`: `chip_smoke.py:264-288`;
  * `k6_work`: the bound of `chip_smoke._k6_case` (`chip_smoke.py:1005-1006`);
  * `k7_work`: `chip_smoke._k7_bound` (`chip_smoke.py:1018-1034`);
  * `KERNEL_FRAGMENTS` and `short_kernel_name`: `chip_smoke.py:310-320`.

Every count is of what the inputs need: each input byte read once, each output byte
written once, whatever a kernel reads again.
"""
from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"fp32": 67e12, "tf32": 495e12, "bf16": 989e12}

# K1 and K2 are one template (csrc/flat_scan.cu `scan_topk`), told apart by their output
KERNEL_FRAGMENTS = {"PackedOut": "K1", "ExactOut": "K2", "k3_rescore": "K3", "k4_chunked": "K4",
                    "k5_rescore": "K5", "k6_chunk_maxima": "K6", "k7_bucket": "K7", "k8_candidates": "K8",
                    "k9_packed_topk": "K9"}


def short_kernel_name(name: str) -> str:
    """K1..K9 for a port kernel's (demangled) name, else the name's first 60 characters."""
    for frag, kid in KERNEL_FRAGMENTS.items():
        if frag in name:
            return kid
    return name[:60]


def bound(nbytes: float, ops: float, kind: str) -> tuple[float, str]:
    """(bound_ms, bound_by) for work that moves `nbytes` and does `ops` operations of
    type `kind`."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Work:
    """Bytes moved and operations by type; `least_ms` is the larger of the bytes at the
    memory rate and the sum of the operations, each at its type's peak."""

    def __init__(self, nbytes: float = 0.0, ops: dict | None = None):
        self.nbytes = float(nbytes)
        self.ops = dict(ops or {})

    def __add__(self, other: "Work") -> "Work":
        ops = dict(self.ops)
        for kind, n in other.ops.items():
            ops[kind] = ops.get(kind, 0.0) + n
        return Work(self.nbytes + other.nbytes, ops)

    def least_ms(self, chips: int = 1) -> float:
        t_bytes = self.nbytes / (HBM_BYTES_PER_S * chips) * 1e3
        t_ops = sum(n / (PEAK_OPS_PER_S[kind] * chips) for kind, n in self.ops.items()) * 1e3
        return max(t_bytes, t_ops)


def k6_work(b: int, n: int, d: int, el: int) -> Work:
    """K6 (chunk maxima): the corpus, queries, bias and chunk maxima each moved once, or
    the multiply-adds at the corpus type's rate."""
    return Work(n * d * el + b * d * el + n * 4 + b * (n // 128) * 4, {"bf16" if el == 2 else "fp32": 2 * b * n * d})


def k7_work(b: int, nprobe: int, n_buckets: int, d: int, el: int, k: int, live_distinct: int,
            probed_live: int) -> Work:
    """K7 (bucket rescore): the live rows of each distinct probed bucket read once, with
    the queries, probes, live counts and outputs; one f32 multiply-add per element of
    every live row a query probes."""
    nbytes = live_distinct * d * el + b * d * 4 + b * nprobe * 4 + n_buckets * 4 + b * k * 8
    return Work(nbytes, {"fp32": 2 * probed_live * d})
