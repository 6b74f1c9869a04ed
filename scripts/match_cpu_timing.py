"""Time the port's host MATCH evaluator against the JAX package's on the CPU.

`wax_tpu_torch.search.match` evaluates a query over a position index of the builder's
token log, all rows at once; `wax_tpu.search.match` verifies candidate rows one at a
time in Python over its builder's per-term dicts. This script adds the same smoke
corpus documents (`chip_smoke.make_corpus`) to both builders, checks that both return
the same hits (frame ids, rows, scores, instances) for every query, and prints each
query kind's mean time per query, best of `--reps`, for both. The port's first call
after an add also builds the position index; its time is printed apart.

    JAX_PLATFORMS=cpu python scripts/match_cpu_timing.py [--docs 10240] [--per-kind 64]
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def _queries(docs: list[str], per_kind: int, seed: int) -> dict[str, list[str]]:
    """MATCH strings that reach the host evaluator in unified_search (positional or
    with NOT), built from word pairs of the documents."""
    rng = np.random.default_rng(seed)
    out: dict[str, list[str]] = {"phrase": [], "prefix": [], "near": [], "not": [], "phrase_or": []}
    for _ in range(per_kind):
        w = docs[int(rng.integers(len(docs)))].split()
        i = int(rng.integers(len(w) - 3))
        out["phrase"].append(f'"{w[i]} {w[i + 1]}"')
        out["prefix"].append(f"{w[i][:3]}* {w[i + 2]}")
        out["near"].append(f"NEAR({w[i]} {w[i + 3]}, 5)")
        out["not"].append(f"{w[i]} NOT {w[i + 1]}")
        out["phrase_or"].append(f'"{w[i]} {w[i + 1]}" OR {w[i + 2]}')
    return out


def _best(fn, reps: int) -> float:
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--docs", type=int, default=10_240, help="smoke corpus documents to index")
    ap.add_argument("--per-kind", type=int, default=64, help="queries of each kind")
    ap.add_argument("--reps", type=int, default=3, help="timed passes; the best is printed")
    ap.add_argument("--top-k", type=int, default=24, help="hits a query asks for (unified_search's fetch depth)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    from chip_smoke import make_corpus
    from wax_tpu.index.lex import LexIndexBuilder as JaxLex
    from wax_tpu.search.match import match_search as jax_match
    from wax_tpu_torch.index.lex import LexIndexBuilder
    from wax_tpu_torch.search.match import match_search

    _, docs, _ = make_corpus(args.seed, args.docs)
    jax_b, port_b = JaxLex(), LexIndexBuilder()
    for b in (jax_b, port_b):
        for i, d in enumerate(docs):
            b.add(i, d)
    kinds = _queries(docs, args.per_kind, args.seed)

    t0 = time.perf_counter()
    match_search(port_b, kinds["phrase"][0], args.top_k)
    first = time.perf_counter() - t0
    print(f"{args.docs} documents; the port's first call (position index built) {first * 1e3:.3f} ms")

    def run(fn, b, qs):
        return [[(h.frame_id, h.row, h.score, h.instances) for h in fn(b, q, args.top_k)] for q in qs]

    total_jax = total_port = 0.0
    for kind, qs in kinds.items():
        if run(jax_match, jax_b, qs) != run(match_search, port_b, qs):
            print(f"{kind}: the two evaluators' hits differ")
            return 1
        tj = _best(lambda: run(jax_match, jax_b, qs), args.reps)
        tp = _best(lambda: run(match_search, port_b, qs), args.reps)
        total_jax, total_port = total_jax + tj, total_port + tp
        print(f"{kind:10s} e.g. {qs[0]!r}: JAX module {tj / len(qs) * 1e3:.3f} ms a query, "
              f"port {tp / len(qs) * 1e3:.3f} ms, ratio {tj / tp:.2f}")
    n = sum(len(qs) for qs in kinds.values())
    print(f"all {n} queries, hits equal: JAX module {total_jax / n * 1e3:.3f} ms a query, "
          f"port {total_port / n * 1e3:.3f} ms, ratio {total_jax / total_port:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
