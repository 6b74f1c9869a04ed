#!/usr/bin/env python3
"""Build variants of the port's K8 kernel and time them on one NVIDIA GPU.

    python3 scripts/k8_variants.py [--sass] [--out DIR] [--only NAME,...] [--extra NAME=DIR ...]

Each variant is a copy of wax_tpu_torch/csrc/bm25_candidates.cu with `constexpr int`
knobs at its top changed or a span of its body replaced (an edit that no longer applies
raises: update `EDITS` with the kernel). The row-tile walk (sel 0): the sentinel stores'
pace (`fill0`: all before the walk; `fill1`, `fill3`: 1 or 3 rounds a walk step, the
kept body 2), the postings a thread holds a batch (`items1`, `items4`, `items4_fill1`;
the kept body 2), `scalar` (4-byte sentinel stores in place of 16-byte ones),
`rowwrite` (each thread writes its row's run of posting positions, in place of a warp's
coalesced stores over its 32 rows' runs) and the ablations `abl_nofill` (no sentinel
stores), `abl_nowrite` (no posting positions written) and `abl_noacc` (no postings
loaded or added), whose outputs are wrong and are not checked. Both walks: `fixed`
(CTA g owns the g-th of n equal row spans in place of the merge-path share of the
postings). The postings walk (sel > 0): the postings a CTA owns at least (`walk32k`,
`walk128k`; the kept body 65,536), the postings a window and its buckets (`tw2048`,
`nb8192`; the kept body 4,096 and 4,096), at least 32 postings a slot a window
(`minw32`; the kept body 1), and `prof`, the postings walk's phases in clock64 cycles
(`PROF_PHASES`; timed, but distorted by its counters).
The kept body also runs at forced G (`kept@G`: CTAs a query, the wrapper's `split`).
`--extra NAME=DIR` adds another bm25_candidates.cu as it stands in DIR (a parent
commit's, unpacked with git archive into a git-ignored directory), called through the
same C entry.

Inputs (built here from `chip_smoke.make_corpus`'s Zipf documents and queries, with the
port's `LexIndexBuilder`, exact postings; the last drawn on the card):
  * `orch_sharded`: [orch_sharded]'s shard shape: one shard of 25,600 documents, one
    query padded to 16 slots (Q2 16 x W2 32,768, a 4 MiB plane), mode `all`, sel 0;
  * `orch_sharded_sel3`: the same query, `any`, sel 3 (G CTAs' lists merged);
  * `exact_30k`: 30,720 documents, 256 serving queries (Q2 16 x W2 32,768), `any`, sel 0;
  * `exact_30k_sel3`: the same, sel 3 (the rescore fetch);
  * `hybrid_sel3`: hybrid_msmarco1.b256's shape, 256 queries of 1-16 Zipf terms over
    about 9M row ids, slices cut to 131,072 (Q2 16 x W2 262,144; `chip_smoke.zipf_postings`
    and `zipf_queries`), `any`, sel 3; `hybrid_sel3_b1`, `hybrid_sel3_b16`: its first 1
    and 16 queries.
Every variant is checked bit for bit against the plain twin at each input (the
hybrid one per 16 queries), then timed with CUDA events around 50 calls (10 at the
hybrid input) queued behind a sleep kernel (`chip_smoke.queued_ms`); the kept body and
the parent run first and last. ptxas's registers and spills are printed per variant.
Times move by a few percent with their place in a run: compare within one run.
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "wax_tpu_torch" / "csrc"
sys.path.insert(0, str(REPO))
sys.path.insert(0, str(REPO / "scripts"))

import k4_k7_variants as kv  # noqa: E402  (build_all, _const)

# name: {constexpr knob: value}
VARIANTS = {
    "kept": {},
    "fill0": {"FILL_STEP": 0},
    "fill1": {"FILL_STEP": 1},
    "fill3": {"FILL_STEP": 3},
    "items1": {"ITEMS": 1},
    "items4": {"ITEMS": 4},
    "items4_fill1": {"ITEMS": 4, "FILL_STEP": 1},
    "fixed": {"edit": "fixed"},
    "scalar": {"VEC_FILL": 0},
    "rowwrite": {"edit": "rowwrite"},
    "walk32k": {"WALK_MIN": 32768},
    "walk128k": {"WALK_MIN": 131072},
    "tw2048": {"TW": 2048, "NB": 2048},
    "nb8192": {"NB": 8192},
    "minw32": {"edit": "minw32"},
    "prof": {"edit": "prof"},
    "abl_nofill": {"edit": "nofill"},
    "abl_nowrite": {"edit": "nowrite"},
    "abl_noacc": {"edit": "noacc"},
}
# the kept body's spans that the variants replace: (start, end) markers, the end kept
SEARCH = ("  // (NC+1)-ary search for x", "  // the CTA's range, from its bounds' lower_bounds\n")
FIXED = """  // fixed row ranges: n equal spans of [rmin, rmax]
  if (tid < 2 && (tid ? act1 : act0)) sh.lo[tid] = q.rmin + (int)(((long long)q.rmax + 1 - q.rmin) * (g + tid) / n);
  __syncthreads();
  for (int i = tid; i < 2 * Q2; i += THREADS) {
    const int k = i / Q2, s = i % Q2;
    if (!(k ? act1 : act0)) continue;
    const int v = lower_bound(rows, s_a[s], s_a[s] + s_n[s], sh.lo[k]);
    p_lo[k * 2 * Q2 + s] = v;
    atomicAdd(&sh.f[k], v - s_a[s]);
  }
  __syncthreads();
"""
WARP_WRITE = ("    // warp w writes the runs", "    for (int s = tid; s < Q2; s += THREADS) s_cur[s] = s_hi[s];\n")
ROW_WRITE = """    for (int r = tid; r < width; r += THREADS) {
      const int incl = cnt[r];
      const int c = incl - (r ? cnt[r - 1] : 0);
      if (c == 0) continue;
      const size_t o = plane0 + base + incl - c;
      for (int i = 0; i < c - 1; ++i) {
        out_rows[o + i] = -1;
        out_scores[o + i] = NEG_INF;
      }
      const float sum = acc[r];
      const bool live = sum > 0.f && (mode != MODE_ALL || c >= nterm);
      out_rows[o + c - 1] = live ? t0 + r : -1;
      out_scores[o + c - 1] = !live ? NEG_INF : mode == MODE_COUNT ? __fadd_rn(sum, 4096.f * (float)c) : sum;
    }
"""
# prof: clock64 cycles of the postings walk's phases on each CTA's thread 0, summed over
# the CTAs into k8_prof (read by k8_prof_read): setup and search, wait for the window,
# warp 0's bookkeeping, the next window's copies issued, bucket counts, their scan, the
# scatter, the ranks, the leaders, the selection; then windows and ready postings
PROF_PHASES = ("setup+search", "wait", "bookkeeping", "issue", "count", "scan", "scatter", "rank", "leaders",
               "select", "windows", "ready")
PROF = [
    ("sub", "#include <limits.h>\n", "#include <limits.h>\n__device__ unsigned long long k8_prof[12];\n"
     "#define PROF(k) do { if (threadIdx.x == 0) { const long long t_ = clock64(); prof_acc[k] += t_ - prof_t; "
     "prof_t = t_; } } while (0)\n"),
    ("sub", "  const int nterm = q.nterm, P = q.p;\n",
     "  const int nterm = q.nterm, P = q.p;\n  long long prof_t = clock64();\n  unsigned long long prof_acc[12] = {};\n"),
    ("sub", "  for (int cb = 0;; cb ^= 1) {\n", "  PROF(0);\n  for (int cb = 0;; cb ^= 1) {\n"),
    ("sub", "    if (wo[Q2] == 0) break;  // nothing left\n",
     "    if (wo[Q2] == 0) break;  // nothing left\n    PROF(1);\n"),
    ("sub", "    issue_window(rows, wnorm, win_row + nb * TW",
     "    PROF(2);\n    issue_window(rows, wnorm, win_row + nb * TW"),
    ("sub", "    // counting sort of the ready postings", "    PROF(3);\n    // counting sort of the ready postings"),
    ("sub", "    block_scan<NB / THREADS>(bkt, NB, warp_tot);",
     "    PROF(4);\n    block_scan<NB / THREADS>(bkt, NB, warp_tot);"),
    ("sub", "    // ... window indices scattered", "    PROF(5);\n    // ... window indices scattered"),
    ("sub", "    // ... each posting's rank", "    PROF(6);\n    // ... each posting's rank"),
    ("sub", "    // leaders: the last of each run", "    PROF(7);\n    // leaders: the last of each run"),
    ("sub", "    // thread p takes the window's positions", "    PROF(8);\n    // thread p takes the window's positions"),
    ("sub", "    base += R;\n", "    base += R;\n    PROF(9);\n    prof_acc[10] += 1;\n    prof_acc[11] += R;\n"),
    ("sub", "  if (n == 1) {\n    finish_list", "  if (threadIdx.x == 0)\n    for (int k = 0; k < 12; ++k) "
     "atomicAdd(&k8_prof[k], prof_acc[k]);\n  if (n == 1) {\n    finish_list"),
    ("sub", "}  // extern \"C\"\n", "int k8_prof_read(unsigned long long* out) {\n  return (int)cudaMemcpyFromSymbol"
     "(out, k8_prof, sizeof(k8_prof));\n}\nint k8_prof_reset() {\n  unsigned long long z[12] = {};\n  return (int)"
     "cudaMemcpyToSymbol(k8_prof, z, sizeof(z));\n}\n}  // extern \"C\"\n"),
]
# ablations ("abl_"): their outputs are wrong by design and are not checked
EDITS = {
    "minw32": [("sub", "min(rem, 1 + (int)((long long)(TW - Q2) * rem / left))",
                "min(rem, 32 + (int)((long long)(TW - 32 * Q2) * rem / left))")],
    "prof": PROF,
    "fixed": [("cut", SEARCH, FIXED)],
    "rowwrite": [("cut", WARP_WRITE, ROW_WRITE)],
    "nofill": [("sub", "  {  // this CTA's share of the sentinel prefix and suffix: the edges now",
                "  if (tid < 4) sh_fill[tid] = 0;\n  if (false) {  // this CTA's share")],
    "nowrite": [("sub", "for (int r0 = warp * 32; r0 < width; r0 += THREADS) {",
                 "for (int r0 = warp * 32; r0 < 0; r0 += THREADS) {")],
    "noacc": [("sub", "    for (int k0 = 0; k0 < tile_total; k0 += THREADS * ITEMS) {",
               "    for (int k0 = 0; k0 < 0; k0 += THREADS * ITEMS) {")],
}


def _cut(text: str, span: tuple, new: str) -> str:
    """text with the span from span[0] up to (not including) span[1] replaced by new."""
    start, end = span
    i = text.find(start)
    j = text.find(end, i) if i >= 0 else -1
    if i < 0 or j < 0 or text.count(start) != 1:
        raise RuntimeError(f"variant edit does not apply: {start!r} .. {end!r}")
    return text[:i] + new + text[j:]


FORCED_G = {"orch_sharded": (1, 8, 33, 66, 264), "orch_sharded_sel3": (1, 33), "exact_30k": (2, 4),
            "exact_30k_sel3": (2,), "hybrid_sel3": (16, 64), "hybrid_sel3_b1": (32,), "hybrid_sel3_b16": (32,)}
_P, _I = ctypes.c_void_p, ctypes.c_int
NEW_SIG = [_P] * 10 + [_I] * 7 + [_P]
OLD_SIG = [_P] * 8 + [_I] * 6 + [_P]


def source(knobs: dict) -> str:
    src = (SRC / "bm25_candidates.cu").read_text()
    for name, value in knobs.items():
        if name != "edit":
            src = kv._const(src, name, value)
            continue
        for kind, old, new in EDITS[value]:
            src = _cut(src, old, new) if kind == "cut" else kv._sub(src, old, new)
    return src


def inputs(dev):
    """{label: (tids [B, 16], rows, wnorm, offsets, idf, max_df, mode, sel)}."""
    import numpy as np
    import torch

    import chip_smoke
    from wax_tpu_torch.index.lex import LexIndexBuilder, analyze
    from wax_tpu_torch.ops.bm25 import pad_term_ids

    _, docs, queries = chip_smoke.make_corpus(0, chip_smoke.N_30K)
    out, lines = {}, []
    for n_docs, label in ((25_600, "orch_sharded"), (chip_smoke.N_30K, "exact_30k")):
        b = LexIndexBuilder()
        b.add_batch(list(enumerate(docs[:n_docs])))
        lex = b.snapshot(device=dev)
        tids = np.full((256, 16), -1, np.int32)
        for i, q in enumerate(queries[0]):
            t = pad_term_ids(b.term_ids(analyze(q)), dfs=b.df)[:16]
            tids[i, :len(t)] = t
        if label == "orch_sharded":  # one query, its 10 terms and 6 more of the next queries'
            more = [t for t in dict.fromkeys(tids[1:].reshape(-1).tolist()) if t >= 0 and t not in tids[0]]
            tids = tids[:1].copy()
            n = int((tids[0] >= 0).sum())
            tids[0, n:] = more[:16 - n]
        tq = torch.from_numpy(tids).to(dev)
        args = (tq, lex.doc_rows, lex.wnorm, lex.offsets, lex.idf, int(lex.max_df))
        if label == "orch_sharded":
            out[label] = (*args, "all", 0)
            out[label + "_sel3"] = (*args, "any", 3)
        else:
            out[label] = (*args, "any", 0)
            out[label + "_sel3"] = (*args, "any", 3)
        lines.append(f"{label}: {n_docs} documents, {lex.doc_rows.numel()} postings, max_df {int(lex.max_df)}, "
                     f"B {tq.shape[0]}, {int((tq >= 0).sum())} query terms")
    rows, wn, offs, idf = chip_smoke.zipf_postings(dev)
    tq = torch.from_numpy(chip_smoke.zipf_queries(np.random.default_rng(0), 256)).to(dev)
    out["hybrid_sel3"] = (tq, rows, wn, offs, idf, int((offs[1:] - offs[:-1]).max()), "any", 3)
    for b in (1, 16):  # the same postings at small batches: the first b queries
        out[f"hybrid_sel3_b{b}"] = (tq[:b].contiguous(), *out["hybrid_sel3"][1:])
    lines.append(f"hybrid_sel3: {out['hybrid_sel3'][1].numel()} postings, max_df {out['hybrid_sel3'][5]}, B 256")
    return out, "; ".join(lines)


def run(libs: dict, dev) -> None:
    import torch

    import chip_smoke
    from wax_tpu_torch.ops import bm25_candidates_pallas as k8

    new = {name for name, lib in libs.items() if hasattr(lib, "wax_k8_plan")}
    for name, lib in libs.items():
        fn = lib.wax_k8_candidates
        fn.argtypes, fn.restype = (NEW_SIG if name in new else OLD_SIG), ctypes.c_int
        if name in new:
            lib.wax_k8_plan.argtypes, lib.wax_k8_plan.restype = [_I, _I, _I, _I, _P], ctypes.c_int
    cases, line = inputs(dev)
    print(line, flush=True)
    tickets = torch.zeros(256, dtype=torch.int32, device=dev)

    def plan(name, b, q2, w2, sel):
        out = (ctypes.c_int * 6)()
        libs[name].wax_k8_plan(b, q2, w2, sel, ctypes.cast(out, ctypes.c_void_p))
        return list(out)

    def call(name, case, g=None):
        tids, rows, wn, offs, idf, max_df, mode, sel = case
        b, q = tids.shape
        q2, w2 = 16, k8.dma_window(max_df)
        width = sel * 1024 if sel else q2 * w2
        out_rows = torch.empty((b, width), dtype=torch.int32, device=dev)
        out = torch.empty((b, width), dtype=torch.int32 if sel else torch.float32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [tids.data_ptr(), offs.data_ptr(), idf.data_ptr(), rows.data_ptr(), wn.data_ptr(),
                out_rows.data_ptr(), 0 if sel else out.data_ptr(), out.data_ptr() if sel else 0]
        m = k8._MODES[mode]
        if name in new:
            g = g or plan(name, b, q2, w2, sel)[0]
            part = torch.empty(max(1, b * g * 2 * sel * 1024), dtype=torch.int32, device=dev)
            err = libs[name].wax_k8_candidates(*ptrs, part.data_ptr(), tickets.data_ptr(), b, q, q2, w2, m, sel, g,
                                               stream)
        else:
            err = libs[name].wax_k8_candidates(*ptrs, b, q, q2, w2, m, sel, stream)
        if err:
            raise RuntimeError(f"{name}: launch failed, CUDA error {err}")
        return out_rows, out

    for label, case in cases.items():
        tids, rows, wn, offs, idf, max_df, mode, sel = case
        q2, w2 = 16, k8.dma_window(max_df)
        want = [k8._candidate_scores_plain(tids[i:i + 16], rows, wn, offs, idf, q2, w2, mode, sel)
                for i in range(0, tids.shape[0], 16)]
        want = [torch.cat(x, 0) for x in zip(*want)]
        runs = [(name, None) for name in libs] + [("kept", g) for g in FORCED_G[label]]
        for name, g in runs:
            if name.startswith("abl_"):
                continue
            got = call(name, case, g)
            if not all(torch.equal(x, y) for x, y in zip(got, want)):
                raise RuntimeError(f"{name} (G {g}, {label}): differs from the plain twin")
        if "prof" in libs and sel:
            lib = libs["prof"]
            got = (ctypes.c_ulonglong * 12)()
            lib.k8_prof_reset()
            call("prof", case)
            torch.cuda.synchronize()
            lib.k8_prof_read(ctypes.cast(got, ctypes.c_void_p))
            cyc = list(got)
            total = sum(cyc[:10]) or 1
            print(f"{label} prof (thread 0's cycles, share of the CTAs' sum): "
                  + "; ".join(f"{k} {100 * c / total:.1f}%" for k, c in zip(PROF_PHASES[:10], cyc[:10]))
                  + f"; {cyc[10]} windows, {cyc[11] / max(cyc[10], 1):.1f} ready postings a window, "
                  f"{total / max(cyc[10], 1):.0f} cycles a window", flush=True)
        plans = {name: plan(name, tids.shape[0], q2, w2, sel) for name in new}
        print(f"{label} plans (G, threads, tile, CTAs an SM): "
              + "; ".join(f"{n} {p[0]}, {p[1]}, {p[2]}, {p[3]}" for n, p in plans.items()), flush=True)
        order = runs + [(n, None) for n in reversed(list(libs)) if n in ("kept", "parent")]
        iters = 10 if label.startswith("hybrid") else 50
        parts = [f"{name}{'' if g is None else f'@{g}'} "
                 f"{chip_smoke.queued_ms(lambda: call(name, case, g), iters=iters):.4f}" for name, g in order]
        bound_ms, bound_by, n_read, out_bytes = chip_smoke._k8_bound(tids, offs, idf, q2, w2, sel)
        print(f"{label} (ms; bound {bound_ms:.6f} by {bound_by}: {n_read} postings, {out_bytes} bytes written): "
              + "; ".join(parts), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "wax_tpu_torch" / "_build" / "k8_variants"))
    ap.add_argument("--sass", action="store_true", help="print each kernel's commonest SASS opcodes")
    ap.add_argument("--extra", action="append", default=[], help="NAME=DIR holding another bm25_candidates.cu")
    ap.add_argument("--only", default="", help="the variants to build, comma-separated (default: all)")
    args = ap.parse_args(argv)
    kv.SASS = args.sass
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from wax_tpu_torch.ops._build import _nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    only = set(filter(None, args.only.split(","))) | {"kept"}
    sources = {name: (source(knobs), SRC) for name, knobs in VARIANTS.items() if not args.only or name in only}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = ((Path(path) / "bm25_candidates.cu").read_text(), Path(path))
    libs = kv.build_all(sources, Path(args.out), "bm25_candidates.cu", _nvcc(), fragments=("k8_",))
    run(libs, torch.device("cuda"))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
