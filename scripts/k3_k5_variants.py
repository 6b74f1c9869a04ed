#!/usr/bin/env python3
"""Build variants of the port's K3 and K5 kernels and time them on one NVIDIA GPU.

    python3 scripts/k3_k5_variants.py [--sass] [--out DIR] [--extra NAME=DIR ...]

Each variant is a copy of wax_tpu_torch/csrc/bm25_rescore.cu with one thing changed (a
`constexpr int` line at its top, or a text edit of the body): the match (`ballot`: a warp ballot per
query slot over the live register groups, as the first port ran it; `linear`: a linear
scan of the sorted slots in place of the binary search; `filter`: a 4096-bit filter of
the query's terms tested before the search), the weights loaded (`w_all`: every
lane's; `w_live`: live lanes'; the kept body loads matched lanes' only), `noskip`
(every register group matched, live or not), candidates per warp (`cpw2_to64`: two
only up to 64 lanes; forced to 1, 2 or 4: `cpw1`, `cpw2`, `cpw4`), candidates per CTA
(`cta8`, `cta32`, `cta128`) and warps per CTA (`warps4`), and the ablation `abl_loads`
(tid and live weight loads alone, no match). `--extra NAME=DIR` adds another bm25_rescore.cu as it stands in DIR
(a parent commit's, unpacked with git archive into a git-ignored directory), called
through the same C entries.

Inputs: hybrid_1m's (the bench's Zipf 0.7 postings over 1,048,576 documents, budget
3,072, 256 queries of 16 terms; the 256 candidates a query that K4 ranks, row-sorted,
as the lane builds them): K3 over the fused index at L2 128; K3 at L2 64 over the first
64 lanes of the same rows (a valid forward index: each term at most once), the width
of engine_1m's index; K5 wide (L 128) and narrow (the first 64 lanes); and `l2res`, K3
at L2 128 on each query's first 64 candidates repeated to 256 (16,384 rows, 16 MB:
resident in the 50 MB L2 cache, so the time is the match's). Every variant but the
ablation is checked bit for bit against the plain twin on each input, then timed with
CUDA events around 100 calls queued behind a sleep kernel (`chip_smoke.queued_ms`: the
kernels are shorter than a call's host time); ptxas's registers and spills are printed
per instance. Times move by a few percent with their place in a run: compare within
one run.
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

import k4_k7_variants as kv  # noqa: E402  (build_all, _const, _sub)

# the kept body's lines that the variants replace
GROUPS = "      if (__any_sync(FULL, t[i] >= 0)) gl |= 1u << i;\n"
W_DECL = "    float w[NL];\n"
W_HIT = "    for (int i = 0; i < NL; ++i) w[i] = lo[i] >= 0 ? __ldg(wp + S * i) : 0.f;\n"
SEARCH = "    // lo[i]: the first sorted slot holding t[i]"
SEARCH_END = ("    for (int i = 0; i < NL; ++i) lo[i] = (gl >> i & 1) && t[i] >= 0 && lo[i] < nv && st[lo[i]] == t[i] ? "
              "lo[i] : -1;\n")
ROUND_END = "    __syncwarp();\n  }\n}\n"
PLAN = "  const int cpw = width <= CPW2_MAX ? 2 : 1;\n  return {pow2_at_least((width + 32 / cpw - 1) / (32 / cpw)), cpw};\n"
W_LIVE = "#pragma unroll\n    for (int i = 0; i < NL; ++i) w[i] = t[i] >= 0 ? __ldg(wp + S * i) : 0.f;\n"
W_ALL = "#pragma unroll\n    for (int i = 0; i < NL; ++i) w[i] = row >= 0 && i * S < a.width ? __ldg(wp + S * i) : 0.f;\n"
LINEAR = """    int lo[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) lo[i] = -1;
    for (int k = 0; k < nv; ++k) {
      const int v = st[k];
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if ((gl >> i & 1) && lo[i] < 0 && t[i] == v) lo[i] = k;
    }
"""
FILTER = """    {  // the groups in which some lane's tid passes a 4096-bit filter of the query's terms
      unsigned gf = 0;
#pragma unroll
      for (int i = 0; i < NL; ++i) {
        const bool maybe = (gl >> i & 1) && t[i] >= 0 && (bm[(t[i] >> 5) & 127] >> (t[i] & 31) & 1);
        if (__any_sync(FULL, maybe)) gf |= 1u << i;
      }
      gl = gf;
    }
"""
# the first port's per-slot ballots over the live groups, added in lane order
BALLOT = W_LIVE + """    {
      const unsigned cmask = CPW == 1 ? FULL : ((1u << S) - 1) << (c * S);
      float s = 0.f;
      int n = 0;
      for (int j = 0; j < Q; ++j) {
        const int q = qt[j];
        if (q < 0) continue;
        bool hit = false;
        float prod = 0.f;
#pragma unroll
        for (int i = 0; i < NL; ++i) {
          if ((gl >> i & 1) && t[i] == q && (!SPLIT || w[i] > 0.f)) {
            hit = true;
            prod = __fmul_rn(w[i], qi[j]);
          }
        }
        unsigned bal = __ballot_sync(FULL, hit) & cmask;
        n += __popc(bal);
        while (__any_sync(FULL, bal != 0)) {
          const int src = bal ? __ffs(bal) - 1 : lane;
          const float v = __shfl_sync(FULL, prod, src);
          if (bal) {
            s = __fadd_rn(s, v);
            bal &= bal - 1;
          }
        }
      }
      if (sub == 0 && f < a.F) {
        a.scores[(size_t)b * a.F + f] = s;
        a.counts[(size_t)b * a.F + f] = n;
      }
    }
  }
}
"""
# the loads alone: tids and live weights hashed into a store that never happens
LOADS = W_LIVE + """    int h = 0;
#pragma unroll
    for (int i = 0; i < NL; ++i) h ^= t[i] ^ __float_as_int(w[i]) ^ (int)gl;
    if (h == 0x7FFFFFF1 && f < a.F) a.scores[(size_t)b * a.F + f] = 1.f;
  }
}
"""


def _cut(text: str, start: str, end: str, new: str) -> str:
    """text with the span from `start` to the end of `end` replaced by `new`."""
    i = text.index(start) if start in text else -1
    j = text.index(end, i) + len(end) if i >= 0 and end in text[i:] else -1
    if i < 0 or j < 0:
        raise RuntimeError(f"variant edit does not apply: {start!r} .. {end!r}")
    return text[:i] + new + text[j:]


def _forced_plan(cpw: int) -> str:
    return (f"  int cpw = {cpw};\n  int nl = pow2_at_least((width + 32 / cpw - 1) / (32 / cpw));\n"
            "  while (nl > 16) {\n    cpw /= 2;\n    nl = pow2_at_least((width + 32 / cpw - 1) / (32 / cpw));\n  }\n"
            "  return {nl, cpw};\n")


# name: (changes, {constexpr knob: value})
VARIANTS = {
    "kept": ("", {}),
    "filter": ("filter", {}),
    "warps4": ("", {"CTA_WARPS": 4}),
    "cpw2_to64": ("", {"CPW2_MAX": 64}),
    "ballot": ("ballot", {}),
    "linear": ("linear", {}),
    "w_all": ("w_all", {}),
    "w_live": ("w_live", {}),
    "noskip": ("noskip", {}),
    "cpw1": ("cpw1", {}),
    "cpw2": ("cpw2", {}),
    "cpw4": ("cpw4", {}),
    "cta8": ("", {"CTA_CANDS": 8}),
    "cta32": ("", {"CTA_CANDS": 32}),
    "cta128": ("", {"CTA_CANDS": 128}),
    "abl_loads": ("loads", {}),
}


def source(spec) -> str:
    changes, knobs = spec
    src = (SRC / "bm25_rescore.cu").read_text()
    for name, value in knobs.items():
        src = kv._const(src, name, value)
    for part in filter(None, changes.split("+")):
        if part == "noskip":
            src = kv._sub(src, GROUPS, "      if (i * S < a.width) gl |= 1u << i;\n")
        elif part in ("w_all", "w_live"):
            src = kv._sub(src, W_DECL, W_DECL + (W_ALL if part == "w_all" else W_LIVE))
            src = kv._sub(src, W_HIT, "    for (int i = 0; i < NL; ++i) {}\n")
        elif part == "linear":
            src = _cut(src, SEARCH, SEARCH_END, LINEAR)
        elif part == "filter":
            src = kv._sub(src, "  __shared__ int nv_s;\n", "  __shared__ int nv_s;\n  __shared__ unsigned bm[128];\n")
            src = kv._sub(src, "  if (tid == 0) nv_s = 0;\n",
                          "  if (tid == 0) nv_s = 0;\n  for (int j = tid; j < 128; j += WARPS * 32) bm[j] = 0;\n")
            src = kv._sub(src, "      atomicAdd(&nv_s, 1);\n",
                          "      atomicAdd(&nv_s, 1);\n      atomicOr(&bm[(v >> 5) & 127], 1u << (v & 31));\n")
            src = kv._sub(src, SEARCH, FILTER + SEARCH)
        elif part == "ballot":
            src = _cut(src, SEARCH, ROUND_END, BALLOT)
        elif part == "loads":
            src = _cut(src, SEARCH, ROUND_END, LOADS)
        elif part.startswith("cpw"):
            src = kv._sub(src, PLAN, _forced_plan(int(part[3:])))
    return src


def inputs(dev):
    """{label: (kernel, args)} at hybrid_1m's K3/K5 inputs; kernel "k3" args (fused,
    cand, tids_q, idf_q), "k5" args (ftids, fwn, cand, tids_q, idf_q, width)."""
    import numpy as np
    import torch

    import chip_smoke
    from wax_tpu_torch.ops import bm25_rescore as rs

    lex = chip_smoke.synth_sharded_lex(chip_smoke.N_1M, 16_384, 3072, dev)
    tids = torch.from_numpy(np.random.default_rng(7).integers(0, 16_384, (256, 16)).astype(np.int32)).to(dev)
    _, _, _, (pr, pkk) = chip_smoke._k4_case("variants", lex.pk_chunks[0], lex.chunk_base[0], lex.chunk_counts[0],
                                             lex.pk_max_chunks, lex.pk_qb, tids)
    cand = chip_smoke.rescore_rows(pr, pkk, 256)
    tq, iq = rs._query_planes(tids, lex.idf[0])
    tq, iq = tq.contiguous(), iq.contiguous()
    ft, fw, fused = lex.fwd_tids[0], lex.fwd_wnorm[0], lex.fwd_fused[0]
    fused64 = torch.cat([ft[:, :64], fw[:, :64].contiguous().view(torch.int32)], dim=1).contiguous()
    resident = cand[:, :64].repeat(1, 4).contiguous()
    live = ft[cand.clamp(min=0).long()] >= 0
    log_line = (f"inputs: B 256, F 256, Q 16, {int((cand >= 0).sum())} live candidates, "
                f"{float(live.sum(-1).float().mean()):.1f} live lanes a row of 128, "
                f"{int(torch.unique(cand[cand >= 0]).numel())} distinct rows")
    del lex
    return {
        "k3_l2_128": ("k3", (fused, cand, tq, iq)),
        "k3_l2_64": ("k3", (fused64, cand, tq, iq)),
        "k5_wide": ("k5", (ft, fw, cand, tq, iq, ft.shape[1])),
        "k5_narrow": ("k5", (ft, fw, cand, tq, iq, 64)),
        "k3_l2res": ("k3", (fused, resident, tq, iq)),
    }, log_line


def run(libs: dict, dev) -> None:
    import torch

    import chip_smoke

    from wax_tpu_torch.ops import bm25_rescore as rs
    from wax_tpu_torch.ops._build import _SIGNATURES

    for lib in libs.values():
        for entry in ("wax_k3_rescore_fused", "wax_k5_rescore_split"):
            fn = getattr(lib, entry)
            fn.argtypes, fn.restype = _SIGNATURES[entry], ctypes.c_int
    cases, line = inputs(dev)
    print(line, flush=True)

    def call(lib, kern, args):
        cand = args[1] if kern == "k3" else args[2]
        b, f = cand.shape
        scores = torch.empty((b, f), dtype=torch.float32, device=dev)
        counts = torch.empty((b, f), dtype=torch.int32, device=dev)
        stream = torch.cuda.current_stream().cuda_stream
        if kern == "k3":
            fused, cand, tq, iq = args
            err = lib.wax_k3_rescore_fused(fused.data_ptr(), cand.data_ptr(), tq.data_ptr(), iq.data_ptr(),
                                           scores.data_ptr(), counts.data_ptr(), b, f, tq.shape[1],
                                           fused.shape[1] // 2, stream)
        else:
            ft, fw, cand, tq, iq, width = args
            err = lib.wax_k5_rescore_split(ft.data_ptr(), fw.data_ptr(), cand.data_ptr(), tq.data_ptr(),
                                           iq.data_ptr(), scores.data_ptr(), counts.data_ptr(), b, f, tq.shape[1],
                                           ft.shape[1], width, stream)
        if err:
            raise RuntimeError(f"{kern}: launch failed, CUDA error {err}")
        return scores, counts

    for label, (kern, args) in cases.items():
        want = rs._rescore_fused_plain(*args) if kern == "k3" else rs._rescore_split_plain(*args)
        for name, lib in libs.items():
            if not name.startswith("abl_"):
                got = call(lib, kern, args)
                if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                    raise RuntimeError(f"{name} ({label}): differs from the plain twin")
        order = list(libs) + [n for n in reversed(libs) if n in ("kept", "parent")]  # kept and parent twice
        parts = [f"{name} {chip_smoke.queued_ms(lambda: call(libs[name], kern, args), iters=100):.4f}"
                 for name in order]
        print(f"{label} (ms): " + "; ".join(parts), flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "wax_tpu_torch" / "_build" / "k3_k5_variants"))
    ap.add_argument("--sass", action="store_true", help="print each kernel's commonest SASS opcodes")
    ap.add_argument("--extra", action="append", default=[], help="NAME=DIR holding another bm25_rescore.cu")
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
    sources = {name: (source(spec), SRC) for name, spec in VARIANTS.items()}
    for spec in args.extra:
        name, path = spec.split("=", 1)
        sources[name] = ((Path(path) / "bm25_rescore.cu").read_text(), Path(path))
    libs = kv.build_all(sources, Path(args.out), "bm25_rescore.cu", _nvcc(), fragments=("k3_", "k5_"))
    run(libs, torch.device("cuda"))
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
