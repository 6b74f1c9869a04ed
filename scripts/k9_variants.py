#!/usr/bin/env python3
"""Build variants of the port's K9 kernel (wax_tpu_torch/csrc/packed_topk.cu) and time
them against the built K9 on one NVIDIA GPU.

    python3 scripts/k9_variants.py [--out DIR]

Each variant is a copy of packed_topk.cu and its two headers with one thing changed:
the depth and number of the `cp.async` ring's stages (with the CTAs per SM that its
shared memory allows), K1's former one-at-a-time selection in place of K9's, the TF32 rounding
by `cvt.rna.tf32.f32` in place of integer operations, or a part taken out (the
selection, to see what the rest costs). Each is built with nvcc into its own
library under DIR (default wax_tpu_torch/_build/k9_variants), checked bit for bit
against the plain twin on exact-arithmetic data (except the ablations, which compute
something else), and timed with CUDA events at the slice shape (131,072 x 384, B 256,
k 24 and k 100, f32 and bf16) and the headline shape (10,240 x 384, k 10), beside the
built K9 and torch.matmul f32. Variants named `*_prof` also read clock64 counters:
cycles per CTA in all and in the epilogue (selection and the barrier after it).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
SRC = REPO / "wax_tpu_torch" / "csrc"
SELECT = "merge_rows<PackedKey>(sc, SC_LD, lists, KP, K, r0, nr, j * BN, lane);"
K1_SELECT = "select_rows<PackedKey>(sc, SC_LD, BN, lists, KP, K, r0, nr, j * BN, lane);"
# The one-at-a-time selection through shared memory that K1 and K2 used before they
# moved onto merge_rows; the "k1sel" variants add it to flat_scan_keys.cuh.
K1_SELECT_FNS = """
// Insert x into the warp's descending list L[0..K) (x beats L[K-1]).
template <typename KT>
__device__ __forceinline__ void list_insert(KT* L, int K, KT x, int lane) {
  int p = 0;
  for (int base = 0; base < K; base += 32) {
    int i = base + lane;
    p += __popc(__ballot_sync(FULL, i < K && L[i] > x));
  }
  KT v[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    int i = t * 32 + lane;
    if (i > p && i < K) v[t] = L[i - 1];
  }
  __syncwarp();
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    int i = t * 32 + lane;
    if (i > p && i < K) L[i] = v[t];
  }
  if (lane == 0) L[p] = x;
  __syncwarp();
}

// One warp merges rows r0 .. r0 + nr of a block of scores into the rows' lists: 32 keys
// at a time are filtered against the k-th key, and the rare winner is inserted.
template <typename Key>
__device__ __forceinline__ void select_rows(const float* sc, int ld, int cols, typename Key::T* lists, int KP,
                                            int K, int r0, int nr, int c0, int lane) {
  using KT = typename Key::T;
  for (int r = r0; r < r0 + nr; ++r) {
    KT* L = lists + (size_t)r * KP;
    for (int cc = 0; cc < cols; cc += 32) {
      const int col = cc + lane;
      const KT key = Key::make(sc[r * ld + col], c0 + col);
      unsigned m = __ballot_sync(FULL, key > L[K - 1]);
      while (m) {
        const int src = __ffs(m) - 1;
        m &= m - 1;
        const KT x = __shfl_sync(FULL, key, src);
        if (x > L[K - 1]) list_insert(L, K, x, lane);
      }
    }
  }
}

"""
TO_TF32 = "__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }"
CVT_TF32 = ('__device__ __forceinline__ uint32_t to_tf32(float x) { uint32_t r; '
            'asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x)); return r; }')
# name: (ring depth BK, STAGES, CTAs per SM in __launch_bounds__, change)
VARIANTS = {
    "bk32_s2": (32, 2, 2, ""),
    "bk32_s2_prof": (32, 2, 2, "prof"),
    "bk32_s2_k1sel": (32, 2, 2, "k1sel"),
    "bk32_s2_k1sel_prof": (32, 2, 2, "k1sel prof"),
    "bk32_s2_nosel": (32, 2, 2, "nosel"),
    "bk32_s2_cvt": (32, 2, 2, "cvt"),
    "bk32_s3": (32, 3, 1, ""),
    "bk16_s3": (16, 3, 2, ""),
    "bk16_s4": (16, 4, 2, ""),
}
PROF = """
__device__ unsigned long long prof_cycles[2];  // all, epilogue: summed over CTAs
extern "C" int read_prof(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, prof_cycles, sizeof(prof_cycles));
  const unsigned long long z[2] = {0, 0};
  cudaMemcpyToSymbol(prof_cycles, z, sizeof(z));
  return (int)e;
}
"""


def _sub(text: str, old: str, new: str) -> str:
    if old not in text:
        raise RuntimeError(f"variant edit does not apply: {old!r}")
    return text.replace(old, new)


def variant_sources(bk: int, stages: int, ctas: int, change: str) -> dict[str, str]:
    tile = (SRC / "tf32x3_tile.cuh").read_text()
    tile = _sub(tile, "constexpr int BK = 32;", f"constexpr int BK = {bk};")
    tile = _sub(tile, "constexpr int STAGES = 2;", f"constexpr int STAGES = {stages};")
    if change == "cvt":
        tile = _sub(tile, TO_TF32, CVT_TF32)
    k9 = (SRC / "packed_topk.cu").read_text()
    k9 = _sub(k9, "__launch_bounds__(THREADS, 2)", f"__launch_bounds__(THREADS, {ctas})")
    select = K1_SELECT if "k1sel" in change else "" if "nosel" in change else SELECT
    if "prof" in change:
        k9 = _sub(k9, '#include "tf32x3_tile.cuh"', '#include "tf32x3_tile.cuh"\n' + PROF)
        select = (f"long long t0 = clock64(); {select} __syncthreads(); "
                  "if (threadIdx.x == 0) atomicAdd(&prof_cycles[1], (unsigned long long)(clock64() - t0));")
        k9 = _sub(k9, "  for (int i = threadIdx.x; i < BQ * KP; i += THREADS) lists[i]",
                  "  const long long t_start = clock64();\n  for (int i = threadIdx.x; i < BQ * KP; i += THREADS) lists[i]")
        k9 = _sub(k9, "  __syncthreads();\n  for (int i = threadIdx.x; i < nq * K; i += THREADS) {",
                  "  __syncthreads();\n  if (threadIdx.x == 0) atomicAdd(&prof_cycles[0], (unsigned long long)(clock64() - t_start));\n"
                  "  for (int i = threadIdx.x; i < nq * K; i += THREADS) {")
    k9 = _sub(k9, SELECT, select)
    keys = (SRC / "flat_scan_keys.cuh").read_text()
    if "k1sel" in change:
        keys = _sub(keys, "// 128 keys held 4 per lane", K1_SELECT_FNS + "// 128 keys held 4 per lane")
    return {"tf32x3_tile.cuh": tile, "packed_topk.cu": k9, "flat_scan_keys.cuh": keys}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(REPO / "wax_tpu_torch" / "_build" / "k9_variants"))
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from wax_tpu_torch.ops import flat_scan as fs
    from wax_tpu_torch.ops._build import _SIGNATURES, _nvcc

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    print(smi, flush=True)
    out = Path(args.out)
    jobs = {}
    for name, spec in VARIANTS.items():
        d = out / name
        d.mkdir(parents=True, exist_ok=True)
        for fname, text in variant_sources(*spec).items():
            (d / fname).write_text(text)
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
               "-Xptxas=-v", "-shared", "-o", str(d / "lib.so"), str(d / "packed_topk.cu")]
        jobs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    kernels, profs = {}, {}
    for name, (d, proc) in jobs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", flush=True)
            return 1
        regs = [ln.split(":", 1)[1].strip() for ln in log.splitlines() if "Used" in ln and "registers" in ln]
        print(f"{name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        fn = lib.wax_k9_packed_topk
        fn.argtypes, fn.restype = _SIGNATURES["wax_k9_packed_topk"], ctypes.c_int
        kernels[name] = fn
        if "prof" in name:
            lib.read_prof.argtypes, lib.read_prof.restype = [ctypes.c_void_p], ctypes.c_int
            profs[name] = lib.read_prof

    def run(fn, q, e, bias, k, tn):
        b, (n, d) = q.shape[0], e.shape
        res = torch.empty((b, n // tn * k), dtype=torch.int32, device=q.device)
        err = fn(q.data_ptr(), e.data_ptr(), bias.data_ptr(), res.data_ptr(), b, n, d, tn, k,
                 int(q.dtype == torch.bfloat16), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: CUDA error {err}")
        return res

    def ms(f, iters=20):
        for _ in range(3):
            f()
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            f()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    shapes = [("slice 131072x384 B=256 k=24 f32", 131072, 24, torch.float32),
              ("headline 10240x384 B=256 k=10 f32", 10240, 10, torch.float32),
              ("slice 131072x384 B=256 k=24 bf16", 131072, 24, torch.bfloat16),
              ("slice 131072x384 B=256 k=100 f32", 131072, 100, torch.float32)]
    b, d, tn = 256, 384, 2048
    for label, n, k, dt in shapes:
        qx = (torch.randint(-8, 9, (b, d), generator=g) / 8.0).to(dev, dt).contiguous()
        ex = (torch.randint(-8, 9, (n, d), generator=g) / 8.0).to(dev, dt).contiguous()
        q = fs.normalize_rows(torch.randn((b, d), generator=g)).to(dev, dt).contiguous()
        e = fs.normalize_rows(torch.randn((n, d), generator=g)).to(dev, dt).contiguous()
        bias = torch.zeros(n, device=dev)
        want = fs._packed_sel_topk_plain(qx, ex, bias, k, tn)
        parts = [f"built K9 {ms(lambda: fs.packed_topk_tiles(q, e, bias, k, tn)):.4f}"]
        for name, fn in kernels.items():
            exact = "ablation" if "nosel" in name else torch.equal(run(fn, qx, ex, bias, k, tn), want)
            if exact is False:
                print(f"{label} {name}: differs from the plain twin on exact data", flush=True)
                return 1
            parts.append(f"{name} {ms(lambda: run(fn, q, e, bias, k, tn)):.4f}")
            if name in profs:
                buf = np.zeros(2, dtype=np.uint64)
                profs[name](buf.ctypes.data)
                run(fn, q, e, bias, k, tn)
                torch.cuda.synchronize()
                profs[name](buf.ctypes.data)
                ctas = (b + 63) // 64 * (n // tn)
                parts.append(f"{name} cycles per CTA {buf[0] / ctas:.0f}, epilogue {buf[1] / ctas:.0f} "
                             f"({100 * buf[1] / max(buf[0], 1):.1f}%)")
        parts.append(f"built K9 {ms(lambda: fs.packed_topk_tiles(q, e, bias, k, tn)):.4f}")
        parts.append(f"torch.matmul f32 {ms(lambda: torch.matmul(q.float(), e.float().t())):.4f}")
        print(f"{label} (ms): " + "; ".join(parts), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
