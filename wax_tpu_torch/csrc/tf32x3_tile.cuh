// A 3xTF32 tensor-core score tile for Hopper (sm_90a), for the flat-scan kernels.
//
// `scan_blocks` computes, for one block of up to BQ = 64 queries, the f32 dot products
// with consecutive blocks of BN = 128 corpus rows, S = Q . E^T + bias, and hands each
// [64 x 128] block of scores to an epilogue through shared memory. It is what a CTA of
// 256 threads (8 warps) runs; nothing is carried between CTAs.
//
//  * Products: `mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32`, f32 accumulation
//    in registers. Each warp owns a 32-query x 32-row sub-block (2 x 4 m16n8 tiles).
//    Q [B, D] and E [N, D] are both row-major with depth contiguous, which is the
//    layout `row.col` takes: no transpose.
//  * 3xTF32: at fragment load an f32 operand x is split into hi = tf32(x) and
//    lo = tf32(x - hi) (round to nearest, ties away from zero), and a product
//    is accumulated as hi.lo + lo.hi + hi.hi (the two small products first, as
//    CUTLASS's fast-f32 warp MMA does). hi + lo equals x to within 2^-22 |x| and the
//    dropped lo.lo term is below 2^-22 of the product, so a score stays within about
//    1e-6 of the f32 sum on unit vectors. On data whose values need no more than
//    TF32's 11 significant bits (multiples of 1/8, say) lo is 0 and every product and
//    sum is exact. bf16 operands widen to TF32 exactly: lo is 0 and one MMA does.
//  * Depth pipeline: a ring of STAGES shared-memory stages, each a BK = 32 deep slice
//    of the query block and of the corpus block ((64 + 128) rows), filled by 16-byte
//    `cp.async.cg` copies with commit/wait groups, STAGES - 1 slices ahead of the
//    products; the ring runs on across corpus blocks, so the next block's loads are in
//    flight during an epilogue. Rows are padded by 16 bytes, which makes the fragment
//    loads free of bank conflicts. A ragged depth or batch edge is zero-filled through
//    the copy's source-size operand. Where a row's byte stride is not a multiple of 16
//    (f32 with D % 4 != 0, bf16 with D % 8 != 0) or a base pointer is not 16-byte
//    aligned, ordinary loads fill the stages instead: slower, for correctness.
//  * Two stages (55 KB in f32), not three: with a kernel's score block and lists a CTA
//    then fits twice on an SM, and one CTA's products fill the other's epilogue. For
//    K9 at the slice shape (B 256, N 131,072, d 384, f32, k 24) on an NVIDIA H100 80GB
//    HBM3 at 700 W, scripts/k9_variants.py measured 0.806 ms with two 32-deep stages,
//    1.160 ms with three (126 KB: one CTA per SM) and 0.878 / 0.896 ms with three /
//    four 16-deep ones (two CTAs per SM, twice the barriers).
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stddef.h>
#include <stdint.h>

namespace tf32x3 {

constexpr int BQ = 64;        // queries per block
constexpr int BN = 128;       // corpus rows per block
constexpr int BK = 32;        // depth per pipeline stage
constexpr int STAGES = 2;     // cp.async ring depth
constexpr int THREADS = 256;  // 8 warps: 2 (queries) x 4 (corpus rows); two CTAs per SM
constexpr int WM = 32, WN = 32;           // warp sub-block
constexpr int MT = WM / 16, NT = WN / 8;  // m16n8k8 tiles per warp sub-block

// One stage: BQ query rows, then BN corpus rows, BK elements each, padded by 16 bytes.
template <typename T>
struct Stage {
  static constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int LD = BK + EPC;         // row stride in elements
  static constexpr int ROWS = BQ + BN;
  static constexpr int ELEMS = ROWS * LD;
};

template <typename T>
__host__ __device__ constexpr size_t ring_bytes() {
  return sizeof(T) * (size_t)Stage<T>::ELEMS * STAGES;
}

// True when every 16-byte piece of a stage row can be copied with cp.async.
template <typename T>
inline bool can_copy16(const void* q, const void* emb, int D) {
  return ((size_t)D * sizeof(T)) % 16 == 0 && (uintptr_t)q % 16 == 0 && (uintptr_t)emb % 16 == 0;
}

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T>
__device__ __forceinline__ T zero_of() { return T(0.f); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero_of<__nv_bfloat16>() { return __float2bfloat16(0.f); }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes, of which the first `src_bytes` (0 or 16) come from src and the rest are 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x rounded to TF32 (10 mantissa bits), to nearest, ties away from zero, as
// `cvt.rna.tf32.f32` rounds a finite x: two integer operations in place of a
// conversion, which issues at a quarter of their rate.
__device__ __forceinline__ uint32_t to_tf32(float x) { return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u; }

// hi (and, when SPLIT, lo) TF32 parts of x.
template <bool SPLIT>
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  if constexpr (SPLIT) {
    hi = to_tf32(x);
    lo = to_tf32(x - __uint_as_float(hi));
  } else {
    hi = __float_as_uint(x);  // a widened bf16: already a TF32 value
  }
}

// c += a (16x8, row-major) * b (8x8, column-major), TF32 in, f32 accumulation.
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fill one stage with depths d0 .. d0 + BK of query rows q[0 .. nq) (rows past nq are
// 0) and corpus rows e[0 .. BN); depths past D are 0.
template <typename T>
__device__ __forceinline__ void load_stage(T* st, const T* q, int nq, const T* e, int D, int d0, bool vec) {
  using S = Stage<T>;
  if (vec) {
    constexpr int CPR = BK / S::EPC;  // copies per row
    for (int i = threadIdx.x; i < S::ROWS * CPR; i += THREADS) {
      const int r = i / CPR, c = (i % CPR) * S::EPC, gd = d0 + c;
      const bool ok = gd < D && (r >= BQ || r < nq);
      const T* src = !ok ? q : r < BQ ? q + (size_t)r * D + gd : e + (size_t)(r - BQ) * D + gd;
      cp_async16(st + r * S::LD + c, src, ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < S::ROWS * BK; i += THREADS) {
      const int r = i / BK, c = i % BK, gd = d0 + c;
      const bool ok = gd < D && (r >= BQ || r < nq);
      st[r * S::LD + c] = !ok ? zero_of<T>() : r < BQ ? q[(size_t)r * D + gd] : e[(size_t)(r - BQ) * D + gd];
    }
  }
}

// acc += the warp's sub-block of one stage's products (BK deep).
template <typename T>
__device__ __forceinline__ void mma_stage(const T* st, float (&acc)[MT][NT][4], int wm, int wn, int lane) {
  using S = Stage<T>;
  constexpr bool SPLIT = sizeof(T) == 4;  // f32 carries a low part; a widened bf16 does not
  const int g = lane >> 2, t = lane & 3;
  const T* A = st + (wm * WM + g) * S::LD + t;       // a0: (row g, depth t)
  const T* Bm = st + (BQ + wn * WN + g) * S::LD + t;  // b0: (depth t, column g)
#pragma unroll
  for (int kk = 0; kk < BK; kk += 8) {
    uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const T* p = A + mt * 16 * S::LD + kk;
      split<SPLIT>(widen(p[0]), ah[mt][0], al[mt][0]);               // (g,     t)
      split<SPLIT>(widen(p[8 * S::LD]), ah[mt][1], al[mt][1]);       // (g + 8, t)
      split<SPLIT>(widen(p[4]), ah[mt][2], al[mt][2]);               // (g,     t + 4)
      split<SPLIT>(widen(p[8 * S::LD + 4]), ah[mt][3], al[mt][3]);   // (g + 8, t + 4)
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* p = Bm + nt * 8 * S::LD + kk;
      split<SPLIT>(widen(p[0]), bh[nt][0], bl[nt][0]);  // (t,     g)
      split<SPLIT>(widen(p[4]), bh[nt][1], bl[nt][1]);  // (t + 4, g)
    }
    // one pass over the warp's MT x NT tiles per term: consecutive MMAs are independent
    if constexpr (SPLIT) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], ah[mt], bl[nt]);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], al[mt], bh[nt]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma(acc[mt][nt], ah[mt], bh[nt]);
  }
}

__device__ __forceinline__ void zero(float (&acc)[MT][NT][4]) {
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
}

// sc[row * ld + col] = acc + bias[col] for the warp's sub-block (ld even).
__device__ __forceinline__ void store_scores(float (&acc)[MT][NT][4], const float* __restrict__ bias, float* sc,
                                             int ld, int wm, int wn, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int c = wn * WN + nt * 8 + 2 * t;
    const float b0 = bias[c], b1 = bias[c + 1];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int r = wm * WM + mt * 16 + g;  // c0, c1: row g; c2, c3: row g + 8
      *reinterpret_cast<float2*>(sc + r * ld + c) = make_float2(acc[mt][nt][0] + b0, acc[mt][nt][1] + b1);
      *reinterpret_cast<float2*>(sc + (r + 8) * ld + c) = make_float2(acc[mt][nt][2] + b0, acc[mt][nt][3] + b1);
    }
  }
}

// Scores of query rows q[0 .. nq) against corpus rows e[0 .. nblocks * BN), bias
// bias[0 ..]: for each block j of BN rows, sc[r * ld + c] = q[r] . e[j * BN + c] +
// bias[j * BN + c] for r < BQ (rows past nq score 0 + bias), c < BN, then epi(j) with
// every thread of the CTA; sc is not written again until every thread has returned
// from epi. `ring` holds ring_bytes<T>(), `sc` BQ * ld floats (ld even; ld % 32 == 8
// keeps the float2 stores free of bank conflicts). vec: can_copy16<T>(q, e, D).
template <typename T, typename Epilogue>
__device__ __forceinline__ void scan_blocks(const T* __restrict__ q, int nq, const T* __restrict__ e,
                                            const float* __restrict__ bias, int D, int nblocks, bool vec,
                                            T* ring, float* sc, int ld, Epilogue epi) {
  using S = Stage<T>;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp & 1, wn = warp >> 1;
  const int nk = (D + BK - 1) / BK, total = nblocks * nk;
  auto load = [&](int s) {  // slice s: block s / nk, depths (s % nk) * BK ..
    load_stage(ring + (s % STAGES) * S::ELEMS, q, nq, e + (size_t)(s / nk) * BN * D, D, (s % nk) * BK, vec);
  };

  float acc[MT][NT][4];
  zero(acc);

  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < total) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < total; ++s) {
    cp_async_wait<STAGES - 2>();  // slice s has landed (for this thread's copies) ...
    __syncthreads();              // ... for every thread's, and slice s - 1 is consumed
    if (s + STAGES - 1 < total) load(s + STAGES - 1);
    cp_async_commit();
    mma_stage(ring + (s % STAGES) * S::ELEMS, acc, wm, wn, lane);
    if (s % nk == nk - 1) {
      const int j = s / nk;
      store_scores(acc, bias + (size_t)j * BN, sc, ld, wm, wn, lane);
      zero(acc);
      __syncthreads();
      epi(j);
    }
  }
}

}  // namespace tf32x3
