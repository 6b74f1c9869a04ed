// Bucket-gather exact rescore with per-query top-k for Hopper (sm_90a): kernel K7.
//
// `wax_k7_bucket_rescore` replaces the TPU kernel wax_tpu/ops/ivf_kernel.py `_kernel`
// (entry `_run`): for each query b it scores the `nprobe` probed buckets of S rows,
//     s[p * S + r] = sum_d q[b, d] * e[probes[b, p], r, d]   (f32 FMA, q in f32)
// with rows r >= counts[bucket] masked to NEG_INF, and returns the k best candidates
// by (score desc, flat position p * S + r asc): ties go to the lowest position in
// PROBE-RANK order, as the TPU's k-pass extraction gives them. The wrapper decodes
// positions to ids. The chunk-max scan (K6) uses it with buckets = 128-row chunks.
//
// What bounds it: the probed rows, B * nprobe * S * d elements read once; at the
// 1M-row hybrid shape (B 256, 20 chunks of 128 x 384 bf16) 503 MB, 0.15 ms at 3.35 TB/s.
// The products are 0.5 GFLOP, under 0.01 ms: the kernel has to keep enough bytes in
// flight.
//
// Design for k <= 128: one CTA per query, one producer warp and 8 consumer warps, at
// least two CTAs per SM (three at d 384 bf16), so 256 queries are resident at once on
// 132 SMs.
//  * Copies: a bucket [S, d] is contiguous, so a slab of R whole rows (R d elements,
//    up to SLAB_BYTES; 32 rows at d 384 bf16) is one Hopper bulk copy
//    (cp.async.bulk, TMA's 1-D form, no tensor map), which one producer thread starts
//    into a ring of STAGES (2) slabs, each handed over by a `full` mbarrier (completed
//    by the copy's byte count) and an `empty` one (one arrival per consumer warp).
//    Where rows or the base are not 16-byte aligned, the producer warp copies with
//    ordinary loads.
//  * Scores: consumer warp w takes rows w, w + 8, w + 16, w + 24 of a slab together;
//    lane l takes 16-byte pieces l, l + 32, ... of each row from shared memory against
//    the query, staged once in shared memory as f32 (each piece's 8 values as two
//    conflict-free float4), and the sums are reduced with shuffles in the same order as
//    the first port's body, so its scores are bit for bit that body's.
//  * Selection: each warp keeps its best keys in registers, sorted descending (32 a
//    warp, one a lane, for k <= 32; 128, four a lane, for k <= 128), on the u64 key
//    (order-preserving score bits above the complemented position, unique). A row's key
//    is inserted only if it beats the warp's k-th (a ballot count and a one-place
//    shift), so after the first rows most cost one compare. At the end warp 0 merges
//    the 8 lists through shared memory by bitonic merges (flat_scan_keys.cuh). No block
//    barrier runs per output element.
// k > 128, or a slab ring that does not fit shared memory, takes the first port's body:
// a shared-memory plane of nprobe * S keys and k passes of a block-wide arg-max.
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (scripts/k4_k7_variants.py,
// 1,048,576 x 384 bf16, B 256, 20 probes, k 20): 0.1641 ms against 0.4100 ms for the
// arg-max body in the same run, 0.1504 ms of bytes; the copies alone take 0.1593 ms,
// copies and scores 0.1622, so the copies bound it. Two ring stages measured a few
// percent faster than three or four (six, at one CTA per SM, 0.2109); 12 KB slabs
// slower than 24 KB. At x 768 (24 probes, k 24): 0.3828 against 0.5697. PERF.md §6.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flat_scan_keys.cuh"

namespace {

constexpr int CONSUMERS = 8;                   // warps that score and select
constexpr int THREADS = (CONSUMERS + 1) * 32;  // and one producer warp
constexpr int STAGES = 2;                      // slabs in the ring
constexpr int SLAB_BYTES = 24576;              // a slab: whole rows, up to this many bytes
constexpr int ROWS_PER_WARP = 4;               // rows of a slab a consumer warp scores together
constexpr int MAX_SLAB_ROWS = CONSUMERS * ROWS_PER_WARP;
constexpr int ARGMAX_THREADS = 256;
constexpr int ARGMAX_WARPS = ARGMAX_THREADS / 32;
constexpr size_t SMEM_MAX = 227 * 1024;
constexpr float NEG_INF = -3.0e38f;

__device__ __forceinline__ unsigned long long make_key(float s, int pos) {
  unsigned u = __float_as_uint(s);
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return ((unsigned long long)u << 32) | (unsigned long long)(0xFFFFFFFFu - (unsigned)pos);
}

__device__ __forceinline__ float key_value(unsigned long long key) {
  unsigned u = (unsigned)(key >> 32);
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u);
}

__device__ __forceinline__ int key_pos(unsigned long long key) {
  return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
  return a > b ? a : b;
}

// ------------------------------------------------------------------- mbarriers, copies

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(smem_addr(bar))
               : "memory");
}
// An arrival on bar that also expects `bytes` more of transactions (a bulk copy's) this phase.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}
// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra.uni WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// `bytes` (a multiple of 16; both addresses 16-byte aligned) from global to shared
// memory, completing that many bytes of bar's transactions.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes), "r"(smem_addr(bar))
               : "memory");
}

// -------------------------------------------------------------------- slab ring layout

__host__ __device__ constexpr size_t align16(size_t x) { return (x + 15) / 16 * 16; }

// Byte offsets in the ring body's shared memory: STAGES slabs of R rows from 0, then
// the query as f32, the warps' lists (KP keys each) and the full and empty mbarriers.
struct Layout {
  size_t q, lists, bars, total;
  __host__ __device__ Layout(int D, int R, int elem, int KP)
      : q(align16((size_t)STAGES * R * D * elem)),
        lists(q + align16((size_t)D * sizeof(float))),
        bars(lists + (size_t)CONSUMERS * KP * sizeof(unsigned long long)),
        total(bars + 2 * STAGES * sizeof(uint64_t)) {}
};

__host__ __device__ inline int slab_rows(int D, int S, int elem) {
  const int r = SLAB_BYTES / (D * elem);
  return r < 1 ? 1 : (r > MAX_SLAB_ROWS ? MAX_SLAB_ROWS : (r > S ? S : r));
}

__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xFFFF0000u); }
__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// The query in shared memory as f32. vec bf16: piece p's 8 values as two float4, the
// first halves of all pieces, then the second halves; otherwise in order.
template <typename T>
__device__ __forceinline__ void stage_query(float* q_s, const float* q, int D, bool vec, int tid, int nthreads) {
  const bool split = vec && sizeof(T) == 2;
  const int P = D / 8;
  for (int i = tid; i < D; i += nthreads) {
    const int p = i / 8, h = (i / 4) & 1, e = i & 3;
    q_s[split ? (h * P + p) * 4 + e : i] = q[i];
  }
}

// Lane's partial dot products of rows warp + 8 i (i < ROWS_PER_WARP, row < rows) of a
// slab [R, D], then reduced over the warp: every lane returns the sums.
__device__ __forceinline__ void score_rows(const __nv_bfloat16* slab, const float* q_s, int D, int rows, int warp,
                                           int lane, bool vec, float (&acc)[ROWS_PER_WARP]) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i] = 0.f;
  if (vec) {
    const int P = D / 8;
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int p = lane; p < P; p += 32) {
      const float4 a = q4[p], c = q4[P + p];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int rr = warp + CONSUMERS * i;
        if (rr < rows) {
          const uint4 v = reinterpret_cast<const uint4*>(slab + (size_t)rr * D)[p];
          float s = acc[i];
          s = fmaf(a.x, lo_bf16(v.x), s);
          s = fmaf(a.y, hi_bf16(v.x), s);
          s = fmaf(a.z, lo_bf16(v.y), s);
          s = fmaf(a.w, hi_bf16(v.y), s);
          s = fmaf(c.x, lo_bf16(v.z), s);
          s = fmaf(c.y, hi_bf16(v.z), s);
          s = fmaf(c.z, lo_bf16(v.w), s);
          s = fmaf(c.w, hi_bf16(v.w), s);
          acc[i] = s;
        }
      }
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      const float a = q_s[d];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int rr = warp + CONSUMERS * i;
        if (rr < rows) acc[i] = fmaf(a, to_f32(slab[(size_t)rr * D + d]), acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) acc[i] += __shfl_xor_sync(FULL, acc[i], off);
}

__device__ __forceinline__ void score_rows(const float* slab, const float* q_s, int D, int rows, int warp, int lane,
                                           bool vec, float (&acc)[ROWS_PER_WARP]) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) acc[i] = 0.f;
  if (vec) {
    const int P = D / 4;
    const float4* q4 = reinterpret_cast<const float4*>(q_s);
    for (int p = lane; p < P; p += 32) {
      const float4 a = q4[p];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int rr = warp + CONSUMERS * i;
        if (rr < rows) {
          const float4 v = reinterpret_cast<const float4*>(slab + (size_t)rr * D)[p];
          float s = acc[i];
          s = fmaf(a.x, v.x, s);
          s = fmaf(a.y, v.y, s);
          s = fmaf(a.z, v.z, s);
          s = fmaf(a.w, v.w, s);
          acc[i] = s;
        }
      }
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      const float a = q_s[d];
#pragma unroll
      for (int i = 0; i < ROWS_PER_WARP; ++i) {
        const int rr = warp + CONSUMERS * i;
        if (rr < rows) acc[i] = fmaf(a, slab[(size_t)rr * D + d], acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i)
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) acc[i] += __shfl_xor_sync(FULL, acc[i], off);
}

// Insert key x (warp-uniform, > the k-th) into the warp's descending list lv (position
// t * 32 + lane in lv[t]); kth := the new k-th key (list position kr * 32 + kl).
template <int KR>
__device__ __forceinline__ void insert_key(unsigned long long (&lv)[KR], unsigned long long x, int kr, int kl,
                                           int lane, unsigned long long& kth) {
  int p = 0;  // x's position: the count of larger keys
#pragma unroll
  for (int t = 0; t < KR; ++t) p += __popc(__ballot_sync(FULL, lv[t] > x));
  unsigned long long carry = 0ull;
#pragma unroll
  for (int t = 0; t < KR; ++t) {
    unsigned long long up = __shfl_up_sync(FULL, lv[t], 1);
    const unsigned long long last = __shfl_sync(FULL, lv[t], 31);
    if (lane == 0) up = carry;
    carry = last;
    const int i = t * 32 + lane;
    lv[t] = i < p ? lv[t] : (i == p ? x : up);
    if (t == kr) kth = __shfl_sync(FULL, lv[t], kl);
  }
}

// The warp's keys of its rows of slab j (probe p, rows r0 ..), into its list.
template <int KR>
__device__ __forceinline__ void select_rows(const float (&acc)[ROWS_PER_WARP], unsigned long long (&lv)[KR],
                                            unsigned long long& kth, int p, int r0, int rows, int live, int S,
                                            int warp, int kr, int kl, int lane) {
#pragma unroll
  for (int i = 0; i < ROWS_PER_WARP; ++i) {
    const int rr = warp + CONSUMERS * i;
    if (rr < rows) {
      const int r = r0 + rr;
      const unsigned long long key = make_key(r < live ? acc[i] : NEG_INF, p * S + r);
      if (key > kth) insert_key<KR>(lv, key, kr, kl, lane, kth);
    }
  }
}

// KR = 1 (k <= 32) or 4 (k <= 128): list keys a lane.
template <typename T, int KR>
__global__ void __launch_bounds__(THREADS, 2)
k7_bucket_rescore(const float* __restrict__ q, const int32_t* __restrict__ probes,
                  const int32_t* __restrict__ counts, const T* __restrict__ emb, float* __restrict__ vals,
                  int32_t* __restrict__ pos_out, int D, int S, int NPROBE, int K, int R, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(D, R, sizeof(T), 32 * KR);
  T* ring = reinterpret_cast<T*>(smem);
  float* q_s = reinterpret_cast<float*>(smem + lay.q);
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem + lay.lists);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bars);
  uint64_t* empty = full + STAGES;
  const int b = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int spb = (S + R - 1) / R, NS = NPROBE * spb;  // slabs a bucket, slabs in all
  const size_t stage_elems = (size_t)R * D;
  const int32_t* pr = probes + (size_t)b * NPROBE;

  stage_query<T>(q_s, q + (size_t)b * D, D, vec != 0, threadIdx.x, THREADS);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], vec ? 1 : 32);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS) {  // the producer warp
    if (vec) {
      if (lane == 0) {
        for (int j = 0; j < NS; ++j) {
          const int st = j % STAGES, p = j / spb, r0 = (j % spb) * R, rows = min(R, S - r0);
          if (j >= STAGES) mbar_wait(&empty[st], ((j / STAGES) - 1) & 1);
          const uint32_t bytes = (uint32_t)(rows * D * sizeof(T));
          mbar_arrive_expect_tx(&full[st], bytes);
          bulk_copy(ring + st * stage_elems, emb + ((size_t)__ldg(pr + p) * S + r0) * D, bytes, &full[st]);
        }
      }
      __syncwarp();
    } else {
      for (int j = 0; j < NS; ++j) {
        const int st = j % STAGES, p = j / spb, r0 = (j % spb) * R, rows = min(R, S - r0);
        if (j >= STAGES) mbar_wait(&empty[st], ((j / STAGES) - 1) & 1);
        const T* src = emb + ((size_t)__ldg(pr + p) * S + r0) * D;
        T* dst = ring + st * stage_elems;
        for (int i = lane; i < rows * D; i += 32) dst[i] = src[i];
        mbar_arrive(&full[st]);
      }
    }
  } else {  // consumer warps
    unsigned long long lv[KR], kth = 0ull;  // 0: below every key
#pragma unroll
    for (int t = 0; t < KR; ++t) lv[t] = 0ull;
    const int kr = (K - 1) >> 5, kl = (K - 1) & 31;
    for (int j = 0; j < NS; ++j) {
      const int st = j % STAGES, p = j / spb, r0 = (j % spb) * R, rows = min(R, S - r0);
      mbar_wait(&full[st], (j / STAGES) & 1);
      float acc[ROWS_PER_WARP];
      score_rows(ring + st * stage_elems, q_s, D, rows, warp, lane, vec != 0, acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      select_rows<KR>(acc, lv, kth, p, r0, rows, __ldg(counts + __ldg(pr + p)), S, warp, kr, kl, lane);
    }
#pragma unroll
    for (int t = 0; t < KR; ++t) lists[(size_t)warp * 32 * KR + t * 32 + lane] = lv[t];
  }
  __syncthreads();

  if (warp == 0) {  // merge the warps' lists
    unsigned long long lv[KR];
#pragma unroll
    for (int t = 0; t < KR; ++t) lv[t] = lists[t * 32 + lane];
    for (int w = 1; w < CONSUMERS; ++w) {
      unsigned long long s[KR];
#pragma unroll
      for (int t = 0; t < KR; ++t) s[t] = lists[(size_t)w * 32 * KR + t * 32 + lane];
      if constexpr (KR == 1) {
        merge32_desc(lv[0], s[0], lane);
      } else {
        merge128_desc(lv, s, lane);
      }
    }
#pragma unroll
    for (int t = 0; t < KR; ++t) {
      const int i = t * 32 + lane;
      if (i < K) {
        vals[(size_t)b * K + i] = key_value(lv[t]);
        pos_out[(size_t)b * K + i] = key_pos(lv[t]);
      }
    }
  }
}

// ------------------------------------------------------- k > 128: k passes of arg-max

// dot(q_s, row) over D elements; the full warp participates, lane 0..31 return the sum.
__device__ __forceinline__ float row_dot(const float* q_s, const float* row, int D, int lane, bool vec) {
  float acc = 0.f;
  if (vec) {  // 16-byte pieces of 4 floats
    const float4* r4 = reinterpret_cast<const float4*>(row);
    for (int p = lane; p < D / 4; p += 32) {
      const float4 v = r4[p];
      const float* qq = q_s + 4 * p;
      acc = fmaf(qq[0], v.x, acc);
      acc = fmaf(qq[1], v.y, acc);
      acc = fmaf(qq[2], v.z, acc);
      acc = fmaf(qq[3], v.w, acc);
    }
  } else {
    for (int i = lane; i < D; i += 32) acc = fmaf(q_s[i], row[i], acc);
  }
  return acc;
}

__device__ __forceinline__ float row_dot(const float* q_s, const __nv_bfloat16* row, int D, int lane, bool vec) {
  float acc = 0.f;
  if (vec) {  // 16-byte pieces of 8 bf16
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int p = lane; p < D / 8; p += 32) {
      const uint4 v = r4[p];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      const float* qq = q_s + 8 * p;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        acc = fmaf(qq[2 * h], lo_bf16(w[h]), acc);
        acc = fmaf(qq[2 * h + 1], hi_bf16(w[h]), acc);
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) acc = fmaf(q_s[i], __bfloat162float(row[i]), acc);
  }
  return acc;
}

// One CTA of 256 threads per query: the scores as keys in a shared plane of
// NPROBE * S entries, then k passes of a block-wide arg-max (a taken key is zeroed;
// every live key is > 0).
template <typename T>
__global__ void __launch_bounds__(ARGMAX_THREADS)
k7_bucket_rescore_argmax(const float* __restrict__ q, const int32_t* __restrict__ probes,
                         const int32_t* __restrict__ counts, const T* __restrict__ emb, float* __restrict__ vals,
                         int32_t* __restrict__ pos_out, int D, int S, int NPROBE, int K, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [NPROBE * S]
  float* q_s = reinterpret_cast<float*>(keys + (size_t)NPROBE * S);        // [D]
  __shared__ unsigned long long red[ARGMAX_WARPS];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = NPROBE * S;
  for (int i = tid; i < D; i += ARGMAX_THREADS) q_s[i] = q[(size_t)b * D + i];
  __syncthreads();

  for (int p = 0; p < NPROBE; ++p) {
    const int bucket = probes[(size_t)b * NPROBE + p];
    const int live = counts[bucket];
    const T* base = emb + (size_t)bucket * S * D;
    for (int r = warp; r < S; r += ARGMAX_WARPS) {
      float s = row_dot(q_s, base + (size_t)r * D, D, lane, vec != 0);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) keys[p * S + r] = make_key(r < live ? s : NEG_INF, p * S + r);
    }
  }
  __syncthreads();

  for (int t = 0; t < K; ++t) {
    unsigned long long best = 0ull;
    for (int i = tid; i < W; i += ARGMAX_THREADS) best = umax64(best, keys[i]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) best = umax64(best, __shfl_xor_sync(FULL, best, off));
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < ARGMAX_WARPS ? red[lane] : 0ull;
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) best = umax64(best, __shfl_xor_sync(FULL, best, off));
      if (lane == 0) {
        vals[(size_t)b * K + t] = key_value(best);
        pos_out[(size_t)b * K + t] = key_pos(best);
        keys[key_pos(best)] = 0ull;
      }
    }
    __syncthreads();
  }
}

template <typename Kern>
int launch_prep(Kern kern, size_t smem) {
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// The ring body takes k <= 128 where its slabs fit shared memory.
__host__ __device__ inline bool ring_body(int K, size_t smem) { return K <= 128 && smem <= SMEM_MAX; }

// CTAs of the ring body an SM holds with `smem` bytes of dynamic shared memory each.
template <typename Kern>
int occupancy(Kern kern, size_t smem, int* per_sm) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, kern, THREADS, smem);
  return (int)e;
}

template <typename T>
int launch(const float* q, const int32_t* probes, const int32_t* counts, const T* emb, float* vals, int32_t* pos,
           int B, int D, int S, int NPROBE, int K, int vec, cudaStream_t stream) {
  const int R = slab_rows(D, S, sizeof(T));
  const int KR = K <= 32 ? 1 : 4;
  const size_t smem = Layout(D, R, sizeof(T), 32 * KR).total;
  int err;
  if (ring_body(K, smem)) {
    if (KR == 1) {
      if ((err = launch_prep(k7_bucket_rescore<T, 1>, smem))) return err;
      k7_bucket_rescore<T, 1><<<B, THREADS, smem, stream>>>(q, probes, counts, emb, vals, pos, D, S, NPROBE, K, R,
                                                           vec);
    } else {
      if ((err = launch_prep(k7_bucket_rescore<T, 4>, smem))) return err;
      k7_bucket_rescore<T, 4><<<B, THREADS, smem, stream>>>(q, probes, counts, emb, vals, pos, D, S, NPROBE, K, R,
                                                           vec);
    }
  } else {
    const size_t smem2 = (size_t)NPROBE * S * sizeof(unsigned long long) + (size_t)D * sizeof(float);
    if ((err = launch_prep(k7_bucket_rescore_argmax<T>, smem2))) return err;
    k7_bucket_rescore_argmax<T><<<B, ARGMAX_THREADS, smem2, stream>>>(q, probes, counts, emb, vals, pos, D, S,
                                                                       NPROBE, K, vec);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: q [B, D] f32, probes [B, NPROBE] i32
// bucket ids, counts [C] i32 live rows per bucket, emb [C, S, D] contiguous (f32, or
// bf16 when is_bf16); vals [B, K] f32 and pos [B, K] i32 out, 1 <= K <= NPROBE * S.
// Returns a cudaError_t (0 = launched).
int wax_k7_bucket_rescore(const float* q, const int32_t* probes, const int32_t* counts,
                          const void* emb, float* vals, int32_t* pos, int B, int D, int S,
                          int NPROBE, int K, int is_bf16, cudaStream_t stream) {
  const size_t elem = is_bf16 ? 2 : 4;
  // bulk copies and 16-byte loads need 16-byte rows on a 16-byte aligned base
  const int vec = (D * elem) % 16 == 0 && reinterpret_cast<uintptr_t>(emb) % 16 == 0;
  if (is_bf16)
    return launch<__nv_bfloat16>(q, probes, counts, (const __nv_bfloat16*)emb, vals, pos, B, D, S, NPROBE, K, vec,
                                 stream);
  return launch<float>(q, probes, counts, (const float*)emb, vals, pos, B, D, S, NPROBE, K, vec, stream);
}

// How K7 launches for rows of D elements (bf16 or f32), buckets of S rows and this k:
// out = {1 for the ring body (0: the arg-max body), rows per slab, dynamic shared memory
// per CTA of the ring body, its CTAs per SM}. Returns a cudaError_t.
int wax_k7_plan(int D, int S, int K, int is_bf16, int* out) {
  const int elem = is_bf16 ? 2 : 4, R = slab_rows(D, S, elem), KR = K <= 32 ? 1 : 4;
  const size_t smem = Layout(D, R, elem, 32 * KR).total;
  int per_sm = 0, e = 0;
  if (ring_body(K, smem)) {
    if (is_bf16)
      e = KR == 1 ? occupancy(k7_bucket_rescore<__nv_bfloat16, 1>, smem, &per_sm)
                  : occupancy(k7_bucket_rescore<__nv_bfloat16, 4>, smem, &per_sm);
    else
      e = KR == 1 ? occupancy(k7_bucket_rescore<float, 1>, smem, &per_sm)
                  : occupancy(k7_bucket_rescore<float, 4>, smem, &per_sm);
  }
  out[0] = ring_body(K, smem);
  out[1] = R;
  out[2] = (int)smem;
  out[3] = per_sm;
  return e;
}

}  // extern "C"
