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
// Design: one CTA of 256 threads per query. The query is staged in shared memory as
// f32; each warp takes rows of the current bucket and reads each row with coalesced
// 16-byte loads (lane j takes 16-byte pieces j, j+32, ...), reduces its dot product
// with shuffles, and writes the score to a shared-memory plane of nprobe * S entries.
// Selection is k passes of a block-wide arg-max over 64-bit keys
// (order-preserving score bits above the complemented position), which is exact and
// keeps the lowest-position rule.
//
// What bounds it: the probed rows, B * nprobe * S * d elements read once; at the
// 1M-row hybrid shape (B 256, 20 chunks of 128 x 384 bf16) 503 MB, 0.15 ms at 3.35 TB/s.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xFFFFFFFFu;
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

// dot(q_s, row) over D elements; the full warp participates, lane 0..31 return the sum.
__device__ __forceinline__ float row_dot(const float* q_s, const float* row, int D, int lane,
                                         bool vec) {
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

__device__ __forceinline__ float row_dot(const float* q_s, const __nv_bfloat16* row, int D,
                                         int lane, bool vec) {
  float acc = 0.f;
  if (vec) {  // 16-byte pieces of 8 bf16
    const uint4* r4 = reinterpret_cast<const uint4*>(row);
    for (int p = lane; p < D / 8; p += 32) {
      const uint4 v = r4[p];
      const unsigned w[4] = {v.x, v.y, v.z, v.w};
      const float* qq = q_s + 8 * p;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        acc = fmaf(qq[2 * h], __uint_as_float(w[h] << 16), acc);
        acc = fmaf(qq[2 * h + 1], __uint_as_float(w[h] & 0xFFFF0000u), acc);
      }
    }
  } else {
    for (int i = lane; i < D; i += 32) acc = fmaf(q_s[i], __bfloat162float(row[i]), acc);
  }
  return acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k7_bucket_rescore(const float* __restrict__ q, const int32_t* __restrict__ probes,
                  const int32_t* __restrict__ counts, const T* __restrict__ emb,
                  float* __restrict__ vals, int32_t* __restrict__ pos_out, int D, int S,
                  int NPROBE, int K, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* keys = reinterpret_cast<unsigned long long*>(smem);  // [NPROBE * S]
  float* q_s = reinterpret_cast<float*>(keys + (size_t)NPROBE * S);        // [D]
  __shared__ unsigned long long red[WARPS];

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = NPROBE * S;
  for (int i = tid; i < D; i += THREADS) q_s[i] = q[(size_t)b * D + i];
  __syncthreads();

  for (int p = 0; p < NPROBE; ++p) {
    const int bucket = probes[(size_t)b * NPROBE + p];
    const int live = counts[bucket];
    const T* base = emb + (size_t)bucket * S * D;
    for (int r = warp; r < S; r += WARPS) {
      float s = row_dot(q_s, base + (size_t)r * D, D, lane, vec != 0);
#pragma unroll
      for (int off = 16; off >= 1; off >>= 1) s += __shfl_xor_sync(FULL, s, off);
      if (lane == 0) keys[p * S + r] = make_key(r < live ? s : NEG_INF, p * S + r);
    }
  }
  __syncthreads();

  // k passes of a block-wide arg-max; a taken key is zeroed (every live key is > 0)
  for (int t = 0; t < K; ++t) {
    unsigned long long best = 0ull;
    for (int i = tid; i < W; i += THREADS) best = umax64(best, keys[i]);
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) best = umax64(best, __shfl_xor_sync(FULL, best, off));
    if (lane == 0) red[warp] = best;
    __syncthreads();
    if (warp == 0) {
      best = lane < WARPS ? red[lane] : 0ull;
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

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: q [B, D] f32, probes [B, NPROBE] i32
// bucket ids, counts [C] i32 live rows per bucket, emb [C, S, D] contiguous (f32, or
// bf16 when is_bf16); vals [B, K] f32 and pos [B, K] i32 out, 1 <= K <= NPROBE * S.
// Returns a cudaError_t (0 = launched).
int wax_k7_bucket_rescore(const float* q, const int32_t* probes, const int32_t* counts,
                          const void* emb, float* vals, int32_t* pos, int B, int D, int S,
                          int NPROBE, int K, int is_bf16, cudaStream_t stream) {
  const size_t smem = (size_t)NPROBE * S * sizeof(unsigned long long) + (size_t)D * sizeof(float);
  const size_t elem = is_bf16 ? 2 : 4;
  const int vec = (D * elem) % 16 == 0;
  int err;
  if (is_bf16) {
    if ((err = launch_prep(k7_bucket_rescore<__nv_bfloat16>, smem))) return err;
    k7_bucket_rescore<__nv_bfloat16><<<B, THREADS, smem, stream>>>(
        q, probes, counts, (const __nv_bfloat16*)emb, vals, pos, D, S, NPROBE, K, vec);
  } else {
    if ((err = launch_prep(k7_bucket_rescore<float>, smem))) return err;
    k7_bucket_rescore<float><<<B, THREADS, smem, stream>>>(
        q, probes, counts, (const float*)emb, vals, pos, D, S, NPROBE, K, vec);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
