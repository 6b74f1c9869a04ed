// Per-128-row chunk maxima of Q.D^T + bias for Hopper (sm_90a): kernel K6.
//
// `wax_k6_chunk_maxima` replaces the TPU kernel wax_tpu/ops/chunkmax_scan.py
// `_chunkmax_kernel` (entry `_chunk_maxima`): for every query row b and every chunk c
// of 128 corpus rows it writes
//     cm[b, c] = max over r in chunk c of ( sum_d q[b, d] * e[r, d] + bias[r] ),
// with f32 accumulation (bf16 operands are widened; their products are exact in f32).
// The [B, N] score matrix never reaches device memory: only [B, N/128] maxima do.
//
// Design: a CTA of 256 threads owns a (64-query block x CHUNKS_PER_CTA chunks) pair and
// loops over its chunks; nothing is carried between CTAs. Two paths:
//  * bf16 with d % 64 == 0 (the 1M-row serving shapes): tensor cores through
//    `mma.sync.m16n8k16` (bf16 in, f32 accumulation). The query block is staged in
//    shared memory once; each chunk streams through shared memory 64 depths at a time
//    (rows padded by 16 bytes, so `ldmatrix` is free of bank conflicts); each warp
//    owns a 16-query x 64-row tile. The epilogue adds the bias, takes the maximum over
//    the warp's 64 rows with shuffles and over the two row halves through shared
//    memory. Products of bf16 values are exact in f32, so on exact-arithmetic data
//    the maxima equal the plain twin's bit for bit; otherwise they differ in the last
//    bits of the f32 sums.
//  * f32, or other widths: FMA on the CUDA cores, each thread a 4x8 register
//    micro-tile, operands staged through shared memory 16 depths at a time, the
//    128-row maximum finished with shuffles across the 16 threads of a query row.
//
// What bounds it: at the 1M-row shape (B = 256, N = 1,048,576, d = 384, bf16) the
// corpus read is 805 MB (0.24 ms at 3.35 TB/s) and the products are 206 GFLOP (0.21 ms
// at 989 TFLOP/s bf16), so the bound is the corpus read. Both paths read the corpus
// once per 64-query block (4x at B = 256) and do not overlap loads with products:
// a later change can pull `wgmma` fed by TMA, a wider query block and a load pipeline.
// The FMA path is compute-bound (FP32 FMA: 67 TFLOP/s peak, ~3 ms for 206 GFLOP).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int QB = 64;          // queries per CTA
constexpr int CH = 128;         // corpus rows per chunk
constexpr int DK = 16;          // depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int CHUNKS_PER_CTA = 8;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MMA_DMAX = 1536;  // widest query block the tensor-core path stages

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__global__ void __launch_bounds__(THREADS)
k6_chunk_maxima(const T* __restrict__ q, const T* __restrict__ emb, const float* __restrict__ bias,
                float* __restrict__ cm, int B, int D, int NC) {
  __shared__ __align__(16) float qs[DK * QB];  // [DK][QB]
  __shared__ __align__(16) float es[DK * CH];  // [DK][CH]
  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;  // micro-tile: queries ty*4+i, columns tx+16*j
  const int q0 = blockIdx.y * QB;
  const int c_begin = blockIdx.x * CHUNKS_PER_CTA;
  const int c_end = min(c_begin + CHUNKS_PER_CTA, NC);

  for (int c = c_begin; c < c_end; ++c) {
    const size_t row0 = (size_t)c * CH;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += DK) {
      {  // queries: 64 x 16, four consecutive depths per thread; ragged edge -> 0
        const int r = tid >> 2, dd = (tid & 3) * 4, gq = q0 + r;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int gd = d0 + dd + j;
          qs[(dd + j) * QB + r] = (gq < B && gd < D) ? to_f32(q[(size_t)gq * D + gd]) : 0.f;
        }
      }
      {  // corpus: 128 x 16, eight consecutive depths per thread
        const int r = tid >> 1, dd = (tid & 1) * 8;
        const size_t grow = row0 + r;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int gd = d0 + dd + j;
          es[(dd + j) * CH + r] = gd < D ? to_f32(emb[grow * D + gd]) : 0.f;
        }
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < DK; ++kk) {
        const float4 qa = *reinterpret_cast<const float4*>(&qs[kk * QB + ty * 4]);
        const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
        float ev[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) ev[j] = es[kk * CH + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(qv[i], ev[j], acc[i][j]);
      }
      __syncthreads();
    }

    float bv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) bv[j] = bias[row0 + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float m = acc[i][0] + bv[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) m = fmaxf(m, acc[i][j] + bv[j]);
      // the 16 threads with this ty are lanes (ty & 1) * 16 + tx of one warp
#pragma unroll
      for (int off = 8; off >= 1; off >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, off));
      const int gq = q0 + ty * 4 + i;
      if (tx == 0 && gq < B) cm[(size_t)gq * NC + c] = m;
    }
  }
}

// ------------------------------------------------- bf16 tensor-core path (mma.sync)

constexpr int KB = 64;        // depths per corpus stage
constexpr int BPAD = KB + 8;  // corpus stage row stride (bf16): 144 B, conflict-free ldmatrix

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a (16x16 row-major) * b (16x8, column-major), bf16 in, f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__global__ void __launch_bounds__(THREADS)
k6_chunk_maxima_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ emb,
                    const float* __restrict__ bias, float* __restrict__ cm, int B, int D, int NC) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int QS = D + 8;  // query row stride (bf16)
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);  // [QB][QS]
  __nv_bfloat16* es = qs + QB * QS;                             // [CH][BPAD]
  float* red = reinterpret_cast<float*>(es + CH * BPAD);        // [2][QB]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp & 3, wn = warp >> 2;  // query rows wm*16.., corpus rows wn*64..
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * QB;

  const int dq = D / 8;  // 16-byte pieces per row; ragged query rows are zero
  for (int i = tid; i < QB * dq; i += THREADS) {
    const int r = i / dq, p = i % dq;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < B) v = reinterpret_cast<const uint4*>(q + (size_t)(q0 + r) * D)[p];
    *reinterpret_cast<uint4*>(qs + r * QS + p * 8) = v;
  }

  const int c_begin = blockIdx.x * CHUNKS_PER_CTA;
  const int c_end = min(c_begin + CHUNKS_PER_CTA, NC);
  for (int c = c_begin; c < c_end; ++c) {
    const size_t row0 = (size_t)c * CH;
    float acc[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;

    for (int d0 = 0; d0 < D; d0 += KB) {
      __syncthreads();  // the previous stage (and epilogue) is consumed; qs is staged
      for (int i = tid; i < CH * (KB / 8); i += THREADS) {
        const int r = i / (KB / 8), p = i % (KB / 8);
        *reinterpret_cast<uint4*>(es + r * BPAD + p * 8) =
            reinterpret_cast<const uint4*>(emb + (row0 + r) * D + d0)[p];
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < KB; kk += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, qs + (wm * 16 + (lane & 15)) * QS + d0 + kk + (lane >> 4) * 8);
#pragma unroll
        for (int np = 0; np < 4; ++np) {  // two 8-row n-tiles per ldmatrix
          uint32_t bf[4];
          const int n = wn * 64 + np * 16 + (lane & 7) + ((lane >> 4) << 3);
          ldmatrix_x4(bf, es + n * BPAD + kk + ((lane >> 3) & 1) * 8);
          mma_bf16(acc[2 * np], a, bf[0], bf[1]);
          mma_bf16(acc[2 * np + 1], a, bf[2], bf[3]);
        }
      }
    }

    float m0 = -INFINITY, m1 = -INFINITY;  // query rows g and g + 8 of the warp tile
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const size_t col = row0 + wn * 64 + nt * 8 + 2 * t;
      const float b0 = bias[col], b1 = bias[col + 1];
      m0 = fmaxf(m0, fmaxf(acc[nt][0] + b0, acc[nt][1] + b1));
      m1 = fmaxf(m1, fmaxf(acc[nt][2] + b0, acc[nt][3] + b1));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, off));
      m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, off));
    }
    if (t == 0) {
      red[wn * QB + wm * 16 + g] = m0;
      red[wn * QB + wm * 16 + g + 8] = m1;
    }
    __syncthreads();
    if (tid < QB && q0 + tid < B) cm[(size_t)(q0 + tid) * NC + c] = fmaxf(red[tid], red[QB + tid]);
  }
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: q [B, D], emb [N, D] contiguous and
// of one dtype (f32, or bf16 when is_bf16), bias [N] f32, N % 128 == 0; cm [B, N/128]
// f32. bf16 with D % 64 == 0 and D <= 1536 takes the tensor-core path. Returns a
// cudaError_t (0 = launched).
int wax_k6_chunk_maxima(const void* q, const void* emb, const float* bias, float* cm, int B,
                        int N, int D, int is_bf16, cudaStream_t stream) {
  const int NC = N / CH;
  const dim3 grid((NC + CHUNKS_PER_CTA - 1) / CHUNKS_PER_CTA, (B + QB - 1) / QB);
  if (is_bf16 && D % KB == 0 && D <= MMA_DMAX) {
    const size_t smem = (size_t)QB * (D + 8) * 2 + (size_t)CH * BPAD * 2 + 2 * QB * sizeof(float);
    cudaError_t e = cudaFuncSetAttribute(k6_chunk_maxima_mma, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return (int)e;
    k6_chunk_maxima_mma<<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)emb, bias, cm, B, D, NC);
  } else if (is_bf16) {
    k6_chunk_maxima<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)emb, bias, cm, B, D, NC);
  } else {
    k6_chunk_maxima<float><<<grid, THREADS, 0, stream>>>(
        (const float*)q, (const float*)emb, bias, cm, B, D, NC);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
