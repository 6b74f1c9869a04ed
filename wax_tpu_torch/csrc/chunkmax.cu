// Per-128-row chunk maxima of Q.D^T + bias for Hopper (sm_90a): kernel K6.
//
// `wax_k6_chunk_maxima` replaces the TPU kernel wax_tpu/ops/chunkmax_scan.py
// `_chunkmax_kernel` (entry `_chunk_maxima`): for every query row b and every chunk c
// of 128 corpus rows it writes
//     cm[b, c] = max over r in chunk c of ( sum_d q[b, d] * e[r, d] + bias[r] ),
// with f32 accumulation (bf16 operands are widened; their products are exact in f32).
// The [B, N] score matrix never reaches device memory: only [B, N/128] maxima do.
//
// What bounds it: at the 1M-row serving shape (B 256, N 1,048,576, bf16) the corpus
// read is 805 MB at d 384 (0.24 ms at 3.35 TB/s) and the products 206 GFLOP (0.21 ms
// at 989 TFLOP/s), 1.61 GB and 412 GFLOP at d 768: about 256 flop per corpus byte,
// just under the card's ridge. So the corpus must leave device memory about once per
// batch while the tensor cores stay busy.
//
// Two paths:
//  * bf16 with d % 64 == 0 (the serving shapes): tensor cores through
//    `mma.sync.m16n8k16` (bf16 in, f32 accumulation). A CTA owns a block of 256
//    queries (128 when B <= 128), so at B 256 the corpus is read once. The grid is
//    persistent: one CTA per SM for each query block, CTA x walking chunks x, x +
//    gridDim.x, ..., so the CTAs of a query block read neighbouring chunks at the same
//    time. Both operands stream through a ring of STAGES shared-memory stages of BK
//    depths each ((256 + 128) rows, padded by 16 bytes, so `ldmatrix` is free of bank
//    conflicts); the ring runs on across chunks, and shared memory does not grow with
//    d. The CTA is warp-specialised: 4 producer warps fill the ring with 16-byte
//    `cp.async.cg` copies and 8 consumer warps take the products; each stage is handed
//    over by a `full` and an `empty` mbarrier, so no CTA-wide barrier runs in the loop
//    and a stalled copy never stalls a product. Each consumer warp owns 16 or 32
//    queries x all 128 rows of the chunk, so a chunk's maximum is taken in registers
//    with two shuffles. A chunk's bias rides in the ring with its first slice. Base
//    pointers that are not 16-byte aligned fill the stages with ordinary loads
//    (slower, for correctness). Products of bf16 values are exact in f32, so on
//    exact-arithmetic data the maxima equal the plain twin's bit for bit; otherwise the
//    f32 sums differ in the last bits (about 3e-7 on unit vectors).
//  * f32, or other widths: FMA on the CUDA cores, each thread a 4x8 register
//    micro-tile over a 64-query block, operands staged through shared memory 16
//    depths at a time, the 128-row maximum finished with shuffles across the 16
//    threads of a query row. It reads the corpus once per 64 queries and is
//    compute-bound (FP32 FMA: 67 TFLOP/s peak, ~3 ms for 206 GFLOP).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py, B 256,
// N 1,048,576, bf16): 0.5961 ms at d 384 and 1.1012 ms at d 768, against 0.4994 and
// 0.7779 ms for torch.matmul bf16 (which writes the whole [B, N] product) and bounds of
// 0.2442 and 0.4847 ms; the 64-query design this replaces took 1.7799 and 7.8073 ms.
// What still bounds the tensor-core path (scripts/k6_variants.py, same card): every
// chunk copies its 256 query rows again from L2, so the ring takes in 2.4 GB at d 384
// for an 805 MB corpus; the copies alone (no products) take as long as the whole
// kernel, and the products alone (no copies) about 0.48 ms, half the card's bf16 rate,
// which is what `mma.sync` reaches here. Sharing the query slices across SMs (TMA
// multicast to a cluster) and `wgmma` are the next steps.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int QB = 64;          // queries per CTA (FMA path)
constexpr int CH = 128;         // corpus rows per chunk
constexpr int DK = 16;          // depth per shared-memory stage (FMA path)
constexpr int THREADS = 256;
constexpr int CHUNKS_PER_CTA = 8;  // FMA path
constexpr unsigned FULL = 0xFFFFFFFFu;

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

constexpr int BK = 64;                    // depths per ring stage
constexpr int STAGES = 3;                 // cp.async ring depth
constexpr int LD = BK + 8;                // stage row stride (bf16): padded by 16 bytes
constexpr int NT = CH / 8;                // m16n8 tiles across a warp's 128 rows
constexpr int CONSUMERS = 8;              // warps taking products: each 16 * MT queries x 128 rows
constexpr int PRODUCERS = 4;              // warps issuing the copies
constexpr int MMA_THREADS = (CONSUMERS + PRODUCERS) * 32;

// A CTA's block: BQ query rows over one chunk; a stage holds BK depths of the BQ query
// rows, then of the chunk's CH corpus rows. After the ring: STAGES bias slots, then a
// `full` and an `empty` mbarrier per stage.
template <int MT>
struct Tile {
  static constexpr int BQ = CONSUMERS * 16 * MT;
  static constexpr int STAGE = (BQ + CH) * LD;  // bf16 elements
  static constexpr size_t RING = sizeof(uint16_t) * (size_t)STAGE * STAGES;
  static constexpr size_t SMEM = RING + sizeof(float) * CH * STAGES + sizeof(uint64_t) * 2 * STAGES;
};

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

// Copy 16 bytes, of which the first `src_bytes` (0 or 16) come from src and the rest are 0.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(smem_addr(bar))
               : "memory");
}
// An arrival on bar once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(smem_addr(bar)) : "memory");
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

// Producer thread p's part of the fill of one stage: depths d0 .. d0 + BK of query rows
// q[0 .. nq) (rows past nq are 0) and corpus rows e[0 .. CH); with `first`, also the
// chunk's CH biases into bs. Then one arrival on `full` when its copies have landed.
template <int BQ>
__device__ __forceinline__ void fill_stage(uint16_t* st, float* bs, uint64_t* full, const uint16_t* q, int nq,
                                           const uint16_t* e, const float* bias, int D, int d0, bool first,
                                           bool vec, int p) {
  if (vec) {
    constexpr int CPR = BK / 8, RSTEP = PRODUCERS * 32 / CPR;  // 16-byte copies per row; rows per pass
    const int r0 = p / CPR, c = (p % CPR) * 8;
    const uint16_t* src = q + (size_t)r0 * D + d0 + c;
    uint16_t* dst = st + r0 * LD + c;
#pragma unroll 4
    for (int r = r0; r < BQ; r += RSTEP, src += (size_t)RSTEP * D, dst += RSTEP * LD)
      cp_async16(dst, r < nq ? src : q, r < nq ? 16 : 0);
    src = e + (size_t)r0 * D + d0 + c;
    dst = st + (BQ + r0) * LD + c;
#pragma unroll 4
    for (int r = r0; r < CH; r += RSTEP, src += (size_t)RSTEP * D, dst += RSTEP * LD) cp_async16(dst, src, 16);
    if (first && p < CH / 4) cp_async16(bs + p * 4, bias + p * 4, 16);
    mbar_arrive_on_copies(full);
  } else {
    for (int i = p; i < (BQ + CH) * BK; i += PRODUCERS * 32) {
      const int r = i / BK, c = i % BK;
      st[r * LD + c] = r < BQ ? (r < nq ? q[(size_t)r * D + d0 + c] : (uint16_t)0) : e[(size_t)(r - BQ) * D + d0 + c];
    }
    if (first)
      for (int i = p; i < CH; i += PRODUCERS * 32) bs[i] = bias[i];
    mbar_arrive(full);
  }
}

// CTA (x, y): queries y * BQ .., chunks x, x + gridDim.x, ... < NC; D % BK == 0. Warps
// 0 .. CONSUMERS - 1 take the products and the chunk maxima; the PRODUCERS warps after
// them fill the ring. Stage k is handed over by two mbarriers: `full[k]` completes a phase when the
// producer's copies of a slice have landed, `empty[k]` when every consumer thread has
// read it. Slice s lives in stage s % STAGES, in its (s / STAGES)-th phase.
template <int MT>
__global__ void __launch_bounds__(MMA_THREADS, 1)
k6_chunk_maxima_mma(const uint16_t* __restrict__ q, const uint16_t* __restrict__ emb, const float* __restrict__ bias,
                    float* __restrict__ cm, int B, int D, int NC, int vec) {
  using T = Tile<MT>;
  extern __shared__ __align__(16) unsigned char smem[];
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  float* bslots = reinterpret_cast<float*>(smem + T::RING);
  uint64_t* full = reinterpret_cast<uint64_t*>(bslots + CH * STAGES);
  uint64_t* empty = full + STAGES;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * T::BQ, nq = min(T::BQ, B - q0);
  const int G = gridDim.x, nk = D / BK;
  const int total = (NC - (int)blockIdx.x + G - 1) / G * nk;  // slices: this CTA's chunks x depth

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(&full[k], PRODUCERS * 32);
      mbar_init(&empty[k], CONSUMERS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMERS) {  // the producers
    const uint16_t* qb = q + (size_t)q0 * D;
    const int p = threadIdx.x - CONSUMERS * 32;
    for (int s = 0; s < total; ++s) {
      const int k = s % STAGES, j = s / nk, d0 = (s % nk) * BK;
      if (s >= STAGES) mbar_wait(&empty[k], (s / STAGES - 1) & 1);  // slice s - STAGES is read
      const size_t row0 = ((size_t)blockIdx.x + (size_t)j * G) * CH;
      fill_stage<T::BQ>(ring + k * T::STAGE, bslots + (j % STAGES) * CH, &full[k], qb, nq, emb + row0 * D,
                        bias + row0, D, d0, d0 == 0, vec, p);
    }
    return;
  }

  const int g = lane >> 2, t = lane & 3;
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

  for (int s = 0; s < total; ++s) {
    const int k = s % STAGES;
    mbar_wait(&full[k], (s / STAGES) & 1);
    const uint16_t* st = ring + k * T::STAGE;
    const uint16_t* A = st + (warp * 16 * MT + (lane & 15)) * LD + (lane >> 4) * 8;
    const uint16_t* Bm = st + (T::BQ + (lane & 7) + ((lane >> 4) << 3)) * LD + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) ldmatrix_x4(a[mt], A + mt * 16 * LD + kk);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {  // two 8-row n-tiles per ldmatrix
        uint32_t b[4];
        ldmatrix_x4(b, Bm + np * 16 * LD + kk);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }

    if (s % nk == nk - 1) {  // the chunk is complete: bias, maximum over its 128 rows
      const int j = s / nk;
      const size_t c = (size_t)blockIdx.x + (size_t)j * G;
      const float* bj = bslots + (j % STAGES) * CH;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        float m0 = -INFINITY, m1 = -INFINITY;  // query rows g and g + 8 of the m-tile
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          const float2 bb = *reinterpret_cast<const float2*>(bj + nt * 8 + 2 * t);
          m0 = fmaxf(m0, fmaxf(acc[mt][nt][0] + bb.x, acc[mt][nt][1] + bb.y));
          m1 = fmaxf(m1, fmaxf(acc[mt][nt][2] + bb.x, acc[mt][nt][3] + bb.y));
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
        }
#pragma unroll
        for (int off = 1; off <= 2; off <<= 1) {
          m0 = fmaxf(m0, __shfl_xor_sync(FULL, m0, off));
          m1 = fmaxf(m1, __shfl_xor_sync(FULL, m1, off));
        }
        const int r = warp * 16 * MT + mt * 16 + g;
        if (t == 0 && r < nq) cm[(size_t)(q0 + r) * NC + c] = m0;
        if (t == 0 && r + 8 < nq) cm[(size_t)(q0 + r + 8) * NC + c] = m1;
      }
    }
    mbar_arrive(&empty[k]);  // after the epilogue: the producer may refill the bias slot too
  }
}

// The tensor-core launch for B queries over NC chunks of width D: queries per CTA,
// dynamic shared memory, grid and CTAs per SM.
struct MmaPlan {
  int mt, smem, gx, gy, per_sm;
};

template <int MT>
cudaError_t plan_mma(int B, int NC, MmaPlan& p) {
  using T = Tile<MT>;
  p.mt = MT;
  p.smem = (int)T::SMEM;
  cudaError_t e = cudaFuncSetAttribute(k6_chunk_maxima_mma<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&p.per_sm, k6_chunk_maxima_mma<MT>, MMA_THREADS, p.smem);
  if (e != cudaSuccess) return e;
  p.gy = (B + T::BQ - 1) / T::BQ;
  p.gx = std::max(1, std::min(NC, sms * std::max(p.per_sm, 1) / p.gy));
  return cudaSuccess;
}

cudaError_t plan(int B, int NC, MmaPlan& p) { return B > Tile<1>::BQ ? plan_mma<2>(B, NC, p) : plan_mma<1>(B, NC, p); }

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: q [B, D], emb [N, D] contiguous and
// of one dtype (f32, or bf16 when is_bf16), bias [N] f32, N % 128 == 0; cm [B, N/128]
// f32. bf16 with D % 64 == 0 takes the tensor-core path. Returns a cudaError_t
// (0 = launched).
int wax_k6_chunk_maxima(const void* q, const void* emb, const float* bias, float* cm, int B, int N, int D,
                        int is_bf16, cudaStream_t stream) {
  const int NC = N / CH;
  if (is_bf16 && D % BK == 0) {
    MmaPlan p;
    cudaError_t e = plan(B, NC, p);
    if (e != cudaSuccess) return (int)e;
    const int vec = (uintptr_t)q % 16 == 0 && (uintptr_t)emb % 16 == 0 && (uintptr_t)bias % 16 == 0;
    const dim3 grid(p.gx, p.gy);
    const uint16_t *qh = (const uint16_t*)q, *eh = (const uint16_t*)emb;
    if (p.mt == 2)
      k6_chunk_maxima_mma<2><<<grid, MMA_THREADS, p.smem, stream>>>(qh, eh, bias, cm, B, D, NC, vec);
    else
      k6_chunk_maxima_mma<1><<<grid, MMA_THREADS, p.smem, stream>>>(qh, eh, bias, cm, B, D, NC, vec);
    return (int)cudaGetLastError();
  }
  const dim3 grid((NC + CHUNKS_PER_CTA - 1) / CHUNKS_PER_CTA, (B + QB - 1) / QB);
  if (is_bf16) {
    k6_chunk_maxima<__nv_bfloat16><<<grid, THREADS, 0, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)emb, bias, cm, B, D, NC);
  } else {
    k6_chunk_maxima<float><<<grid, THREADS, 0, stream>>>((const float*)q, (const float*)emb, bias, cm, B, D, NC);
  }
  return (int)cudaGetLastError();
}

// The tensor-core path's launch for B queries over N rows: out = {queries per CTA,
// dynamic shared memory bytes per CTA, grid x, grid y, CTAs per SM, ring stages, depth
// per stage}. Returns a cudaError_t.
int wax_k6_mma_plan(int B, int N, int* out) {
  MmaPlan p;
  cudaError_t e = plan(B, N / CH, p);
  if (e != cudaSuccess) return (int)e;
  const int vals[7] = {CONSUMERS * 16 * p.mt, p.smem, p.gx, p.gy, p.per_sm, STAGES, BK};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return 0;
}

}  // extern "C"
