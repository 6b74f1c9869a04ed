// Fused dense scan + per-tile top-k for Hopper (sm_90a): kernels K1 and K2.
//
// K1 `wax_k1_packed_sel` replaces the TPU kernel wax_tpu/ops/flat_scan.py
//    `_packed_sel_kernel` (entry `_packed_sel_scan_topk`): for every query row and
//    every corpus tile of TN rows it returns the tile's k largest PACKED keys,
//      key = (sortable(score) & ~0x7FF) | (2047 - local_col),
//      score = sum_d q[d] * e[d] (f32 FMA) + bias[row],
//    i.e. scores truncated to 2^-12 relative with a lowest-column tie-break. The
//    selection is exact over the tile (what the TPU's `_packed_topk_kernel` K9
//    computes); the TPU kernel's lane-slot lookahead loss is not reproduced.
// K2 `wax_k2_scan_topk` replaces wax_tpu/ops/flat_scan.py `_scan_topk_kernel`
//    (entry `_pallas_scan_topk`): per tile, the k best by (f32 score desc, column
//    asc), returned as f32 values and global row ids.
//
// Both kernels share one body. A CTA of 256 threads owns a (64-query block x TN-row
// corpus tile) pair and nothing is carried between CTAs; the wrapper merges the
// per-tile lists with a stable top-k afterwards. Inside a CTA the tile is walked in
// 128-row chunks: a 64x128 score block is accumulated with FMA on the CUDA cores
// (each thread a 4x8 register micro-tile, operands staged through shared memory 16
// depth steps at a time), written with the bias to shared memory, and then each warp
// filters its 8 queries' scores against the current k-th key and inserts the few that
// beat it into a sorted per-query list in shared memory (k <= 128). Keys are unique
// within a tile (the column is part of the key), so the lists are exact and
// deterministic whatever order candidates arrive in.
//
// What bounds it: at the slice shape (B = 256, N = 131,072 capacity, d = 384, f32) a
// scan is 2*B*N*d = 25.8 GFLOP and reads 201 MB of corpus (once per 64-query block,
// four times in all). Against the card's ~67 TFLOP/s of non-tensor FP32 and 3.35 TB/s
// that is compute-bound, not bandwidth-bound, so the design spends its effort on FMA
// density (32 accumulators per thread, broadcast shared-memory operands). TF32 and
// tensor cores are not used: TF32 would change rankings, and bf16 wgmma is later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int QB = 64;          // queries per CTA
constexpr int CH = 128;         // corpus rows per chunk
constexpr int DK = 16;          // depth per shared-memory stage
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int Q_PER_WARP = QB / WARPS;
constexpr int SC_LD = CH + 1;   // padded score row (bank spread)
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// K1: the TPU backend's packed i32 key.
struct PackedKey {
  using T = int;
  static __device__ __forceinline__ T sentinel() { return INT_MIN; }
  static __device__ __forceinline__ T make(float s, int col) {
    int bits = __float_as_int(s);
    int key = bits >= 0 ? bits : ((~bits) ^ INT_MIN);
    return (key & ~0x7FF) | (0x7FF - col);
  }
};

// K2: exact (score desc, column asc) order as one u64 key.
struct ExactKey {
  using T = unsigned long long;
  static __device__ __forceinline__ T sentinel() { return 0ull; }
  static __device__ __forceinline__ T make(float s, int col) {
    unsigned u = __float_as_uint(s);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return ((T)u << 32) | (T)(0xFFFFFFFFu - (unsigned)col);
  }
  static __device__ __forceinline__ float value(T key) {
    unsigned u = (unsigned)(key >> 32);
    unsigned bits = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    return __uint_as_float(bits);
  }
  static __device__ __forceinline__ int column(T key) {
    return (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
  }
};

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

size_t smem_bytes(int KP, size_t key_bytes) {
  return (size_t)QB * KP * key_bytes + sizeof(float) * ((size_t)DK * QB + (size_t)DK * CH + (size_t)QB * SC_LD);
}

// Scan one (query block, corpus tile) pair; on return `lists` holds each query's k
// best keys of the tile, sorted descending.
template <typename T, typename Key>
__device__ void scan_tile(const T* __restrict__ q, const T* __restrict__ emb,
                          const float* __restrict__ bias, int B, int D, int TN, int K, int KP,
                          unsigned char* smem) {
  using KT = typename Key::T;
  KT* lists = reinterpret_cast<KT*>(smem);
  float* qs = reinterpret_cast<float*>(smem + (size_t)QB * KP * sizeof(KT));  // [DK][QB]
  float* es = qs + DK * QB;                                                   // [DK][CH]
  float* sc = es + DK * CH;                                                   // [QB][SC_LD]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tx = tid & 15, ty = tid >> 4;  // micro-tile: queries ty*4+i, columns tx+16*j
  const int q0 = blockIdx.y * QB;
  const size_t row0 = (size_t)blockIdx.x * TN;

  for (int i = tid; i < QB * KP; i += THREADS) lists[i] = Key::sentinel();
  __syncthreads();

  for (int c0 = 0; c0 < TN; c0 += CH) {
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
        const size_t grow = row0 + c0 + r;
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

#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 16 * j;
      const float b = bias[row0 + c0 + col];
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[(ty * 4 + i) * SC_LD + col] = acc[i][j] + b;
    }
    __syncthreads();

    for (int qi = 0; qi < Q_PER_WARP; ++qi) {
      const int r = warp * Q_PER_WARP + qi;
      if (q0 + r >= B) break;  // warp-uniform
      KT* L = lists + (size_t)r * KP;
      for (int cc = 0; cc < CH; cc += 32) {
        const int col = cc + lane;
        const KT key = Key::make(sc[r * SC_LD + col], c0 + col);
        unsigned m = __ballot_sync(FULL, key > L[K - 1]);
        while (m) {
          const int src = __ffs(m) - 1;
          m &= m - 1;
          const KT x = __shfl_sync(FULL, key, src);
          if (x > L[K - 1]) list_insert(L, K, x, lane);
        }
      }
    }
    __syncthreads();
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k1_packed_sel(const T* __restrict__ q, const T* __restrict__ emb, const float* __restrict__ bias,
              int32_t* __restrict__ out, int B, int D, int TN, int K, int KP, int NN) {
  extern __shared__ __align__(16) unsigned char smem[];
  scan_tile<T, PackedKey>(q, emb, bias, B, D, TN, K, KP, smem);
  const int* lists = reinterpret_cast<const int*>(smem);
  const int q0 = blockIdx.y * QB, tile = blockIdx.x;
  for (int i = threadIdx.x; i < QB * K; i += THREADS) {
    const int r = i / K, j = i % K;
    if (q0 + r < B) out[(size_t)(q0 + r) * NN * K + (size_t)tile * K + j] = lists[r * KP + j];
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
k2_scan_topk(const T* __restrict__ q, const T* __restrict__ emb, const float* __restrict__ bias,
             float* __restrict__ vals, int32_t* __restrict__ idx, int B, int D, int TN, int K,
             int KP, int NN) {
  extern __shared__ __align__(16) unsigned char smem[];
  scan_tile<T, ExactKey>(q, emb, bias, B, D, TN, K, KP, smem);
  const unsigned long long* lists = reinterpret_cast<const unsigned long long*>(smem);
  const int q0 = blockIdx.y * QB, tile = blockIdx.x;
  for (int i = threadIdx.x; i < QB * K; i += THREADS) {
    const int r = i / K, j = i % K;
    if (q0 + r < B) {
      const unsigned long long key = lists[r * KP + j];
      const size_t o = (size_t)(q0 + r) * NN * K + (size_t)tile * K + j;
      vals[o] = ExactKey::value(key);
      idx[o] = tile * TN + ExactKey::column(key);
    }
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

// Arguments are validated by the Python wrapper: q [B, D], emb [N, D] contiguous and
// of one dtype (f32, or bf16 when is_bf16), bias [N] f32, N % TN == 0,
// TN % 128 == 0, TN <= 2048, 1 <= K <= 128. Returns a cudaError_t (0 = launched).
int wax_k1_packed_sel(const void* q, const void* emb, const float* bias, int32_t* out, int B,
                      int N, int D, int TN, int K, int is_bf16, cudaStream_t stream) {
  const int KP = (K + 31) / 32 * 32, NN = N / TN;
  const dim3 grid(NN, (B + QB - 1) / QB);
  const size_t smem = smem_bytes(KP, sizeof(int));
  int err;
  if (is_bf16) {
    if ((err = launch_prep(k1_packed_sel<__nv_bfloat16>, smem))) return err;
    k1_packed_sel<__nv_bfloat16><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)emb, bias, out, B, D, TN, K, KP, NN);
  } else {
    if ((err = launch_prep(k1_packed_sel<float>, smem))) return err;
    k1_packed_sel<float><<<grid, THREADS, smem, stream>>>(
        (const float*)q, (const float*)emb, bias, out, B, D, TN, K, KP, NN);
  }
  return (int)cudaGetLastError();
}

int wax_k2_scan_topk(const void* q, const void* emb, const float* bias, float* vals, int32_t* idx,
                     int B, int N, int D, int TN, int K, int is_bf16, cudaStream_t stream) {
  const int KP = (K + 31) / 32 * 32, NN = N / TN;
  const dim3 grid(NN, (B + QB - 1) / QB);
  const size_t smem = smem_bytes(KP, sizeof(unsigned long long));
  int err;
  if (is_bf16) {
    if ((err = launch_prep(k2_scan_topk<__nv_bfloat16>, smem))) return err;
    k2_scan_topk<__nv_bfloat16><<<grid, THREADS, smem, stream>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)emb, bias, vals, idx, B, D, TN, K, KP, NN);
  } else {
    if ((err = launch_prep(k2_scan_topk<float>, smem))) return err;
    k2_scan_topk<float><<<grid, THREADS, smem, stream>>>(
        (const float*)q, (const float*)emb, bias, vals, idx, B, D, TN, K, KP, NN);
  }
  return (int)cudaGetLastError();
}

const char* wax_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
