// Fused dense scan + per-tile top-k for Hopper (sm_90a): kernels K1 and K2.
//
// K1 `wax_k1_packed_sel` replaces the TPU kernel wax_tpu/ops/flat_scan.py
//    `_packed_sel_kernel` (entry `_packed_sel_scan_topk`): for every query row and
//    every corpus tile of TN rows it returns the tile's k largest PACKED keys,
//      key = (sortable(score) & ~0x7FF) | (2047 - local_col),   score = q . e + bias[row],
//    i.e. scores truncated to 2^-12 relative with a lowest-column tie-break. The
//    selection is exact over the tile (what the TPU's `_packed_topk_kernel` K9
//    computes); the TPU kernel's lane-slot lookahead loss is not reproduced.
// K2 `wax_k2_scan_topk` replaces wax_tpu/ops/flat_scan.py `_scan_topk_kernel`
//    (entry `_pallas_scan_topk`): per tile, the k best by (score desc, column asc),
//    returned as f32 values and global row ids.
// Both write [B, N/TN * k], each tile's k sorted descending; the wrapper merges the
// tiles with a stable top-k. K9 (packed_topk.cu) computes K1's function on the same
// tensor-core tile with every warp both copying and multiplying.
//
// What bounds them: at the slice shape (B 256, N 131,072, d 384, f32, k 24, TN 2,048)
// the product is 2 B N d = 25.8 GFLOP; in 3xTF32 that is 77.3 GFLOP of TF32, 0.156 ms at
// the card's 495 TFLOP/s, against 0.061 ms for the bytes (the 201 MB corpus, queries,
// bias, lists) at 3.35 TB/s: the tensor cores bound it (0.385 ms on FP32 FMA).
//
// Design (one body, templated on the key: PackedKey i32 for K1, ExactKey u64 for K2):
//  * Scores on the tensor cores, as K9: `mma.sync` m16n8k8 TF32 with the 3xTF32 split
//    (tf32x3_tile.cuh's `mma_stage`, `store_scores`), exact on data TF32 holds (the 1/8
//    grid, any bf16) and within about 1e-6 of the f32 sum elsewhere; + bias after.
//  * Warp roles in a CTA that owns a 64-query block x a run of 128-row blocks:
//    PRODUCERS warps fill a ring of STAGES stages (each a 32-deep slice of the 64 query
//    rows and 128 corpus rows, tf32x3's padded layout) with 16-byte `cp.async` copies
//    (ordinary loads where rows are not 16-byte aligned), each stage handed over by a
//    `full` and an `empty` mbarrier, so a copy never waits on a product; 8 CONSUMERS
//    warps take the products (each 32 queries x 32 rows), store a block's scores + bias
//    to shared memory and, between two named barriers of their own, merge them into
//    per-query sorted lists (flat_scan_keys.cuh `merge_rows`: lists in registers, the
//    few keys that beat the k-th inserted one at a time, a block's winners sorted and
//    merged when more beat it). Two CTAs share an SM, so one's selection overlaps the
//    other's products. scripts/k1_variants.py also builds the other arrangement,
//    selector warps over two score buffers beside the consumers at one CTA per SM,
//    which measured slower (PERF.md).
//  * Cluster split: a (query block, tile) pair is split along the tile's rows over a
//    thread-block cluster of S CTAs (S in {1, 2, 4, 8}, TN / S a multiple of 128), so
//    small capacities still fill the card (at B 256: 20 pairs at 10,240 rows, 64 at
//    32,768, on 132 SMs). Each CTA selects over its TN / S rows with keys built on the
//    tile-local column, so keys stay unique within the tile; after `cluster.sync()`
//    CTA r merges the S lists of queries r * 64 / S .. through distributed shared
//    memory and writes the tile's list. The wrapper picks S (flat_scan.scan_plan).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (chip_smoke.py, B 256,
// d 384, f32): K1 0.7290 ms and K2 0.7562 ms at 131,072 rows, k 24 (torch.matmul f32
// 0.5732 ms; bound 0.1562), 0.1131 / 0.1222 ms at 10,240 rows, k 10 (S 8); the FP32-FMA
// body this replaces took 1.5398 / 1.6489 and 0.9064 / 1.0669 ms. What still bounds it
// (scripts/k1_variants.py, same card): the products alone take 0.43 ms (`mma.sync` with
// the split's integer work and scalar fragment loads, 2.8x the bound), copies and
// products together 0.56 ms (the query block is copied again for every block), and the
// selection adds the rest; `wgmma` fed by TMA is the next step.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cooperative_groups.h>
#include <stdint.h>
#include <limits.h>

#include "flat_scan_keys.cuh"
#include "tf32x3_tile.cuh"

namespace cg = cooperative_groups;

namespace {

using tf32x3::BK;
using tf32x3::BN;
using tf32x3::BQ;
using tf32x3::Stage;

constexpr int CONSUMERS = 8;  // warps taking the products (tf32x3's 2 x 4 warp grid), then selecting
constexpr int PRODUCERS = 4;  // warps filling the ring
constexpr int STAGES = 2;     // ring depth
constexpr int MIN_CTAS = 2;   // CTAs per SM asked of __launch_bounds__
constexpr int WARPS = CONSUMERS + PRODUCERS;
constexpr int THREADS = WARPS * 32;
constexpr int SC_LD = BN + 8;               // score row stride: conflict-free float2 stores
constexpr int Q_PER_WARP = BQ / CONSUMERS;  // queries each consumer warp selects

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

// Where a tile's finished list goes: K1 writes the keys, K2 decodes value and row.
struct PackedOut {
  int32_t* keys;
  __device__ __forceinline__ void put(size_t o, int key, int) const { keys[o] = key; }
};
struct ExactOut {
  float* vals;
  int32_t* rows;
  __device__ __forceinline__ void put(size_t o, unsigned long long key, int row0) const {
    vals[o] = ExactKey::value(key);
    rows[o] = row0 + ExactKey::column(key);
  }
};

// ------------------------------------------------------------------------ mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared.b64 [%0], %1;\n" ::"r"(tf32x3::smem_addr(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n .reg .b64 state;\n mbarrier.arrive.shared.b64 state, [%0];\n}\n" ::"r"(tf32x3::smem_addr(bar))
               : "memory");
}
// An arrival on bar once every cp.async this thread has issued so far has landed.
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared.b64 [%0];\n" ::"r"(tf32x3::smem_addr(bar)) : "memory");
}
// Wait until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra.uni WAIT;\n"
      "}\n" ::"r"(tf32x3::smem_addr(bar)),
      "r"(parity)
      : "memory");
}
// A barrier of the consumer warps alone.
__device__ __forceinline__ void consumers_sync() { asm volatile("bar.sync 1, %0;\n" ::"n"(CONSUMERS * 32) : "memory"); }

// ------------------------------------------------------------------------ the body

// Shared memory: the ring, a score block [BQ][SC_LD], the lists [BQ][KP], then the
// mbarriers full[STAGES] and empty[STAGES].
template <typename T>
size_t smem_bytes(int KP, size_t key_bytes) {
  return sizeof(T) * (size_t)Stage<T>::ELEMS * STAGES + sizeof(float) * BQ * SC_LD + key_bytes * BQ * KP +
         sizeof(uint64_t) * 2 * STAGES;
}

// Producer thread p's part of one stage: depths d0 .. d0 + BK of query rows q[0 .. nq)
// (rows past nq are 0) and corpus rows e[0 .. BN); depths past D are 0. Then one
// arrival on `full` when its copies have landed.
template <typename T>
__device__ __forceinline__ void fill_stage(T* st, uint64_t* full, const T* q, int nq, const T* e, int D, int d0,
                                           bool vec, int p) {
  using S = Stage<T>;
  if (vec) {
    constexpr int CPR = BK / S::EPC;  // 16-byte copies per row
    for (int i = p; i < S::ROWS * CPR; i += PRODUCERS * 32) {
      const int r = i / CPR, c = (i % CPR) * S::EPC, gd = d0 + c;
      const bool ok = gd < D && (r >= BQ || r < nq);
      const T* src = !ok ? q : r < BQ ? q + (size_t)r * D + gd : e + (size_t)(r - BQ) * D + gd;
      tf32x3::cp_async16(st + r * S::LD + c, src, ok ? 16 : 0);
    }
    mbar_arrive_on_copies(full);
  } else {
    for (int i = p; i < S::ROWS * BK; i += PRODUCERS * 32) {
      const int r = i / BK, c = i % BK, gd = d0 + c;
      const bool ok = gd < D && (r >= BQ || r < nq);
      st[r * S::LD + c] = !ok ? tf32x3::zero_of<T>() : r < BQ ? q[(size_t)r * D + gd] : e[(size_t)(r - BQ) * D + gd];
    }
    mbar_arrive(full);
  }
}

// CTA (x, y, z) of a cluster of S = gridDim.x: queries y * BQ .., rows x * TN / S .. of
// tile z. Writes the tile's k best keys per query, sorted descending, through `out`.
template <typename T, typename Key, typename Out>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
scan_topk(const T* __restrict__ q, const T* __restrict__ emb, const float* __restrict__ bias, Out out, int B, int D,
          int TN, int K, int KP, int NN, int vec) {
  using S = Stage<T>;
  using KT = typename Key::T;
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* sc = reinterpret_cast<float*>(ring + S::ELEMS * STAGES);  // [BQ][SC_LD]
  KT* lists = reinterpret_cast<KT*>(sc + BQ * SC_LD);              // [BQ][KP]
  uint64_t* full = reinterpret_cast<uint64_t*>(lists + BQ * KP);
  uint64_t* empty = full + STAGES;

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.y * BQ, nq = min(BQ, B - q0), tile = blockIdx.z;
  const int sub = TN / split, c0 = rank * sub;  // this CTA's rows of the tile
  const size_t row0 = (size_t)tile * TN + c0;
  const int nk = (D + BK - 1) / BK, nblocks = sub / BN, total = nblocks * nk;

  if (threadIdx.x == 0) {
    for (int k = 0; k < STAGES; ++k) {
      mbar_init(&full[k], PRODUCERS * 32);
      mbar_init(&empty[k], CONSUMERS * 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < BQ * KP; i += THREADS) lists[i] = Key::sentinel();
  __syncthreads();

  if (warp >= CONSUMERS) {  // producers
    const int p = threadIdx.x - CONSUMERS * 32;
    const T* qb = q + (size_t)q0 * D;
    const T* eb = emb + row0 * D;
    for (int s = 0; s < total; ++s) {
      const int k = s % STAGES;
      if (s >= STAGES) mbar_wait(&empty[k], (s / STAGES - 1) & 1);  // slice s - STAGES is consumed
      fill_stage<T>(ring + k * S::ELEMS, &full[k], qb, nq, eb + (size_t)(s / nk) * BN * D, D, (s % nk) * BK, vec != 0, p);
    }
  } else {  // consumers
    const int wm = warp & 1, wn = warp >> 1;
    const int r0 = warp * Q_PER_WARP, nr = max(0, min(Q_PER_WARP, nq - r0));  // the queries this warp selects
    float acc[tf32x3::MT][tf32x3::NT][4];
    tf32x3::zero(acc);
    for (int s = 0; s < total; ++s) {
      const int k = s % STAGES;
      mbar_wait(&full[k], (s / STAGES) & 1);
      tf32x3::mma_stage(ring + k * S::ELEMS, acc, wm, wn, lane);
      mbar_arrive(&empty[k]);
      if (s % nk != nk - 1) continue;
      const int j = s / nk;  // block j is complete
      tf32x3::store_scores(acc, bias + row0 + (size_t)j * BN, sc, SC_LD, wm, wn, lane);
      consumers_sync();  // the block's scores are in sc
      merge_rows<Key, true>(sc, SC_LD, lists, KP, K, r0, nr, c0 + j * BN, lane);
      consumers_sync();  // sc may be written again
      tf32x3::zero(acc);
    }
  }

  // The cluster's S lists of each query -> the tile's list: CTA `rank` finishes
  // queries rank * BQ / S .., one warp per query, reading the other CTAs' lists through
  // distributed shared memory. Positions past K are taken as the sentinel.
  cluster.sync();
  const int per = BQ / split, KR = KP / 32;
  for (int r = rank * per + warp; r < min((rank + 1) * per, nq); r += WARPS) {
    KT lv[4];
    for (int c = 0; c < split; ++c) {
      const KT* L = cluster.map_shared_rank(lists, c) + (size_t)r * KP;
      KT s[4];
#pragma unroll
      for (int t = 0; t < 4; ++t) s[t] = t < KR && t * 32 + lane < K ? L[t * 32 + lane] : Key::sentinel();
      if (c == 0) {
#pragma unroll
        for (int t = 0; t < 4; ++t) lv[t] = s[t];
      } else {
        merge128_desc(lv, s, lane);
      }
    }
    const size_t o = (size_t)(q0 + r) * NN * K + (size_t)tile * K;
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t * 32 + lane < K) out.put(o + t * 32 + lane, lv[t], tile * TN);
  }
  cluster.sync();  // no CTA leaves while another reads its lists
}

template <typename T, typename Key, typename Out>
cudaError_t launch(const void* q, const void* emb, const float* bias, Out out, int B, int N, int D, int TN, int K,
                   int split, cudaStream_t stream) {
  const int KP = (K + 31) / 32 * 32, NN = N / TN;
  const size_t smem = smem_bytes<T>(KP, sizeof(typename Key::T));
  auto kern = scan_topk<T, Key, Out>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (B + BQ - 1) / BQ, NN);  // the query blocks of one tile side by side
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int vec = (int)tf32x3::can_copy16<T>(q, emb, D);
  e = cudaLaunchKernelEx(&cfg, kern, (const T*)q, (const T*)emb, bias, out, B, D, TN, K, KP, NN, vec);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// The launch's dynamic shared memory, CTAs per SM and co-resident clusters of `split`.
template <typename T, typename Key, typename Out>
cudaError_t plan(int B, int N, int TN, int K, int split, int* out) {
  const int KP = (K + 31) / 32 * 32;
  const size_t smem = smem_bytes<T>(KP, sizeof(typename Key::T));
  auto kern = scan_topk<T, Key, Out>;
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int per_sm = 0, clusters = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, smem);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (B + BQ - 1) / BQ, N / TN);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg);
  if (e != cudaSuccess) return e;
  const int vals[7] = {(int)smem, per_sm, clusters, THREADS, STAGES, CONSUMERS, PRODUCERS};
  for (int i = 0; i < 7; ++i) out[i] = vals[i];
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: q [B, D], emb [N, D] contiguous and
// of one dtype (f32, or bf16 when is_bf16), bias [N] f32, N % TN == 0, TN % 128 == 0,
// TN <= 2048, 1 <= K <= 128, split in {1, 2, 4, 8} with (TN / split) % 128 == 0.
// Returns a cudaError_t (0 = launched; a refused cluster launch is an error).
int wax_k1_packed_sel(const void* q, const void* emb, const float* bias, int32_t* out, int B, int N, int D, int TN,
                      int K, int is_bf16, int split, cudaStream_t stream) {
  const PackedOut o{out};
  return (int)(is_bf16 ? launch<__nv_bfloat16, PackedKey>(q, emb, bias, o, B, N, D, TN, K, split, stream)
                       : launch<float, PackedKey>(q, emb, bias, o, B, N, D, TN, K, split, stream));
}

int wax_k2_scan_topk(const void* q, const void* emb, const float* bias, float* vals, int32_t* idx, int B, int N,
                     int D, int TN, int K, int is_bf16, int split, cudaStream_t stream) {
  const ExactOut o{vals, idx};
  return (int)(is_bf16 ? launch<__nv_bfloat16, ExactKey>(q, emb, bias, o, B, N, D, TN, K, split, stream)
                       : launch<float, ExactKey>(q, emb, bias, o, B, N, D, TN, K, split, stream));
}

// K1's (exact 0) or K2's (exact 1) launch for these shapes, launching nothing: out =
// {dynamic shared memory bytes per CTA, CTAs per SM, co-resident clusters of `split`,
// threads per CTA, ring stages, consumer and producer warps}. Returns a cudaError_t.
int wax_flat_scan_plan(int exact, int is_bf16, int B, int N, int TN, int K, int split, int* out) {
  if (exact)
    return (int)(is_bf16 ? plan<__nv_bfloat16, ExactKey, ExactOut>(B, N, TN, K, split, out)
                         : plan<float, ExactKey, ExactOut>(B, N, TN, K, split, out));
  return (int)(is_bf16 ? plan<__nv_bfloat16, PackedKey, PackedOut>(B, N, TN, K, split, out)
                       : plan<float, PackedKey, PackedOut>(B, N, TN, K, split, out));
}

const char* wax_cuda_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
