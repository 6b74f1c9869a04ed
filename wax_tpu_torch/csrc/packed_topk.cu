// Per-tile top-k of packed score keys on tensor cores for Hopper (sm_90a): kernel K9.
//
// `wax_k9_packed_topk` replaces the TPU kernel wax_tpu/ops/flat_scan.py
// `_packed_topk_kernel` (entry `_packed_scan_topk`). For every query row and every
// corpus tile of TN rows it returns the tile's k largest packed keys,
//   key = (sortable(score) & ~0x7FF) | (2047 - local_col),   score = q . e + bias[row],
// as [B, N/TN * k] i32, each tile's k sorted descending: K1's function. The TPU kernel
// computes a tile's scores with one dot_general on the MXU and selects by k rounds of
// max-and-remove; keys are unique within a tile, so any exact selection returns the
// same k keys.
//
// What bounds it: at the slice shape (B 256, N 131,072, d 384, f32, k 24, TN 2,048)
// the product is 2 B N d = 25.8 GFLOP. In 3xTF32 that is 77.3 GFLOP of TF32, 0.156 ms
// at the card's 495 TFLOP/s; the bytes (the 201 MB corpus, the queries, the bias and
// the 1.6 MB of keys) take 0.061 ms at 3.35 TB/s. So the tensor cores bound it (on
// the CUDA cores' 67 TFLOP/s of FP32 the same product would take 0.385 ms).
//
// Design:
//  * The scores come from the tensor-core tile of tf32x3_tile.cuh: a CTA of 8 warps
//    owns a (64-query block x TN-row tile) pair and walks the tile in 128-row blocks,
//    `mma.sync` m16n8k8 TF32 with the 3xTF32 split, fed by a two-stage `cp.async` ring
//    of 32-deep slices that runs on across blocks. Two CTAs share an SM (f32: 96 KB of
//    shared memory each at k <= 32, 112 KB at k <= 96; one CTA above), so one's
//    products overlap the other's selection.
//  * After each block the scores plus bias are in shared memory, and each warp merges
//    its 8 queries' 128 keys into their sorted lists (flat_scan_keys.cuh `merge_rows`):
//    a ballot against the k-th key; the few winners inserted one at a time in
//    registers; when more than three win, as in a tile's first blocks, the block's keys
//    bitonic-sorted and merged with the list at once. K1's one-at-a-time insertion
//    through shared memory (`select_rows`) cost more here than the TPU kernel's
//    selection suggested: at the slice shape on an NVIDIA H100 80GB HBM3 (700 W),
//    scripts/k9_variants.py measured 0.921 ms with it against 0.806 ms, the epilogue
//    46% of a CTA's cycles against 38%, and 0.583 ms with no selection at all.
//  * Grid (query blocks, tiles), the query blocks of one tile side by side, so that the
//    tile's corpus rows are read from device memory about once and from L2 after.
//
// Precision (finite inputs): 3xTF32 keeps a score within about 1e-6 relative of its
// f32 sum (the split's error is below 2^-20 of sum_d |q_d e_d|), far inside the key's
// 2^-12 truncation. So K9's keys equal K1's and its plain twin's bit for bit on data
// whose values TF32 holds exactly (multiples of 1/8; any bf16 data widens exactly),
// and on other data differ only where a score lies within that error of a 2^-12 bucket
// edge: a rank changes only among keys the packed key already treats as near-ties.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "flat_scan_keys.cuh"
#include "tf32x3_tile.cuh"

namespace {

using tf32x3::BN;
using tf32x3::BQ;
using tf32x3::THREADS;
constexpr int SC_LD = BN + 8;  // score row stride: conflict-free float2 stores
constexpr int Q_PER_WARP = BQ / (THREADS / 32);

template <typename T>
size_t k9_smem_bytes(int KP) {
  return tf32x3::ring_bytes<T>() + sizeof(float) * BQ * SC_LD + sizeof(int) * (size_t)BQ * KP;
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
k9_packed_topk(const T* __restrict__ q, const T* __restrict__ emb, const float* __restrict__ bias,
               int32_t* __restrict__ out, int B, int D, int TN, int K, int KP, int NN, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* ring = reinterpret_cast<T*>(smem);
  float* sc = reinterpret_cast<float*>(smem + tf32x3::ring_bytes<T>());  // [BQ][SC_LD]
  int* lists = reinterpret_cast<int*>(sc + BQ * SC_LD);                  // [BQ][KP]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q0 = blockIdx.x * BQ, tile = blockIdx.y, nq = min(BQ, B - q0);
  const size_t row0 = (size_t)tile * TN;
  const int r0 = warp * Q_PER_WARP, nr = max(0, min(Q_PER_WARP, nq - r0));  // this warp's queries

  for (int i = threadIdx.x; i < BQ * KP; i += THREADS) lists[i] = PackedKey::sentinel();
  // (scan_blocks synchronises the CTA before the first epilogue)
  tf32x3::scan_blocks(q + (size_t)q0 * D, nq, emb + row0 * D, bias + row0, D, TN / BN, vec != 0, ring, sc, SC_LD,
                      [&](int j) { merge_rows<PackedKey>(sc, SC_LD, lists, KP, K, r0, nr, j * BN, lane); });
  __syncthreads();
  for (int i = threadIdx.x; i < nq * K; i += THREADS) {
    const int r = i / K, j = i % K;
    out[(size_t)(q0 + r) * NN * K + (size_t)tile * K + j] = lists[r * KP + j];
  }
}

template <typename T>
int launch_k9(const void* q, const void* emb, const float* bias, int32_t* out, int B, int N, int D, int TN, int K,
              cudaStream_t stream) {
  const int KP = (K + 31) / 32 * 32, NN = N / TN;
  const dim3 grid((B + BQ - 1) / BQ, NN);  // the query blocks of one tile run side by side
  const size_t smem = k9_smem_bytes<T>(KP);
  cudaError_t e = cudaFuncSetAttribute(k9_packed_topk<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k9_packed_topk<T><<<grid, THREADS, smem, stream>>>((const T*)q, (const T*)emb, bias, out, B, D, TN, K, KP, NN,
                                                     (int)tf32x3::can_copy16<T>(q, emb, D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: q [B, D], emb [N, D] contiguous and
// of one dtype (f32, or bf16 when is_bf16), bias [N] f32, N % TN == 0, TN % 128 == 0,
// TN <= 2048, 1 <= K <= 128. Returns a cudaError_t (0 = launched).
int wax_k9_packed_topk(const void* q, const void* emb, const float* bias, int32_t* out, int B, int N, int D, int TN,
                       int K, int is_bf16, cudaStream_t stream) {
  return is_bf16 ? launch_k9<__nv_bfloat16>(q, emb, bias, out, B, N, D, TN, K, stream)
                 : launch_k9<float>(q, emb, bias, out, B, N, D, TN, K, stream);
}

}  // extern "C"
