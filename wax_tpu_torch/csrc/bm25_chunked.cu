// Chunked packed-postings BM25 candidate selection for Hopper (sm_90a): kernel K4.
//
// `wax_k4_chunked_sel` replaces the TPU kernel wax_tpu/ops/bm25_chunked_pallas.py
// `_kernel` (entry `_run`, via `chunked_candidates_sel`). For query b it:
//   1. reads the `slots` water-filled impact chunks win[b, s] of PK_CHUNK = 1024 packed
//      postings (row << qb) | qcon each (every chunk ascending, INT32_MAX pads last);
//   2. sorts the slots * 1024 values ascending. Equal values are identical, so the
//      sorted plane is unique whatever the network, and equals the TPU's merged plane;
//   3. at the last element i of each run of equal rows (a leader), sums qcon and counts
//      the live postings over [max(i - 2^seg_log2 + 1, run start), i], which is exactly
//      what the TPU's seg_log2 Hillis-Steele passes leave there (integer sums, so the
//      result is bit-exact);
//   4. builds the rank key  rank * 128 + (127 - i / 1024),  rank = vsum, or in count
//      mode  csum * 65536 + min(vsum, 65535);  dead elements get INT32_MIN;
//   5. for each of the 1024 slot positions p = i % 1024, keeps the `sel` largest keys of
//      positions c * 1024 + p over c = 0..slots-1 in ascending c, inserting with a
//      strict '>', and writes them (with their rows, -1 dead) at lvl * 1024 + p: the
//      TPU's output layout, on which the host's top-k tie-break depends.
//
// Design: one CTA of 1024 threads per query. With 32 slots the plane is 128 KB and
// lives in shared memory; wider planes (queries of more than 32 terms) use a global
// scratch plane per CTA with the same code. The sort merges the pre-sorted 1024-runs
// pairwise: a mirrored compare-exchange stage, then half-cleaner stages, 65 stages in
// all for 32 slots. Step 5 has thread p walk its slot column.
//
// What bounds it: the chunk reads, B * slots * 4 KB (at B 256, 32 slots: 33.6 MB,
// 0.01 ms at 3.35 TB/s), against the merge network's ~B * 65 * 16K compare-exchanges
// on the integer units; with one CTA per query and 256 queries the card runs two
// waves of one 1024-thread CTA per SM, so latency of the 65 synchronised stages sets
// the time.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 1024;
constexpr int PK = 1024;
constexpr int SEL_MAX = 4;

__device__ __forceinline__ void cmp_swap(int* x, int a, int c) {
  const int va = x[a], vc = x[c];
  if (va > vc) {
    x[a] = vc;
    x[c] = va;
  }
}

__global__ void __launch_bounds__(THREADS)
k4_chunked_sel(const int32_t* __restrict__ win, const int32_t* __restrict__ pk,
               int32_t* __restrict__ out_rows, int32_t* __restrict__ out_keys,
               int32_t* __restrict__ scratch, int slots, int qb, int seg_log2, int count_mode,
               int sel) {
  extern __shared__ __align__(16) int32_t smem[];
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = slots * PK;
  int32_t* x = scratch ? scratch + (size_t)b * n : smem;

  // 1. gather the windows, 16 bytes per thread and step
  for (int i = tid; i < n / 4; i += THREADS) {
    const int s = i / (PK / 4), j = i % (PK / 4);
    const int blk = win[(size_t)b * slots + s];
    reinterpret_cast<int4*>(x)[i] = reinterpret_cast<const int4*>(pk + (size_t)blk * PK)[j];
  }
  __syncthreads();

  // 2. merge the ascending 1024-runs pairwise into one ascending plane
  for (int run = PK; run < n; run *= 2) {
    for (int idx = tid; idx < n / 2; idx += THREADS) {  // mirrored stage
      const int blk = idx / run, j = idx % run;
      const int base = blk * 2 * run;
      cmp_swap(x, base + j, base + 2 * run - 1 - j);
    }
    __syncthreads();
    for (int d = run / 2; d >= 1; d >>= 1) {  // half-cleaners
      for (int idx = tid; idx < n / 2; idx += THREADS) {
        const int i = (idx / d) * 2 * d + (idx % d);
        cmp_swap(x, i, i + d);
      }
      __syncthreads();
    }
  }

  // 3-5. per slot column: leader sums, rank keys, top-`sel` insertion
  const unsigned qmask = (1u << qb) - 1u;
  const int window = 1 << seg_log2;
  int tops[SEL_MAX], pays[SEL_MAX];
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    tops[l] = INT_MIN;
    pays[l] = -1;
  }
  const int p = tid;
  for (int c = 0; c < slots; ++c) {
    const int i = c * PK + p;
    const unsigned v = (unsigned)x[i];
    const unsigned row = v >> qb;
    const bool leader = (i == n - 1) || (((unsigned)x[i + 1] >> qb) != row);
    const bool live = v != (unsigned)INT_MAX && (v & qmask) > 0;
    int tk = INT_MIN, tr = -1;
    if (leader && live) {
      int vsum = 0, csum = 0;
      for (int j = i; j >= 0 && j > i - window; --j) {
        const unsigned u = (unsigned)x[j];
        if ((u >> qb) != row) break;
        if (u != (unsigned)INT_MAX && (u & qmask) > 0) {
          vsum += (int)(u & qmask);
          csum += 1;
        }
      }
      if (vsum > 0) {
        const int rank = count_mode ? csum * 65536 + min(vsum, 65535) : vsum;
        tk = rank * 128 + (127 - c);
        tr = (int)row;
      }
    }
#pragma unroll
    for (int l = 0; l < SEL_MAX; ++l) {
      if (l < sel && tk > tops[l]) {
        const int t0 = tops[l], r0 = pays[l];
        tops[l] = tk;
        pays[l] = tr;
        tk = t0;
        tr = r0;
      }
    }
  }
  for (int l = 0; l < sel; ++l) {
    out_keys[(size_t)b * sel * PK + l * PK + p] = tops[l];
    out_rows[(size_t)b * sel * PK + l * PK + p] = pays[l];
  }
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: win [B, slots] i32 chunk block ids,
// pk [PB * 1024] i32, slots a power of two in [32, 128], 1 <= sel <= 4; out_rows and
// out_keys [B, sel * 1024] i32; scratch null (the plane lives in shared memory) or
// [B, slots * 1024] i32 when the plane does not fit there. Returns a cudaError_t.
int wax_k4_chunked_sel(const int32_t* win, const int32_t* pk, int32_t* out_rows, int32_t* out_keys,
                       int32_t* scratch, int B, int slots, int qb, int seg_log2, int count_mode,
                       int sel, cudaStream_t stream) {
  const size_t smem = scratch ? 0 : (size_t)slots * PK * sizeof(int32_t);
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(k4_chunked_sel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k4_chunked_sel<<<B, THREADS, smem, stream>>>(win, pk, out_rows, out_keys, scratch, slots, qb,
                                               seg_log2, count_mode, sel);
  return (int)cudaGetLastError();
}

}  // extern "C"
