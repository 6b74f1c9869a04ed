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
// What bounds it: the chunk reads, B * slots * 4 KB (at B 256, 32 slots: 33.6 MB,
// 0.01 ms at 3.35 TB/s), against a sorting network of ~B * 65 * 16K compare-exchanges.
// A synchronised network in shared memory waits on its barriers, so the design keeps
// the network in registers.
//
// Design for 32 slots (every query of up to 32 terms: all serving paths), one CTA of
// T = 32768 / V threads per query, each holding V plane values in registers (V = 32:
// 1024 threads; scripts/k4_k7_variants.py also builds V = 64). The 32 ascending chunks
// are merged by a bitonic sort in five levels (blocks of k = 2048 .. 32768, ascending
// where i & k is 0, descending elsewhere; odd chunks are read reversed, so every pair
// starts bitonic). Each stage of distance d runs in registers, in whichever of three
// layouts puts its pairs in one thread:
//  * columnar (thread p holds positions c * T + p): stages d >= 32 V, registers c and
//    c ^ d / T;
//  * warp-columnar (lane l of warp w holds positions w * 32 V + r * 32 + l): stages
//    32 <= d < 32 V, registers r and r ^ d / 32;
//  * blocked (thread t holds positions t * V .. t * V + V - 1): stages d < 32,
//    registers r and r ^ d.
// A warp's 32 V positions lie in one block of k, so below the columnar stages a warp
// sorts one way; a descending warp works on complemented values (~x reverses the
// order), so every compare-exchange there is an ascending min and max. A level changes
// layout three times through a 132 KiB shared plane: columnar to warp-columnar and
// blocked to columnar behind a block barrier (two a level, ten in all), warp-columnar
// to blocked inside the warp's own positions behind a __syncwarp. The plane's rows of
// 32 positions are padded to 33 words, so every layout's word accesses hit 32 banks
// and every address is a thread's base plus a constant. A thread rewrites only
// positions it alone read, so no barrier guards those writes. Steps 3-5 then walk the
// sorted plane column-wise, thread p taking slot position p, as the wide body below
// does. The plane's registers bound the CTA at one per SM (256 queries, two waves).
// scripts/k4_k7_variants.py also builds the stages 32 <= d < 32 V as lane shuffles on
// the blocked layout (`shfl`): a shuffle, a min and a max and a select a value and stage.
//
// Queries of 33-128 terms (64 or 128 slots) keep the first port's body, which no
// serving path runs: one 1024-thread CTA per query merges the 1024-runs pairwise in a
// global scratch plane (a mirrored stage, then half-cleaners, every stage synchronised).
//
// Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit (scripts/k4_k7_variants.py,
// hybrid_1m's 256 queries of 16 terms, 32 slots): 0.1133 ms against 0.4288 ms for the
// synchronised shared-memory network it replaces, in the same run; of that the gather
// alone takes 0.0171 ms, the merge alone 0.0552 and the column walk about 0.045 (its
// dependent shared-memory reads). The lane shuffles measured 0.1223 ms in the same
// layout; 512 threads of 64 values 0.1128. PERF.md §6 has the runs.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int PK = 1024;
constexpr int SEL_MAX = 4;
constexpr int N32 = 32 * PK;  // the plane of a 32-slot query
constexpr int VALUES = 32;    // plane values a thread holds (32: 1024 threads; 64: 512)
constexpr int WIDE_THREADS = 1024;
constexpr size_t SMEM32 = (size_t)N32 / 32 * 33 * sizeof(int32_t);  // the padded plane

__host__ __device__ constexpr int ilog2(int x) { return x <= 1 ? 0 : 1 + ilog2(x / 2); }

// Shared-memory word of plane position i: rows of 32 positions padded to 33 words, so
// that 32 consecutive positions, or the same position of 32 consecutive rows, sit in
// 32 different banks.
__device__ __forceinline__ int pad(int i) { return i + (i >> 5); }

__device__ __forceinline__ void cas_asc(int& a, int& b) {
  const int lo = min(a, b), hi = max(a, b);
  a = lo;
  b = hi;
}

// Step 1, columnar: v[c] = plane position c * T + tid, odd chunks read reversed.
template <int V>
__device__ __forceinline__ void gather(int (&v)[V], const int32_t* __restrict__ win, const int32_t* __restrict__ pk,
                                       int tid) {
  constexpr int T = N32 / V;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    const int i = c * T + tid, ch = i / PK, o = i % PK;
    const int blk = __ldg(win + ch);
    v[c] = __ldg(pk + (size_t)blk * PK + ((ch & 1) ? PK - 1 - o : o));
  }
}

// The layouts' shared-memory words, each the thread's base plus a constant per register:
// columnar  c * T + tid             -> pad(tid) + c * (T + T / 32)
// warp-col  w * 32 V + r * 32 + l   -> w * 33 V + l + r * 33
// blocked   t * V + r               -> pad(t * V) + pad(r)
template <int V>
__device__ __forceinline__ void store_columnar(const int (&v)[V], int32_t* plane, int tid) {
  constexpr int T = N32 / V;
#pragma unroll
  for (int c = 0; c < V; ++c) plane[pad(tid) + c * (T + T / 32)] = v[c];
}

template <int V>
__device__ __forceinline__ void load_columnar(int (&v)[V], const int32_t* plane, int tid) {
  constexpr int T = N32 / V;
#pragma unroll
  for (int c = 0; c < V; ++c) v[c] = plane[pad(tid) + c * (T + T / 32)];
}

// One level of the bitonic sort: blocks of K = 2048 << L, stages d = K / 2 .. 1. Enters
// and leaves with v columnar (L < 4) or leaves blocked and stored (L == 4).
template <int V, int L>
__device__ __forceinline__ void merge_level(int (&v)[V], int32_t* plane, int tid) {
  constexpr int T = N32 / V, K = 2048 << L;
  constexpr int COL = K / 2 >= 32 * V ? ilog2(K / (64 * V)) + 1 : 0;  // stages d = K / 2 .. 32 V
  static_assert(V == 32 || V == 64, "the layouts assume 32 or 64 values a thread");
#pragma unroll
  for (int s = 0; s < COL; ++s) {  // columnar: registers c and c ^ d / T
    const int m = (K / 2 >> s) / T;
#pragma unroll
    for (int c = 0; c < V; ++c)
      if (!(c & m)) {
        if ((c * T) & K) cas_asc(v[c | m], v[c]);
        else cas_asc(v[c], v[c | m]);
      }
  }
  store_columnar<V>(v, plane, tid);
  __syncthreads();
  // The rest of the level stays inside a warp's 32 V positions, which one block of K
  // holds whole, so the warp sorts one way. A descending warp works on the complements
  // (~x reverses the order), so every compare-exchange below is ascending.
  const int flip = ((tid * V) & K) ? -1 : 0;
  const int wbase = (tid >> 5) * 33 * V + (tid & 31), bbase = pad(tid * V);
#pragma unroll
  for (int r = 0; r < V; ++r) v[r] = plane[wbase + r * 33] ^ flip;
#pragma unroll
  for (int s = 0; s < ilog2(V); ++s)  // warp-columnar, d = 16 V .. 32: registers r and r ^ d / 32
#pragma unroll
    for (int r = 0; r < V; ++r)
      if (!(r & (V / 2 >> s))) cas_asc(v[r], v[r | (V / 2 >> s)]);
#pragma unroll
  for (int r = 0; r < V; ++r) plane[wbase + r * 33] = v[r];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < V; ++r) v[r] = plane[bbase + r + (r >> 5)];
#pragma unroll
  for (int s = 0; s < 5; ++s)  // blocked, d = 16 .. 1: registers r and r ^ d
#pragma unroll
    for (int r = 0; r < V; ++r)
      if (!(r & (16 >> s))) cas_asc(v[r], v[r | (16 >> s)]);
#pragma unroll
  for (int r = 0; r < V; ++r) plane[bbase + r + (r >> 5)] = v[r] ^ flip;
  __syncthreads();
  if (L < 4) load_columnar<V>(v, plane, tid);
}

// Step 2: the sorted plane, left in shared memory (padded).
template <int V>
__device__ __forceinline__ void merge(int (&v)[V], int32_t* plane, int tid) {
  merge_level<V, 0>(v, plane, tid);
  merge_level<V, 1>(v, plane, tid);
  merge_level<V, 2>(v, plane, tid);
  merge_level<V, 3>(v, plane, tid);
  merge_level<V, 4>(v, plane, tid);
}

// Steps 3-5 for slot position p of a sorted plane of `slots` chunks read through x(i).
template <typename X>
__device__ __forceinline__ void walk_column(X x, int slots, int p, int qb, int seg_log2, int count_mode, int sel,
                                            int32_t* __restrict__ out_rows, int32_t* __restrict__ out_keys) {
  const int n = slots * PK;
  const unsigned qmask = (1u << qb) - 1u;
  const int window = 1 << seg_log2;
  int tops[SEL_MAX], pays[SEL_MAX];
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    tops[l] = INT_MIN;
    pays[l] = -1;
  }
  for (int c = 0; c < slots; ++c) {
    const int i = c * PK + p;
    const unsigned v = (unsigned)x(i);
    const unsigned row = v >> qb;
    const bool leader = (i == n - 1) || (((unsigned)x(i + 1) >> qb) != row);
    const bool live = v != (unsigned)INT_MAX && (v & qmask) > 0;
    int tk = INT_MIN, tr = -1;
    if (leader && live) {
      int vsum = 0, csum = 0;
      for (int j = i; j >= 0 && j > i - window; --j) {
        const unsigned u = (unsigned)x(j);
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
    out_keys[l * PK + p] = tops[l];
    out_rows[l * PK + p] = pays[l];
  }
}

template <int V>
__device__ __forceinline__ void walk(const int32_t* plane, int tid, int qb, int seg_log2, int count_mode, int sel,
                                     int32_t* out_rows, int32_t* out_keys) {
  for (int p = tid; p < PK; p += N32 / V)
    walk_column([plane](int i) { return plane[pad(i)]; }, 32, p, qb, seg_log2, count_mode, sel, out_rows,
                out_keys);
}

template <int V>
__global__ void __launch_bounds__(N32 / V, 1)
k4_chunked_sel32(const int32_t* __restrict__ win, const int32_t* __restrict__ pk, int32_t* __restrict__ out_rows,
                 int32_t* __restrict__ out_keys, int qb, int seg_log2, int count_mode, int sel) {
  extern __shared__ __align__(16) int32_t plane[];  // SMEM32: N32 positions, padded
  const int b = blockIdx.x, tid = threadIdx.x;
  const size_t o = (size_t)b * sel * PK;
  int v[V];
  gather<V>(v, win + (size_t)b * 32, pk, tid);
  merge<V>(v, plane, tid);
  walk<V>(plane, tid, qb, seg_log2, count_mode, sel, out_rows + o, out_keys + o);
}

__device__ __forceinline__ void cmp_swap(int32_t* x, int a, int c) {
  const int va = x[a], vc = x[c];
  if (va > vc) {
    x[a] = vc;
    x[c] = va;
  }
}

// 64 or 128 slots: the plane in a global scratch plane, merged by synchronised stages.
__global__ void __launch_bounds__(WIDE_THREADS)
k4_chunked_sel_wide(const int32_t* __restrict__ win, const int32_t* __restrict__ pk, int32_t* __restrict__ out_rows,
                    int32_t* __restrict__ out_keys, int32_t* __restrict__ scratch, int slots, int qb, int seg_log2,
                    int count_mode, int sel) {
  const int b = blockIdx.x, tid = threadIdx.x;
  const int n = slots * PK;
  int32_t* x = scratch + (size_t)b * n;

  // 1. gather the windows, 16 bytes per thread and step
  for (int i = tid; i < n / 4; i += WIDE_THREADS) {
    const int s = i / (PK / 4), j = i % (PK / 4);
    const int blk = win[(size_t)b * slots + s];
    reinterpret_cast<int4*>(x)[i] = reinterpret_cast<const int4*>(pk + (size_t)blk * PK)[j];
  }
  __syncthreads();

  // 2. merge the ascending 1024-runs pairwise into one ascending plane
  for (int run = PK; run < n; run *= 2) {
    for (int idx = tid; idx < n / 2; idx += WIDE_THREADS) {  // mirrored stage
      const int blk = idx / run, j = idx % run;
      const int base = blk * 2 * run;
      cmp_swap(x, base + j, base + 2 * run - 1 - j);
    }
    __syncthreads();
    for (int d = run / 2; d >= 1; d >>= 1) {  // half-cleaners
      for (int idx = tid; idx < n / 2; idx += WIDE_THREADS) {
        const int i = (idx / d) * 2 * d + (idx % d);
        cmp_swap(x, i, i + d);
      }
      __syncthreads();
    }
  }

  // 3-5. per slot column
  const size_t o = (size_t)b * sel * PK;
  walk_column([x](int i) { return x[i]; }, slots, tid, qb, seg_log2, count_mode, sel, out_rows + o, out_keys + o);
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: win [B, slots] i32 chunk block ids,
// pk [PB * 1024] i32, slots 32, 64 or 128, 1 <= sel <= 4; out_rows and out_keys
// [B, sel * 1024] i32; scratch [B, slots * 1024] i32 for 64 and 128 slots (null, and
// unused, for 32). Returns a cudaError_t.
int wax_k4_chunked_sel(const int32_t* win, const int32_t* pk, int32_t* out_rows, int32_t* out_keys,
                       int32_t* scratch, int B, int slots, int qb, int seg_log2, int count_mode,
                       int sel, cudaStream_t stream) {
  if (slots == 32) {
    cudaError_t e = cudaFuncSetAttribute(k4_chunked_sel32<VALUES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)SMEM32);
    if (e != cudaSuccess) return (int)e;
    k4_chunked_sel32<VALUES><<<B, N32 / VALUES, SMEM32, stream>>>(win, pk, out_rows, out_keys, qb, seg_log2,
                                                                  count_mode, sel);
  } else {
    if (!scratch) return (int)cudaErrorInvalidValue;
    k4_chunked_sel_wide<<<B, WIDE_THREADS, 0, stream>>>(win, pk, out_rows, out_keys, scratch, slots, qb, seg_log2,
                                                       count_mode, sel);
  }
  return (int)cudaGetLastError();
}

// How the 32-slot body launches on the current device: out = {threads per CTA, dynamic
// shared memory per CTA, CTAs per SM}. Returns a cudaError_t.
int wax_k4_plan(int* out) {
  cudaError_t e = cudaFuncSetAttribute(k4_chunked_sel32<VALUES>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)SMEM32);
  int per_sm = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k4_chunked_sel32<VALUES>, N32 / VALUES, SMEM32);
  out[0] = N32 / VALUES;
  out[1] = (int)SMEM32;
  out[2] = per_sm;
  return (int)e;
}

}  // extern "C"
