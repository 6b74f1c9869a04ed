// Unchunked candidate-set BM25 for Hopper (sm_90a): kernel K8.
//
// `wax_k8_candidates` replaces the TPU kernel wax_tpu/ops/bm25_candidates_pallas.py
// `_kernel` (entry `_run`, via `candidate_scores_pallas`). The TPU kernel streams, per
// query, Q2 windows of W2 postings (one per query term slot, even slots ascending, odd
// slots from the reversed copies), bitonic-merges them into one row-sorted plane of
// Q2 * W2 elements, and sums and counts each run of equal rows at its last element
// (the leader). Everything outside a term's slice is a sentinel: `-1` ahead of an even
// slot's slice and behind an odd slot's, 2^30 elsewhere.
//
// What the plane holds does not depend on the merge network. Sorted, it is
//   [n_neg sentinels -1] [the real postings, row ascending] [sentinels 2^30],
//   n_neg = sum over even slots of (offs % 1024) + sum over odd slots of
//           (W2 - offs % 1024 - len)
// (a padded slot or a -1 term id counts as offs = len = 0), so the leader of row r
// sits at  n_neg + (real postings with a row below r) + (r's run length) - 1.
// This kernel computes that plane directly instead of running the network:
//
//   * one CTA of 1024 threads per query walks the query's rows in tiles of 8,192
//     rows (a tile starts at the smallest unread row of any slot, so empty row ranges
//     cost nothing). Per tile, each slot's postings in range are found by binary
//     search, and the slots are added ONE AFTER ANOTHER into a dense f32 sum and an
//     i32 count in shared memory: rows are unique within a slot, so there are no
//     races, and each row's sum is taken in slot order (0 + c_0 + c_1 + ...). The
//     TPU adds a run by Hillis-Steele in network order; slot order is this port's
//     fixed order, shared with the plain twin (bit-equal on any data) and with K3.
//   * a block scan of the counts gives every leader's plane position.
//   * sel = 0: the plane [rows i32, scores f32] is first filled with -1 / NEG_INF,
//     then every live leader (sum > 0; `all`: count >= the query's valid terms;
//     `count` mode scores sum + 4096 * count) is written at its position.
//   * sel > 0: the TPU's in-kernel selection, output bit for bit: per plane slot
//     p = position % 1024, the `sel` largest keys over the chunks c = position / 1024,
//       key = (sortable(score or NEG_INF) & ~0x1FFF) | (0x1FFF - c),
//     inserted in chunk order with a strict '>' (K4's epilogue: thread p owns slot p
//     and keeps its column's best keys in registers). The leaders of one chunk are
//     staged in shared memory, so each thread sees its slot's element of every chunk,
//     dead elements included, in the TPU's order.
//
// What bounds it: at the exact_30k shape (B 256, Q2 16, W2 32,768) the sel = 0 output
// plane, B * Q2 * W2 * 8 bytes = 1.07 GB, is almost all of the bytes (the postings read
// are ~0.1 GB); at 3.35 TB/s the write alone takes 0.32 ms. The design therefore
// writes each plane element once with 16-byte stores (plus the few leaders twice) and
// keeps the row sums out of device memory. With sel > 0 nothing but the
// B * sel * 1024 * 8 byte shortlist is written, and the postings reads and the per-
// chunk rounds (Q2 * W2 / 1024 synchronised steps per query) set the time.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int TILE = 8192;                  // document rows per tile
constexpr int PER_THREAD = TILE / THREADS;  // consecutive rows per thread in the scan
constexpr int PK = 1024;                    // plane positions per chunk
constexpr int SEL_MAX = 4;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xFFFFFFFFu;

enum { MODE_ANY = 0, MODE_ALL = 1, MODE_COUNT = 2 };

// first index in [lo, hi) with a[index] >= x (a ascending), hi if none
__device__ __forceinline__ int lower_bound(const int32_t* a, int lo, int hi, int x) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] < x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// the TPU's selection key: sortable score bits, low 13 bits the chunk's complement
__device__ __forceinline__ int sel_key(float s, int chunk) {
  const int bits = __float_as_int(s);
  const int key = bits >= 0 ? bits : ((~bits) ^ INT_MIN);
  return (key & ~0x1FFF) | (0x1FFF - chunk);
}

// inclusive scan of x[0..TILE) in place, PER_THREAD consecutive entries per thread
__device__ void block_scan(int* x, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[PER_THREAD];
  int s = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    s += x[tid * PER_THREAD + i];
    v[i] = s;
  }
  int incl = s;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  if (lane == 31) warp_tot[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int t = warp_tot[lane];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    warp_tot[lane] = t;
  }
  __syncthreads();
  const int off = incl - s + (warp ? warp_tot[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) x[tid * PER_THREAD + i] = v[i] + off;
  __syncthreads();
}

__device__ __forceinline__ void insert_top(int* tops, int* pays, int sel, int tk, int tr) {
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

__global__ void __launch_bounds__(THREADS, 1)
k8_candidates(const int32_t* __restrict__ term_ids, const int32_t* __restrict__ offsets,
              const float* __restrict__ idf, const int32_t* __restrict__ rows,
              const float* __restrict__ wnorm, int32_t* __restrict__ out_rows,
              float* __restrict__ out_scores, int32_t* __restrict__ out_keys, int Q, int Q2, int W2,
              int mode, int sel) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);  // [TILE] row sums
  int* cnt = reinterpret_cast<int*>(acc + TILE);  // [TILE] counts, then their inclusive scan
  int* s_cur = cnt + TILE;                       // [Q2] first unread posting of each slot
  int* s_end = s_cur + Q2;                       // [Q2] end of each slot's slice
  int* s_hi = s_end + Q2;                        // [Q2] end of the slot's postings in the tile
  float* s_idf = reinterpret_cast<float*>(s_hi + Q2);  // [Q2]
  int* stage_key = reinterpret_cast<int*>(s_idf + Q2);  // [PK] the current chunk (sel > 0)
  int* stage_row = stage_key + PK;                       // [PK]
  __shared__ int warp_tot[WARPS];
  __shared__ int sh_neg, sh_nterm, sh_t0;

  const int b = blockIdx.x, tid = threadIdx.x;
  const int n_plane = Q2 * W2, nchunks = n_plane / PK;

  if (tid == 0) {
    sh_neg = 0;
    sh_nterm = 0;
  }
  __syncthreads();
  if (tid < Q2) {
    const int t = tid < Q ? term_ids[(size_t)b * Q + tid] : -1;
    int offs = 0, len = 0;
    float w = 0.f;
    if (t >= 0) {
      offs = offsets[t];
      len = offsets[t + 1] - offs;
      w = idf[t];
      atomicAdd(&sh_nterm, 1);
    }
    const int dlt = offs & (PK - 1);
    const int eff = min(len, W2 - dlt);  // what the window holds (all of it on a snapshot)
    const int start = (tid & 1) ? offs + len - eff : offs;  // odd slots: the reversed copy's head
    s_cur[tid] = start;
    s_end[tid] = start + eff;
    s_idf[tid] = w;
    atomicAdd(&sh_neg, (tid & 1) ? W2 - dlt - eff : dlt);
  }
  const size_t plane0 = (size_t)b * n_plane;
  if (sel == 0) {
    int4* r4 = reinterpret_cast<int4*>(out_rows + plane0);
    float4* s4 = reinterpret_cast<float4*>(out_scores + plane0);
    for (int i = tid; i < n_plane / 4; i += THREADS) {
      r4[i] = make_int4(-1, -1, -1, -1);
      s4[i] = make_float4(NEG_INF, NEG_INF, NEG_INF, NEG_INF);
    }
  }
  int tops[SEL_MAX], pays[SEL_MAX];
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    tops[l] = INT_MIN;
    pays[l] = -1;
  }
  const int dead0 = sel_key(NEG_INF, 0);
  if (sel) {
    stage_key[tid] = dead0;
    stage_row[tid] = -1;
  }
  __syncthreads();
  const int n_neg = sh_neg, nterm = sh_nterm;
  int done = 0;  // real postings in the tiles before this one
  int cc = 0;    // sel > 0: the chunk being staged

  for (;;) {
    if (tid == 0) sh_t0 = INT_MAX;
    __syncthreads();
    if (tid < Q2 && s_cur[tid] < s_end[tid]) atomicMin(&sh_t0, rows[s_cur[tid]]);
    __syncthreads();
    const int t0 = sh_t0;
    if (t0 == INT_MAX) break;
    if (tid < Q2) s_hi[tid] = lower_bound(rows, s_cur[tid], s_end[tid], t0 + TILE);
    for (int i = tid; i < TILE; i += THREADS) {
      acc[i] = 0.f;
      cnt[i] = 0;
    }
    __syncthreads();
    for (int s = 0; s < Q2; ++s) {  // slot order: the fixed summation order
      const int lo = s_cur[s], hi = s_hi[s];
      const float w = s_idf[s];
      for (int i = lo + tid; i < hi; i += THREADS) {
        const int r = rows[i] - t0;
        acc[r] = __fadd_rn(acc[r], __fmul_rn(w, wnorm[i]));
        cnt[r] += 1;
      }
      __syncthreads();
    }
    block_scan(cnt, warp_tot);
    const int tile_total = cnt[TILE - 1];
    const int base = n_neg + done;  // plane position of the tile's first posting

    if (sel == 0) {
      for (int r = tid; r < TILE; r += THREADS) {
        const int incl = cnt[r];
        const int c = incl - (r ? cnt[r - 1] : 0);
        const float sum = acc[r];
        if (c > 0 && sum > 0.f && (mode != MODE_ALL || c >= nterm)) {
          const size_t o = plane0 + base + incl - 1;
          out_rows[o] = t0 + r;
          out_scores[o] = mode == MODE_COUNT ? __fadd_rn(sum, 4096.f * (float)c) : sum;
        }
      }
    } else {
      const int c_last = (base + tile_total - 1) / PK;
      for (;;) {
        // stage this tile's live leaders of chunk cc: rows whose inclusive count lands
        // in [cc * PK - base + 1, (cc + 1) * PK - base + 1)
        const int r_lo = lower_bound(cnt, 0, TILE, cc * PK - base + 1);
        const int r_hi = lower_bound(cnt, r_lo, TILE, (cc + 1) * PK - base + 1);
        for (int r = r_lo + tid; r < r_hi; r += THREADS) {
          const int incl = cnt[r];
          const int c = incl - (r ? cnt[r - 1] : 0);
          const float sum = acc[r];
          if (c > 0 && sum > 0.f && (mode != MODE_ALL || c >= nterm)) {
            const int p = base + incl - 1 - cc * PK;
            const float sc = mode == MODE_COUNT ? __fadd_rn(sum, 4096.f * (float)c) : sum;
            stage_key[p] = sel_key(sc, cc);
            stage_row[p] = t0 + r;
          }
        }
        __syncthreads();
        if (cc == c_last) break;  // the next tile may still add to this chunk
        insert_top(tops, pays, sel, stage_key[tid], stage_row[tid]);
        ++cc;
        stage_key[tid] = sel_key(NEG_INF, cc);
        stage_row[tid] = -1;
        __syncthreads();
      }
    }
    if (tid < Q2) s_cur[tid] = s_hi[tid];
    done += tile_total;
  }

  if (sel) {
    // the staged chunk, then the chunks no posting reaches: all dead
    insert_top(tops, pays, sel, stage_key[tid], stage_row[tid]);
    for (int c = cc + 1; c < nchunks; ++c) insert_top(tops, pays, sel, sel_key(NEG_INF, c), -1);
    const size_t o = (size_t)b * sel * PK;
    for (int l = 0; l < sel; ++l) {
      out_keys[o + l * PK + tid] = tops[l];
      out_rows[o + l * PK + tid] = pays[l];
    }
  }
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: term_ids [B, Q] i32 (-1 pads),
// offsets [T+1] i32, idf [T] f32, rows / wnorm [P] (each term's slice row-ascending),
// Q2 the power of two >= max(Q, 2) and <= 1024, W2 a power of two >= 2048 that holds
// every queried term's slice after its offset % 1024, mode 0 any / 1 all / 2 count,
// 0 <= sel <= 4 (Q2 * W2 / 1024 <= 8192 when sel > 0). sel = 0: out_rows [B, Q2*W2] i32,
// out_scores [B, Q2*W2] f32, out_keys unused; sel > 0: out_rows and out_keys
// [B, sel*1024] i32, out_scores unused. Returns a cudaError_t (0 = launched).
int wax_k8_candidates(const int32_t* term_ids, const int32_t* offsets, const float* idf,
                      const int32_t* rows, const float* wnorm, int32_t* out_rows, float* out_scores,
                      int32_t* out_keys, int B, int Q, int Q2, int W2, int mode, int sel,
                      cudaStream_t stream) {
  const size_t smem = (size_t)TILE * 8 + (size_t)Q2 * 16 + (size_t)PK * 8;
  cudaError_t e = cudaFuncSetAttribute(k8_candidates, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k8_candidates<<<B, THREADS, smem, stream>>>(term_ids, offsets, idf, rows, wnorm, out_rows, out_scores,
                                              out_keys, Q, Q2, W2, mode, sel);
  return (int)cudaGetLastError();
}

}  // extern "C"
