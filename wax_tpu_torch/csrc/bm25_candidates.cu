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
//   [n_neg sentinels -1] [the P real postings, row ascending] [sentinels 2^30],
//   n_neg = sum over even slots of (offs % 1024) + sum over odd slots of
//           (W2 - offs % 1024 - len)
// (a padded slot or a -1 term id counts as offs = len = 0), so the leader of row r
// sits at  n_neg + (real postings with a row below r) + (r's run length) - 1.
// This kernel computes that plane directly instead of running the network.
//
// Grid (B, G): G CTAs share one query (`plan_g`: G = 1 once B fills the card, up to
// one CTA an SM slot at B 1; the wrapper may force G).
//
//   * Merge path. CTA g owns the rows [x_g, x_g+1), x_g = max{x : count(rows < x) <=
//     g * P / G}, count(rows < x) = sum over slots of lower_bound(slot, x), so each CTA
//     holds about P / G postings and a row's postings never straddle two CTAs. Each
//     CTA finds its two bounds itself by a (NC+1)-ary search over row values (NC
//     candidates a round per bound, one lower_bound per (candidate, slot) thread, each
//     searching only between the previous round's bracketing indices, then one warp a
//     bound picks the new bracket: two barriers a round): three rounds at 25,600 rows
//     and 16 slots. Its plane base, n_neg + count(rows < x_g), falls out of the search:
//     no CTA waits for another.
//   * In its range a CTA walks tiles of up to 8,192 rows: the tile's postings are
//     loaded, all slots at once, into registers (ITEMS a thread a batch), then added
//     slot by slot into a dense f32 sum and an i32 count in shared memory: rows are
//     unique within a slot, so there are no races, and each row's sum is taken in slot
//     order (0 + c_0 + c_1 + ...). The TPU adds a run by Hillis-Steele in network order;
//     slot order is this port's fixed order, shared with the plain twin (bit-equal on
//     any data) and with K3. A block scan of the counts gives every leader's position.
//   * sel = 0: every plane element is written exactly once. The sentinel prefix
//     [0, n_neg) and suffix [n_neg + P, Q2 * W2) are split evenly over the query's G
//     CTAs and written with 16-byte stores (scalar edges), FILL_STEP rounds of a
//     store a thread after each step of the search and the walk, whose waits on loads
//     and barriers they fill, the rest at the end; each posting position
//     belongs to the CTA whose rows hold it, which writes the leader's (row, score)
//     there (live: sum > 0; `all`: count >= the query's valid terms; `count` mode
//     scores sum + 4096 * count) or -1 / NEG_INF: a warp covers the runs of its 32
//     rows with coalesced stores, a lane a position, the leaders staged by position.
//   * sel > 0: the TPU's in-kernel selection, output bit for bit: per plane slot
//     p = position % 1024, the `sel` largest keys over the chunks c = position / 1024,
//       key = (sortable(score or NEG_INF) & ~0x1FFF) | (0x1FFF - c).
//     Keys are unique within a slot position (the chunk is part of the key), so the
//     selection is order-free. Each CTA stages its live leaders chunk by chunk in
//     shared memory and keeps, for each p it owns, the `sel` best live keys in
//     registers. Every dead key (sentinel, non-leader or dead leader) sits below every
//     live one, and among dead keys the lowest chunk wins, so the dead keys that fill a
//     list come in closed form: the lowest chunks not live at p. At G > 1 the CTAs'
//     live lists go to a scratch buffer and the query's last CTA (an atomic ticket
//     after a __threadfence, left at zero for the next launch) merges them.
//
// What bounds it: at the exact_30k shape (B 256, G 1, Q2 16, W2 32,768) the sel = 0
// plane, B * Q2 * W2 * 8 bytes = 1.07 GB, is almost all of the bytes (the postings
// read are ~0.1 GB); at 3.35 TB/s the write alone takes 0.32 ms. At the sharded
// lane's shard shape (B 1, the same plane, 4 MiB, ~27,600 postings) the bytes take
// 1.3 us and latency bounds the call: the setup's dependent loads, the search's
// rounds and the tile's slot steps. One CTA a query would write the whole plane from
// one SM; G CTAs spread the plane, the postings and the search over the card. With
// sel > 0 only the B * sel * 1024 * 8 byte shortlist is written, and the postings
// reads and the staging rounds (the chunks the postings reach, not all Q2 * W2 / 1024)
// set the time.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MIN_CTAS = 1;                 // __launch_bounds__ minimum CTAs an SM
constexpr int TILE = 8192;                  // document rows per tile
constexpr int ITEMS = 2;                    // postings a thread holds in a batch
constexpr int STAGE_CH = 8;                 // chunks staged a selection round
constexpr int VEC_FILL = 1;                 // 0: scalar sentinel stores
constexpr int FILL_STEP = 2;                // sentinel store rounds a walk step (0: all first)
constexpr int G_MAX = 512;                  // CTAs a query at most
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = TILE / THREADS;  // consecutive rows per thread in the scan
constexpr int PK = 1024;                    // plane positions per chunk
constexpr int PPT = PK / THREADS > 0 ? PK / THREADS : 1;  // slot positions a thread owns
constexpr int SEL_MAX = 4;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int EMPTY = INT_MIN;              // no live key

static_assert(THREADS % 32 == 0 && THREADS <= 1024 && PK % THREADS == 0, "THREADS");
static_assert(TILE % THREADS == 0, "TILE");

enum { MODE_ANY = 0, MODE_ALL = 1, MODE_COUNT = 2 };

// first index in [lo, hi) with a[index] >= x (a ascending), hi if none
__device__ __forceinline__ int lower_bound(const int32_t* a, int lo, int hi, long long x) {
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

// candidates a round of the merge-path search, per bound
__host__ __device__ __forceinline__ int search_cands(int Q2) {
  const int nc = THREADS / (2 * Q2);
  return nc > 1 ? nc : 1;
}

// shared memory: acc, cnt [TILE]; 11 arrays of Q2 (+1) slot values; the search's
// candidate indices [2 * NC * Q2] and counts [2 * NC]; the selection stage
__host__ __device__ inline size_t smem_bytes(int Q2, int sel) {
  const int nc = search_cands(Q2);
  return (size_t)TILE * 8 + (size_t)(11 * Q2 + 1) * 4 + (size_t)(2 * nc * Q2 + 2 * nc) * 4 +
         (sel ? (size_t)STAGE_CH * PK * 8 : 0);
}

// inclusive scan of x[0..n) in place (n <= TILE), PER_THREAD consecutive entries per thread
__device__ void block_scan(int* x, int n, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[PER_THREAD];
  int s = 0;
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int j = tid * PER_THREAD + i;
    s += j < n ? x[j] : 0;
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
    int t = lane < WARPS ? warp_tot[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(FULL, t, d);
      if (lane >= d) t += y;
    }
    if (lane < WARPS) warp_tot[lane] = t;
  }
  __syncthreads();
  const int off = incl - s + (warp ? warp_tot[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < PER_THREAD; ++i) {
    const int j = tid * PER_THREAD + i;
    if (j < n) x[j] = v[i] + off;
  }
  __syncthreads();
}

// exclusive scan of n[0..Q2) into pre[0..Q2], pre[Q2] the total (warp 0)
__device__ void slot_scan(const int* cur, const int* hi, int* pre, int Q2) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    int carry = 0;
    for (int base = 0; base < Q2; base += 32) {
      const int s = base + lane;
      const int v = s < Q2 ? hi[s] - cur[s] : 0;
      int incl = v;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(FULL, incl, d);
        if (lane >= d) incl += y;
      }
      if (s < Q2) pre[s] = carry + incl - v;
      carry += __shfl_sync(FULL, incl, 31);
    }
    if (lane == 0) pre[Q2] = carry;
  }
  __syncthreads();
}

// the slot s with pre[s] <= k < pre[s + 1]
__device__ __forceinline__ int slot_of(const int* pre, int Q2, int k) {
  int lo = 0, hi = Q2;  // the last s with pre[s] <= k
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (pre[mid] <= k) lo = mid;
    else hi = mid;
  }
  return lo;
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

// sentinels -1 / NEG_INF on plane positions [lo, hi) of the plane at rows / scores:
// with VEC_FILL the scalar edges now and the 16-byte body's int4 range in [a4, a4 + n4)
// for `fill_rounds`; else all of it now, with 4-byte stores
__device__ void fill_edges(int32_t* rows, float* scores, int lo, int hi, int* a4, int* n4) {
  const int tid = threadIdx.x;
  int a = lo, e = lo;
  if (VEC_FILL) {
    a = min((lo + 3) & ~3, hi);
    e = max(a, hi & ~3);
  }
  for (int i = lo + tid; i < a; i += THREADS) {
    rows[i] = -1;
    scores[i] = NEG_INF;
  }
  for (int i = e + tid; i < hi; i += THREADS) {
    rows[i] = -1;
    scores[i] = NEG_INF;
  }
  *a4 = a / 4;
  *n4 = (e - a) / 4;
}

// up to k rounds of the CTA's 16-byte sentinel stores (a round: one int4 and one float4
// a thread) over its ranges f = [a0, n0, a1, n1] (int4 units), from the CTA-uniform
// cursor `cur`: the walk issues them between its steps, where they fill its waits
__device__ __forceinline__ void fill_rounds(int32_t* rows, float* scores, const int* f, int& cur, int k) {
  const int n = f[1] + f[3];
  for (; k > 0 && cur < n; --k, cur += THREADS) {
    const int v = cur + threadIdx.x;
    if (v < n) {
      const int i = v < f[1] ? f[0] + v : f[2] + (v - f[1]);
      reinterpret_cast<int4*>(rows)[i] = make_int4(-1, -1, -1, -1);
      reinterpret_cast<float4*>(scores)[i] = make_float4(NEG_INF, NEG_INF, NEG_INF, NEG_INF);
    }
  }
}

// the final list of one slot position: the live keys, then the dead keys of the lowest
// chunks not live there (every dead key is below every live one)
__device__ __forceinline__ void finish_list(int* tops, int* pays, int sel) {
  int nlive = 0;
  int live_c[SEL_MAX];
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    live_c[l] = -1;
    if (l < sel && tops[l] != EMPTY) {
      live_c[l] = 0x1FFF - (tops[l] & 0x1FFF);
      ++nlive;
    }
  }
  int c = 0;
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    if (l >= nlive && l < sel) {
      bool taken = true;
      while (taken) {
        taken = false;
#pragma unroll
        for (int m = 0; m < SEL_MAX; ++m) taken |= live_c[m] == c;
        if (taken) ++c;
      }
      tops[l] = sel_key(NEG_INF, c);
      pays[l] = -1;
      ++c;
    }
  }
}

// the query's G live lists in `part` merged and written out (threads own slot positions)
__device__ void merge_lists(const int32_t* part, int32_t* out_rows, int32_t* out_keys, int b, int G, int sel) {
  const int tid = threadIdx.x;
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * THREADS;
    int tops[SEL_MAX], pays[SEL_MAX];
#pragma unroll
    for (int l = 0; l < SEL_MAX; ++l) {
      tops[l] = EMPTY;
      pays[l] = -1;
    }
    for (int g = 0; g < G; ++g) {
      const size_t o = ((size_t)b * G + g) * sel * PK * 2;
      for (int l = 0; l < sel; ++l) {
        const int key = __ldcg(part + o + (size_t)l * PK + p);
        if (key == EMPTY) break;  // each list is sorted, empties last
        insert_top(tops, pays, sel, key, __ldcg(part + o + (size_t)(sel + l) * PK + p));
      }
    }
    finish_list(tops, pays, sel);
    const size_t o = (size_t)b * sel * PK;
#pragma unroll
    for (int l = 0; l < SEL_MAX; ++l) {
      if (l < sel) {
        out_keys[o + (size_t)l * PK + p] = tops[l];
        out_rows[o + (size_t)l * PK + p] = pays[l];
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
k8_candidates(const int32_t* __restrict__ term_ids, const int32_t* __restrict__ offsets,
              const float* __restrict__ idf, const int32_t* __restrict__ rows,
              const float* __restrict__ wnorm, int32_t* __restrict__ out_rows,
              float* __restrict__ out_scores, int32_t* __restrict__ out_keys, int32_t* __restrict__ part,
              int32_t* __restrict__ tickets, int Q, int Q2, int W2, int mode, int sel, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* acc = reinterpret_cast<float*>(smem);      // [TILE] row sums
  int* cnt = reinterpret_cast<int*>(acc + TILE);    // [TILE] counts, then their inclusive scan
  int* s_a = cnt + TILE;                            // [Q2] first posting of each slot's window
  int* s_n = s_a + Q2;                              // [Q2] postings the window holds
  float* s_idf = reinterpret_cast<float*>(s_n + Q2);  // [Q2]
  int* s_cur = reinterpret_cast<int*>(s_idf + Q2);  // [Q2] first unread posting of the CTA's range
  int* s_end = s_cur + Q2;                          // [Q2] end of the CTA's range
  int* s_hi = s_end + Q2;                           // [Q2] end of the slot's postings in the tile
  int* s_pre = s_hi + Q2;                           // [Q2 + 1] the tile's postings before each slot
  int* p_lo = s_pre + Q2 + 1;                       // [2][2][Q2]: per bound, lower_bound at lo, at hi
  const int nc = search_cands(Q2);
  int* p_lb = p_lo + 4 * Q2;                        // [2 * NC * Q2] the candidates' lower_bounds
  int* p_f = p_lb + 2 * nc * Q2;                    // [2 * NC] the candidates' counts
  int* stage_key = p_f + 2 * nc;                    // [STAGE_CH * PK] (sel > 0)
  int* stage_row = stage_key + STAGE_CH * PK;       // [STAGE_CH * PK]
  __shared__ int warp_tot[WARPS];
  __shared__ int sh_neg, sh_nterm, sh_p, sh_rmin, sh_rmax, sh_t0, sh_last;
  __shared__ int sh_lo[2], sh_hi[2], sh_f[2], sh_step[2];
  __shared__ int sh_fill[4];  // the CTA's 16-byte sentinel ranges: [a0, n0, a1, n1] in int4s
  __shared__ int w_row[WARPS][32];  // a warp's leaders by position (sel 0)
  __shared__ float w_sc[WARPS][32];
  __shared__ long long sh_T[2];

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int n_plane = Q2 * W2;
  int* p_hi = p_lo + Q2;  // bound k's arrays: p_lo + 2 * k * Q2 (lo), + Q2 (hi)

  if (tid == 0) {
    sh_neg = sh_nterm = sh_p = 0;
    sh_rmin = INT_MAX;
    sh_rmax = -1;
  }
  for (int i = tid; i < 2 * nc; i += THREADS) p_f[i] = 0;
  __syncthreads();
  for (int s = tid; s < Q2; s += THREADS) {
    const int t = s < Q ? term_ids[(size_t)b * Q + s] : -1;
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
    const int start = (s & 1) ? offs + len - eff : offs;  // odd slots: the reversed copy's head
    s_a[s] = start;
    s_n[s] = eff;
    s_idf[s] = w;
    atomicAdd(&sh_neg, (s & 1) ? W2 - dlt - eff : dlt);
    if (eff > 0) {
      atomicAdd(&sh_p, eff);
      atomicMin(&sh_rmin, rows[start]);
      atomicMax(&sh_rmax, rows[start + eff - 1]);
    }
  }
  __syncthreads();
  const int n_neg = sh_neg, nterm = sh_nterm, P = sh_p;
  const size_t plane0 = (size_t)b * n_plane;

  int32_t* const plane_rows = out_rows + plane0;  // sel 0
  float* const plane_scores = out_scores + plane0;
  int fcur = 0;  // sentinel int4s issued (CTA-uniform)
  if (sel == 0) {  // this CTA's share of the sentinel prefix and suffix: the edges now
    const long long tail = (long long)n_plane - n_neg - P;
    int a0, n0, a1, n1;
    fill_edges(plane_rows, plane_scores, (int)((long long)n_neg * g / G), (int)((long long)n_neg * (g + 1) / G),
               &a0, &n0);
    fill_edges(plane_rows, plane_scores, n_neg + P + (int)(tail * g / G), n_neg + P + (int)(tail * (g + 1) / G),
               &a1, &n1);
    if (tid == 0) {
      sh_fill[0] = a0;
      sh_fill[1] = n0;
      sh_fill[2] = a1;
      sh_fill[3] = n1;
    }
  } else if (tid < 4) {
    sh_fill[tid] = 0;
  }

  // ---- the CTA's rows [x_g, x_g+1): bound 0 is x_g, bound 1 is x_g+1
  const bool act0 = g > 0 && P > 0, act1 = g + 1 < G && P > 0;
  for (int i = tid; i < 2 * Q2; i += THREADS) {
    const int s = i % Q2;
    p_lo[(i / Q2) * 2 * Q2 + s] = s_a[s];
    p_hi[(i / Q2) * 2 * Q2 + s] = s_a[s] + s_n[s];
  }
  if (tid < 2) {
    sh_lo[tid] = sh_rmin;
    sh_hi[tid] = sh_rmax + 1;
    sh_f[tid] = 0;
    sh_T[tid] = (long long)P * (g + tid) / G;
  }
  __syncthreads();
  if (FILL_STEP == 0) fill_rounds(plane_rows, plane_scores, sh_fill, fcur, INT_MAX);
  // (NC+1)-ary search for x = max{x : count(rows < x) <= T}: count(lo) <= T < count(hi).
  // A round: one lower_bound per (bound, candidate, slot) between the bracketing
  // indices, then warp k picks bound k's new bracket; two barriers a round.
  if (tid < 2) {
    const int len = sh_hi[tid] - sh_lo[tid];
    sh_step[tid] = (tid ? act1 : act0) && len > 1 ? (int)(((long long)len + nc) / (nc + 1)) : 0;
  }
  __syncthreads();
  while (sh_step[0] || sh_step[1]) {
    for (int i = tid; i < 2 * nc * Q2; i += THREADS) {
      const int k = i / (nc * Q2), j = (i / Q2) % nc, s = i % Q2;
      if (!sh_step[k]) continue;
      const long long x = (long long)sh_lo[k] + (long long)(j + 1) * sh_step[k];
      if (x >= sh_hi[k]) continue;
      const int v = lower_bound(rows, p_lo[k * 2 * Q2 + s], p_hi[k * 2 * Q2 + s], x);
      p_lb[i] = v;
      atomicAdd(&p_f[k * nc + j], v - s_a[s]);
    }
    fill_rounds(plane_rows, plane_scores, sh_fill, fcur, FILL_STEP);
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2 && sh_step[warp]) {
      const int k = warp, lo = sh_lo[k], st = sh_step[k];
      int nle = 0, nval = 0;  // candidates below hi, and of those with count <= T (a prefix)
      for (int j0 = 0; j0 < nc; j0 += 32) {
        const int j = j0 + lane;
        const bool valid = j < nc && (long long)lo + (long long)(j + 1) * st < sh_hi[k];
        nle += __popc(__ballot_sync(FULL, valid && p_f[k * nc + j] <= sh_T[k]));
        nval += __popc(__ballot_sync(FULL, valid));
      }
      const int jl = nle - 1, jh = nle < nval ? nle : -1;
      for (int s = lane; s < Q2; s += 32) {
        if (jl >= 0) p_lo[k * 2 * Q2 + s] = p_lb[(k * nc + jl) * Q2 + s];
        if (jh >= 0) p_hi[k * 2 * Q2 + s] = p_lb[(k * nc + jh) * Q2 + s];
      }
      const int f_jl = jl >= 0 ? p_f[k * nc + jl] : 0;
      __syncwarp();
      for (int j = lane; j < nc; j += 32) p_f[k * nc + j] = 0;
      if (lane == 0) {
        if (jl >= 0) {
          sh_lo[k] = lo + (jl + 1) * st;
          sh_f[k] = f_jl;
        }
        if (jh >= 0) sh_hi[k] = lo + (jh + 1) * st;
        const int len = sh_hi[k] - sh_lo[k];
        sh_step[k] = len > 1 ? (int)(((long long)len + nc) / (nc + 1)) : 0;
      }
    }
    __syncthreads();
  }
  // the CTA's range, from its bounds' lower_bounds
  for (int s = tid; s < Q2; s += THREADS) {
    s_cur[s] = act0 ? p_lo[s] : s_a[s];
    s_end[s] = act1 ? p_lo[2 * Q2 + s] : s_a[s] + s_n[s];
  }
  const int x_lo = act0 ? sh_lo[0] : sh_rmin;
  const int x_hi = act1 ? sh_lo[1] : sh_rmax + 1;  // rows of the range are below it
  int done = act0 ? sh_f[0] : 0;                  // real postings before the current tile

  int tops[PPT][SEL_MAX], pays[PPT][SEL_MAX];
#pragma unroll
  for (int k = 0; k < PPT; ++k)
#pragma unroll
    for (int l = 0; l < SEL_MAX; ++l) {
      tops[k][l] = EMPTY;
      pays[k][l] = -1;
    }
  if (sel)
    for (int i = tid; i < STAGE_CH * PK; i += THREADS) stage_key[i] = EMPTY;
  __syncthreads();

  // ---- the tiles of the range
  for (bool first = true;; first = false) {
    if (tid == 0) sh_t0 = INT_MAX;
    __syncthreads();
    for (int s = tid; s < Q2; s += THREADS)
      if (s_cur[s] < s_end[s]) atomicMin(&sh_t0, first ? x_lo : rows[s_cur[s]]);
    __syncthreads();
    const int t0 = sh_t0;
    if (t0 == INT_MAX) break;
    const int width = (int)min((long long)TILE, (long long)x_hi - t0);
    const bool whole = (long long)t0 + TILE >= x_hi;  // the rest of the range fits this tile
    for (int s = tid; s < Q2; s += THREADS)
      s_hi[s] = whole ? s_end[s] : lower_bound(rows, s_cur[s], s_end[s], (long long)t0 + TILE);
    for (int i = tid; i < width; i += THREADS) {
      acc[i] = 0.f;
      cnt[i] = 0;
    }
    __syncthreads();
    slot_scan(s_cur, s_hi, s_pre, Q2);
    const int tile_total = s_pre[Q2];
    // the tile's postings in batches of THREADS * ITEMS, flat in slot order
    for (int k0 = 0; k0 < tile_total; k0 += THREADS * ITEMS) {
      int rr[ITEMS], ss[ITEMS];
      float pp[ITEMS];
#pragma unroll
      for (int j = 0; j < ITEMS; ++j) {
        const int k = k0 + j * THREADS + tid;
        ss[j] = -1;
        if (k < tile_total) {
          const int s = slot_of(s_pre, Q2, k);
          const int i = s_cur[s] + (k - s_pre[s]);
          ss[j] = s;
          rr[j] = rows[i] - t0;
          pp[j] = __fmul_rn(s_idf[s], wnorm[i]);
        }
      }
      const int s_first = slot_of(s_pre, Q2, k0);
      const int s_last = slot_of(s_pre, Q2, min(k0 + THREADS * ITEMS, tile_total) - 1);
      for (int s = s_first; s <= s_last; ++s) {  // slot order: the fixed summation order
#pragma unroll
        for (int j = 0; j < ITEMS; ++j) {
          if (ss[j] == s) {
            acc[rr[j]] = __fadd_rn(acc[rr[j]], pp[j]);
            cnt[rr[j]] += 1;
          }
        }
        fill_rounds(plane_rows, plane_scores, sh_fill, fcur, FILL_STEP);
        __syncthreads();
      }
    }
    block_scan(cnt, width, warp_tot);
    const int base = n_neg + done;  // plane position of the tile's first posting

    if (sel == 0) {
      // warp w writes the runs of its 32 rows, [cnt[r0 - 1], cnt[r0 + 31]) of the tile's
      // positions, with coalesced stores: lane j takes position q0 + j; the live
      // leaders' values are staged by position in w_row / w_sc
      const int warp = tid >> 5, lane = tid & 31;
      for (int r0 = warp * 32; r0 < width; r0 += THREADS) {
        const int r = r0 + lane;
        const int incl = r < width ? cnt[r] : 0;
        const int c = r < width ? incl - (r ? cnt[r - 1] : 0) : 0;
        int lrow = -1;
        float lsc = NEG_INF;
        if (c > 0) {
          const float sum = acc[r];
          if (sum > 0.f && (mode != MODE_ALL || c >= nterm)) {
            lrow = t0 + r;
            lsc = mode == MODE_COUNT ? __fadd_rn(sum, 4096.f * (float)c) : sum;
          }
        }
        const int e = cnt[min(r0 + 31, width - 1)];
        for (int q0 = r0 ? cnt[r0 - 1] : 0; q0 < e; q0 += 32) {
          const int off = incl - 1 - q0;
          const bool here = c > 0 && off >= 0 && off < 32;
          if (here) {
            w_row[warp][off] = lrow;
            w_sc[warp][off] = lsc;
          }
          const unsigned lead = __reduce_or_sync(FULL, here ? 1u << off : 0u);
          __syncwarp();
          if (q0 + lane < e) {
            const bool l = lead >> lane & 1;
            const size_t o = plane0 + base + q0 + lane;
            out_rows[o] = l ? w_row[warp][lane] : -1;
            out_scores[o] = l ? w_sc[warp][lane] : NEG_INF;
          }
          __syncwarp();
        }
      }
    } else if (tile_total > 0) {
      // the live leaders, STAGE_CH chunks a round: rows whose inclusive count lands in
      // [c0 * PK - base + 1, (c0 + STAGE_CH) * PK - base + 1)
      const int c_end = (base + tile_total - 1) / PK + 1;
      for (int c0 = base / PK; c0 < c_end; c0 += STAGE_CH) {
        const int r_lo = lower_bound(cnt, 0, width, (long long)c0 * PK - base + 1);
        const int r_hi = lower_bound(cnt, r_lo, width, (long long)(c0 + STAGE_CH) * PK - base + 1);
        for (int r = r_lo + tid; r < r_hi; r += THREADS) {
          const int incl = cnt[r];
          const int c = incl - (r ? cnt[r - 1] : 0);
          const float sum = acc[r];
          if (c > 0 && sum > 0.f && (mode != MODE_ALL || c >= nterm)) {
            const int pos = base + incl - 1;
            const float sc = mode == MODE_COUNT ? __fadd_rn(sum, 4096.f * (float)c) : sum;
            stage_key[pos - c0 * PK] = sel_key(sc, pos / PK);
            stage_row[pos - c0 * PK] = t0 + r;
          }
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < PPT; ++k) {
          const int p = tid + k * THREADS;
          for (int h = 0; h < STAGE_CH; ++h) {
            const int key = stage_key[h * PK + p];
            if (key != EMPTY) {
              insert_top(tops[k], pays[k], sel, key, stage_row[h * PK + p]);
              stage_key[h * PK + p] = EMPTY;
            }
          }
        }
        __syncthreads();
      }
    }
    for (int s = tid; s < Q2; s += THREADS) s_cur[s] = s_hi[s];
    done += tile_total;
    __syncthreads();
  }

  if (!sel) {
    fill_rounds(plane_rows, plane_scores, sh_fill, fcur, INT_MAX);  // what the walk left
    return;
  }
  if (G == 1) {
#pragma unroll
    for (int k = 0; k < PPT; ++k) {
      const int p = tid + k * THREADS;
      finish_list(tops[k], pays[k], sel);
      const size_t o = (size_t)b * sel * PK;
#pragma unroll
      for (int l = 0; l < SEL_MAX; ++l) {
        if (l < sel) {
          out_keys[o + (size_t)l * PK + p] = tops[k][l];
          out_rows[o + (size_t)l * PK + p] = pays[k][l];
        }
      }
    }
    return;
  }
  // this CTA's live lists [sel keys][sel rows] x PK to the scratch, then the last CTA
  // of the query merges the G lists
  const size_t o = ((size_t)b * G + g) * sel * PK * 2;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int p = tid + k * THREADS;
#pragma unroll
    for (int l = 0; l < SEL_MAX; ++l) {
      if (l < sel) {
        part[o + (size_t)l * PK + p] = tops[k][l];
        part[o + (size_t)(sel + l) * PK + p] = pays[k][l];
      }
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sh_last = atomicAdd(&tickets[b], 1) == G - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  merge_lists(part, out_rows, out_keys, b, G, sel);
  if (tid == 0) tickets[b] = 0;  // for the next launch
}

// G CTAs a query: enough for B * G to fill every SM's CTA slots, within one chunk of
// the plane a CTA and G_MAX
int plan_g(int B, int Q2, int W2, int sms, int per_sm) {
  const long long slots = (long long)sms * per_sm;
  long long g = B >= slots ? 1 : (slots + B - 1) / B;
  g = g < (long long)Q2 * W2 / PK ? g : (long long)Q2 * W2 / PK;
  g = g < G_MAX ? g : G_MAX;
  return g > 1 ? (int)g : 1;
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: term_ids [B, Q] i32 (-1 pads),
// offsets [T+1] i32, idf [T] f32, rows / wnorm [P] (each term's slice row-ascending),
// Q2 the power of two >= max(Q, 2) and <= 1024, W2 a power of two >= 2048 that holds
// every queried term's slice after its offset % 1024, mode 0 any / 1 all / 2 count,
// 0 <= sel <= 4 (Q2 * W2 / 1024 <= 8192 when sel > 0), 1 <= G <= 512 CTAs a query.
// sel = 0: out_rows [B, Q2*W2] i32, out_scores [B, Q2*W2] f32, out_keys, part and
// tickets unused; sel > 0: out_rows and out_keys [B, sel*1024] i32, out_scores unused,
// and at G > 1 part [B, G, 2, sel, 1024] i32 scratch and tickets [B] i32 at zero (left
// at zero). Returns a cudaError_t (0 = launched).
int wax_k8_candidates(const int32_t* term_ids, const int32_t* offsets, const float* idf,
                      const int32_t* rows, const float* wnorm, int32_t* out_rows, float* out_scores,
                      int32_t* out_keys, int32_t* part, int32_t* tickets, int B, int Q, int Q2, int W2, int mode,
                      int sel, int G, cudaStream_t stream) {
  if (G < 1 || G > G_MAX) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Q2, sel);
  cudaError_t e = cudaFuncSetAttribute(k8_candidates, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k8_candidates<<<dim3(B, G), THREADS, smem, stream>>>(term_ids, offsets, idf, rows, wnorm, out_rows, out_scores,
                                                       out_keys, part, tickets, Q, Q2, W2, mode, sel, G);
  return (int)cudaGetLastError();
}

// K8's launch for B queries of Q2 slots x W2: out = [G, threads, tile rows, CTAs an SM
// holds, the device's SMs, dynamic shared memory bytes]. Launches nothing.
int wax_k8_plan(int B, int Q2, int W2, int sel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = smem_bytes(Q2, sel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k8_candidates, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k8_candidates, THREADS, smem);
  out[0] = plan_g(B, Q2, W2, sms, per_sm);
  out[1] = THREADS;
  out[2] = TILE;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)smem;
  return (int)e;
}

}  // extern "C"
