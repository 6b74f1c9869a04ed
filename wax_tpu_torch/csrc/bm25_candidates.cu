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
// sits at  n_neg + (real postings with a row below r) + (r's run length) - 1: the
// postings merged by (row, slot), shifted by n_neg. This kernel computes that plane,
// or its selection, directly instead of running the network. Each row's postings are
// summed in slot order (0 + c_0 + c_1 + ...): the TPU adds a run by Hillis-Steele in
// network order; slot order is this port's fixed order, shared with the plain twin
// (bit-equal on any data) and with K3.
//
// Merge path. A query is split over CTAs: CTA g of n owns the rows [x_g, x_g+1),
// x_g = max{x : count(rows < x) <= g * P / n}, count(rows < x) = sum over slots of
// lower_bound(slot, x), so each CTA holds about P / n postings and a row's postings
// never straddle two CTAs. Each CTA finds its two bounds itself by a (NC+1)-ary search
// over row values (NC candidates a round per bound, one lower_bound per (candidate,
// slot) thread, each searching only between the previous round's bracketing indices,
// then one warp a bound picks the new bracket: two barriers a round): three rounds at
// 25,600 rows and 16 slots, five at 8.8M. Its plane base, n_neg + count(rows < x_g),
// falls out of the search: no CTA waits for another.
//
// Row tiles (sel = 0): the CTA walks its rows in tiles of up to 8,192 rows: the tile's
// postings are loaded, all slots at once, into registers (ITEMS a thread a batch), then
// added slot by slot into a dense f32 sum and an i32 count in shared memory: rows are
// unique within a slot, so there are no races. A block scan of the counts gives every
// leader's position.
//
// sel = 0, `k8_candidates` (the whole plane; grid (B, G), all G CTAs of a query share
// it, `plan_g`: G = 1 once B fills the card, up to one CTA an SM slot at B 1): row
// tiles. Every plane element is written exactly once. The sentinel prefix [0, n_neg)
// and suffix [n_neg + P, Q2 * W2) are split evenly over the query's G CTAs and written
// with 16-byte stores (scalar edges), FILL_STEP rounds of a store a thread after each
// step of the search and the walk, whose waits on loads and barriers they fill, the
// rest at the end; each posting position belongs to the CTA whose rows hold it, which
// writes the leader's (row, score) there (live: sum > 0; `all`: count >= the query's
// valid terms; `count` mode scores sum + 4096 * count) or -1 / NEG_INF: a warp covers
// the runs of its 32 rows with coalesced stores, a lane a position, the leaders staged
// by position.
//
// sel > 0, `k8_candidates_sel` (the TPU's in-kernel selection, output bit for bit: per
// plane slot p = position % 1024, the `sel` largest keys over the chunks c = position /
// 1024, key = (sortable(score or NEG_INF) & ~0x1FFF) | (0x1FFF - c)):
//   * Partition by postings: a query takes n = min(G, ceil(P / WALK_MIN)) of its G CTAs
//     (at least one), so a CTA owns WALK_MIN to 2 * WALK_MIN postings of a large query
//     and a small query one CTA; the rest exit after the setup. `plan_g` sizes G for
//     a query of Q2 slices of W2 / 2 postings, within PART_BYTES of scratch.
//   * Each CTA walks its postings in merge order, in windows: each slot's next postings
//     (rows and weights, TW in all, shared out in proportion to what each slot has
//     left) are copied into shared memory with 4-byte `cp.async`s, the next window's
//     while this one is merged. The window's bound m is the smallest last row among
//     the slots with postings past their window; every posting with row <= m is then
//     on chip (the ready ones), and no run of equal rows straddles two windows.
//   * The ready postings are put in (row, slot) order by a counting sort on chip: NB
//     buckets of 2^sh rows over [m0, m] (atomic counts, a block scan, a scatter of
//     window indices), then each posting ranks itself among its bucket's few (window
//     index order is slot order, as the window is laid out slot by slot). The element
//     that ends a run of equal rows is its leader: it sums its run in slot order and
//     applies the live test; its plane position is the CTA's base + its rank.
//   * Keys are unique within a slot position (the chunk is part of the key), so the
//     selection is order-free. Thread p keeps, in registers, the `sel` best live keys
//     of the positions at p. Every dead key (sentinel, non-leader or dead leader) sits
//     below every live one, and among dead keys the lowest chunk wins, so the dead keys
//     that fill a list come in closed form: the lowest chunks not live at p. With n > 1
//     the CTAs' live lists go to a scratch buffer and the query's last CTA (an atomic
//     ticket after a __threadfence, left at zero for the next launch) merges them.
//
// What bounds it. sel = 0 at the exact_30k shape (B 256, G 1, Q2 16, W2 32,768): the
// plane, B * Q2 * W2 * 8 bytes = 1.07 GB, is almost all of the bytes (the postings read
// are ~0.1 GB); at 3.35 TB/s the write alone takes 0.32 ms. At the sharded lane's shard
// shape (B 1, the same plane, 4 MiB, ~27,600 postings) the bytes take 1.3 us and
// latency bounds the call: the setup's dependent loads, the search's rounds and the
// tile's slot steps; G CTAs spread the plane, the postings and the search over the
// card. sel > 0 writes only the B * sel * 1024 * 8 byte shortlist and reads each
// query's own postings once (8 bytes each: 0.7 GB at hybrid_msmarco1.b256's B 256 x
// ~350K postings, 0.2 ms). A row tile pays its fixed cost (a global binary search a
// slot, 8,192 sums cleared and scanned, a barrier a slot) every 8,192 rows, whatever
// they hold: 1,080 tiles of ~300 postings a query at that cell, 32 ms. The postings
// walk's cost follows the postings, not the rows they span: about ten barriers and
// some 200 instructions a posting over the phases of a window of ~3,600 ready ones
// (clock64 profile: the ranks 20%, the search 18%, the leaders 12%, warp 0's
// bookkeeping 11%, the copies 10%, the counts 9%), one 1,024-thread CTA an SM: the
// phases' latency and issue, not bytes. Where a query holds more than a posting a row,
// row tiles would cost less (exact_30k's 1.6 postings a row at sel 3: 0.29 against
// 0.48 ms), but no path of the program sends such a query to sel > 0: it runs sel > 0
// only on budgeted shards of 2^23 rows or more, whose queries' postings spread over the
// shard.
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

namespace {

constexpr int THREADS = 1024;
constexpr int MIN_CTAS = 1;                 // __launch_bounds__ minimum CTAs an SM
constexpr int TILE = 8192;                  // document rows per tile (sel 0)
constexpr int ITEMS = 2;                    // postings a thread holds in a batch (sel 0)
constexpr int VEC_FILL = 1;                 // 0: scalar sentinel stores
constexpr int FILL_STEP = 2;                // sentinel store rounds a walk step (0: all first)
constexpr int TW = 4096;                    // postings a window (sel > 0)
constexpr int NB = 4096;                    // counting-sort buckets a window (sel > 0)
constexpr int WALK_MIN = 65536;             // postings a CTA owns at least (sel > 0), unless the query has fewer
constexpr long long PART_BYTES = 256ll << 20;  // the sel merge's scratch at most (sel > 0)
constexpr int G_MAX = 512;                  // CTAs a query at most
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = TILE / THREADS;  // consecutive rows per thread in the scan
constexpr int PK = 1024;                    // plane positions per chunk
constexpr int IW = TW / THREADS;            // ready postings a thread takes a window
constexpr int SEL_MAX = 4;
constexpr float NEG_INF = -3.0e38f;
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int EMPTY = INT_MIN;              // no live key

static_assert(THREADS % 32 == 0 && THREADS <= 1024 && PK == THREADS, "THREADS: a thread a slot position");
static_assert(TILE % THREADS == 0 && TW % THREADS == 0 && NB % THREADS == 0 && NB <= TILE, "TILE, TW, NB");
static_assert(TW >= 1024, "TW: a window holds at least one posting a slot");

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

// the search's shared memory: per bound the lower_bounds at lo and hi [2][2][Q2], the
// candidates' lower_bounds [2 * NC * Q2] and counts [2 * NC]
__host__ __device__ inline size_t search_smem_bytes(int Q2) {
  const int nc = search_cands(Q2);
  return (size_t)(4 * Q2 + 2 * nc * Q2 + 2 * nc) * 4;
}

// the tile walk's shared memory: acc, cnt [TILE], 7 arrays of Q2 (+1) slot values, the search's
__host__ __device__ inline size_t smem_bytes(int Q2) {
  return (size_t)TILE * 8 + (size_t)(7 * Q2 + 1) * 4 + search_smem_bytes(Q2);
}

// the selection kernel's shared memory: the windows' rows and weights [2][TW], buckets
// [NB], keys [TW], the ready postings' rows and values [TW], 10 arrays of Q2 (+1) slot
// values, the search's
__host__ __device__ inline size_t sel_smem_bytes(int Q2) {
  return (size_t)TW * 4 * 7 + (size_t)NB * 4 + (size_t)(10 * Q2 + 3) * 4 + search_smem_bytes(Q2);
}

// inclusive scan of x[0..n) in place (n <= PER * THREADS), PER consecutive entries per thread
template <int PER>
__device__ void block_scan(int* x, int n, int* warp_tot) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int v[PER];
  int s = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int j = tid * PER + i;
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
  for (int i = 0; i < PER; ++i) {
    const int j = tid * PER + i;
    if (j < n) x[j] = v[i] + off;
  }
  __syncthreads();
}

// one warp's exclusive scan of v over 32 lanes: (the lane's prefix, the warp's total)
__device__ __forceinline__ int warp_excl(int v, int& total) {
  const int lane = threadIdx.x & 31;
  int incl = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int y = __shfl_up_sync(FULL, incl, d);
    if (lane >= d) incl += y;
  }
  total = __shfl_sync(FULL, incl, 31);
  return incl - v;
}

// exclusive scan of n[0..Q2) into pre[0..Q2], pre[Q2] the total (warp 0)
__device__ void slot_scan(const int* cur, const int* hi, int* pre, int Q2) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    int carry = 0;
    for (int base = 0; base < Q2; base += 32) {
      const int s = base + lane;
      int tot;
      const int e = warp_excl(s < Q2 ? hi[s] - cur[s] : 0, tot);
      if (s < Q2) pre[s] = carry + e;
      carry += tot;
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

// the first n of the query's G live lists in `part` merged and written out (thread p
// owns slot position p)
__device__ void merge_lists(const int32_t* part, int32_t* out_rows, int32_t* out_keys, int b, int G, int n, int sel) {
  const int p = threadIdx.x;
  int tops[SEL_MAX], pays[SEL_MAX];
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    tops[l] = EMPTY;
    pays[l] = -1;
  }
  for (int g = 0; g < n; ++g) {
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

// a query's totals, filled by `query_setup`
struct Query {
  int neg, nterm, p, rmin, rmax;
};

// the merge-path search's state; after `merge_path`, the CTA's rows are [x_lo, x_hi)
// and `done` real postings lie below x_lo
struct Search {
  int lo[2], hi[2], f[2], step[2];
  long long T[2];
  int x_lo, x_hi, done;
};

// slot s's window of the query (s_a: its first posting, s_n: how many), its idf, and
// the query's totals
__device__ __forceinline__ void query_setup(const int32_t* term_ids, const int32_t* offsets, const float* idf,
                                            const int32_t* rows, int b, int Q, int Q2, int W2, int* s_a, int* s_n,
                                            float* s_idf, Query& q) {
  const int tid = threadIdx.x;
  if (tid == 0) {
    q.neg = q.nterm = q.p = 0;
    q.rmin = INT_MAX;
    q.rmax = -1;
  }
  __syncthreads();
  for (int s = tid; s < Q2; s += THREADS) {
    const int t = s < Q ? term_ids[(size_t)b * Q + s] : -1;
    int offs = 0, len = 0;
    float w = 0.f;
    if (t >= 0) {
      offs = offsets[t];
      len = offsets[t + 1] - offs;
      w = idf[t];
      atomicAdd(&q.nterm, 1);
    }
    const int dlt = offs & (PK - 1);
    const int eff = min(len, W2 - dlt);  // what the window holds (all of it on a snapshot)
    const int start = (s & 1) ? offs + len - eff : offs;  // odd slots: the reversed copy's head
    s_a[s] = start;
    s_n[s] = eff;
    s_idf[s] = w;
    atomicAdd(&q.neg, (s & 1) ? W2 - dlt - eff : dlt);
    if (eff > 0) {
      atomicAdd(&q.p, eff);
      atomicMin(&q.rmin, rows[start]);
      atomicMax(&q.rmax, rows[start + eff - 1]);
    }
  }
  __syncthreads();
}

// CTA g of n's rows of the query and the postings of each slot there, [s_cur, s_end).
// With FILL the sentinel stores `fill_rounds` issues ride along the search's rounds.
template <bool FILL>
__device__ __forceinline__ void merge_path(const int32_t* rows, int Q2, int g, int n, const Query& q, const int* s_a,
                                           const int* s_n, int* s_cur, int* s_end, int* p_lo, int* p_lb, int* p_f,
                                           Search& sh, int32_t* plane_rows, float* plane_scores, const int* sh_fill,
                                           int& fcur) {
  const int tid = threadIdx.x;
  const int nc = search_cands(Q2);
  int* p_hi = p_lo + Q2;  // bound k's arrays: p_lo + 2 * k * Q2 (lo), + Q2 (hi)
  const int P = q.p;
  // ---- bound 0 is x_g, bound 1 is x_g+1
  const bool act0 = g > 0 && P > 0, act1 = g + 1 < n && P > 0;
  for (int i = tid; i < 2 * nc; i += THREADS) p_f[i] = 0;
  for (int i = tid; i < 2 * Q2; i += THREADS) {
    const int s = i % Q2;
    p_lo[(i / Q2) * 2 * Q2 + s] = s_a[s];
    p_hi[(i / Q2) * 2 * Q2 + s] = s_a[s] + s_n[s];
  }
  if (tid < 2) {
    sh.lo[tid] = q.rmin;
    sh.hi[tid] = q.rmax + 1;
    sh.f[tid] = 0;
    sh.T[tid] = (long long)P * (g + tid) / n;
  }
  __syncthreads();
  if (FILL && FILL_STEP == 0) fill_rounds(plane_rows, plane_scores, sh_fill, fcur, INT_MAX);
  // (NC+1)-ary search for x = max{x : count(rows < x) <= T}: count(lo) <= T < count(hi).
  // A round: one lower_bound per (bound, candidate, slot) between the bracketing
  // indices, then warp k picks bound k's new bracket; two barriers a round.
  if (tid < 2) {
    const int len = sh.hi[tid] - sh.lo[tid];
    sh.step[tid] = (tid ? act1 : act0) && len > 1 ? (int)(((long long)len + nc) / (nc + 1)) : 0;
  }
  __syncthreads();
  while (sh.step[0] || sh.step[1]) {
    for (int i = tid; i < 2 * nc * Q2; i += THREADS) {
      const int k = i / (nc * Q2), j = (i / Q2) % nc, s = i % Q2;
      if (!sh.step[k]) continue;
      const long long x = (long long)sh.lo[k] + (long long)(j + 1) * sh.step[k];
      if (x >= sh.hi[k]) continue;
      const int v = lower_bound(rows, p_lo[k * 2 * Q2 + s], p_hi[k * 2 * Q2 + s], x);
      p_lb[i] = v;
      atomicAdd(&p_f[k * nc + j], v - s_a[s]);
    }
    if (FILL) fill_rounds(plane_rows, plane_scores, sh_fill, fcur, FILL_STEP);
    __syncthreads();
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < 2 && sh.step[warp]) {
      const int k = warp, lo = sh.lo[k], st = sh.step[k];
      int nle = 0, nval = 0;  // candidates below hi, and of those with count <= T (a prefix)
      for (int j0 = 0; j0 < nc; j0 += 32) {
        const int j = j0 + lane;
        const bool valid = j < nc && (long long)lo + (long long)(j + 1) * st < sh.hi[k];
        nle += __popc(__ballot_sync(FULL, valid && p_f[k * nc + j] <= sh.T[k]));
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
          sh.lo[k] = lo + (jl + 1) * st;
          sh.f[k] = f_jl;
        }
        if (jh >= 0) sh.hi[k] = lo + (jh + 1) * st;
        const int len = sh.hi[k] - sh.lo[k];
        sh.step[k] = len > 1 ? (int)(((long long)len + nc) / (nc + 1)) : 0;
      }
    }
    __syncthreads();
  }
  // the CTA's range, from its bounds' lower_bounds
  for (int s = tid; s < Q2; s += THREADS) {
    s_cur[s] = act0 ? p_lo[s] : s_a[s];
    s_end[s] = act1 ? p_lo[2 * Q2 + s] : s_a[s] + s_n[s];
  }
  if (tid == 0) {
    sh.x_lo = act0 ? sh.lo[0] : q.rmin;
    sh.x_hi = act1 ? sh.lo[1] : q.rmax + 1;  // rows of the range are below it
    sh.done = act0 ? sh.f[0] : 0;            // real postings before the range
  }
}

__global__ void __launch_bounds__(THREADS, MIN_CTAS)
k8_candidates(const int32_t* __restrict__ term_ids, const int32_t* __restrict__ offsets,
              const float* __restrict__ idf, const int32_t* __restrict__ rows,
              const float* __restrict__ wnorm, int32_t* __restrict__ out_rows,
              float* __restrict__ out_scores, int Q, int Q2, int W2, int mode, int G) {
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
  __shared__ int warp_tot[WARPS];
  __shared__ Query q;
  __shared__ Search sh;
  __shared__ int sh_t0;
  __shared__ int sh_fill[4];  // the CTA's 16-byte sentinel ranges: [a0, n0, a1, n1] in int4s
  __shared__ int w_row[WARPS][32];  // a warp's leaders by position
  __shared__ float w_sc[WARPS][32];

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int n_plane = Q2 * W2;

  query_setup(term_ids, offsets, idf, rows, b, Q, Q2, W2, s_a, s_n, s_idf, q);
  const int n_neg = q.neg, P = q.p;
  const size_t plane0 = (size_t)b * n_plane;

  int32_t* const plane_rows = out_rows + plane0;
  float* const plane_scores = out_scores + plane0;
  int fcur = 0;  // sentinel int4s issued (CTA-uniform)
  {  // this CTA's share of the sentinel prefix and suffix: the edges now
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
  }
  merge_path<true>(rows, Q2, g, G, q, s_a, s_n, s_cur, s_end, p_lo, p_lb, p_f, sh, plane_rows, plane_scores, sh_fill,
                   fcur);
  __syncthreads();
  // the row tiles over the CTA's rows [x_lo, x_hi) from `done` real postings on: each
  // tile's postings summed into acc / cnt in slot order, then the plane's posting
  // positions written (sentinel stores riding along)
  const int x_lo = sh.x_lo, x_hi = sh.x_hi, nterm = q.nterm;
  int done = sh.done;
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
        fill_rounds(out_rows + plane0, out_scores + plane0, sh_fill, fcur, FILL_STEP);
        __syncthreads();
      }
    }
    block_scan<PER_THREAD>(cnt, width, warp_tot);
    const int base = n_neg + done;  // plane position of the tile's first posting

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
    for (int s = tid; s < Q2; s += THREADS) s_cur[s] = s_hi[s];
    done += tile_total;
    __syncthreads();
  }
  fill_rounds(plane_rows, plane_scores, sh_fill, fcur, INT_MAX);  // what the walk left
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src)
               : "memory");
}

// the next window's share of each slot (warp 0): of TW postings, what each slot has
// left in proportion to the CTA's total left, at least one while it has any, into
// w[0..Q2) and their exclusive prefix wo[0..Q2]
__device__ void plan_window(const int* s_cur, const int* s_end, int* w, int* wo, int Q2) {
  const int lane = threadIdx.x & 31;
  int left = 0;
  for (int s = lane; s < Q2; s += 32) left += s_end[s] - s_cur[s];
  left = __reduce_add_sync(FULL, left);
  int carry = 0;
  for (int s0 = 0; s0 < Q2; s0 += 32) {
    const int s = s0 + lane;
    int n = 0;
    if (s < Q2) {
      const int rem = s_end[s] - s_cur[s];
      n = rem > 0 ? min(rem, 1 + (int)((long long)(TW - Q2) * rem / left)) : 0;
      w[s] = n;
    }
    int tot;
    const int e = warp_excl(n, tot);
    if (s < Q2) wo[s] = carry + e;
    carry += tot;
  }
  if (lane == 0) wo[Q2] = carry;
}

// the window's postings [s_cur, s_cur + w) of each slot into wr / ww at wo, copies in flight
__device__ __forceinline__ void issue_window(const int32_t* rows, const float* wnorm, int* wr, float* ww,
                                             const int* s_cur, const int* wo, int Q2) {
  const int W = wo[Q2];
#pragma unroll
  for (int k = 0; k < IW; ++k) {
    const int f = threadIdx.x + k * THREADS;
    if (f >= W) break;
    const int s = slot_of(wo, Q2, f);
    const int i = s_cur[s] + (f - wo[s]);
    cp_async4(wr + f, rows + i);
    cp_async4(ww + f, wnorm + i);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// entries <= x in a[0..n) (a ascending)
__device__ __forceinline__ int count_le(const int* a, int n, int x) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] <= x) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS, 1)
k8_candidates_sel(const int32_t* __restrict__ term_ids, const int32_t* __restrict__ offsets,
                  const float* __restrict__ idf, const int32_t* __restrict__ rows,
                  const float* __restrict__ wnorm, int32_t* __restrict__ out_rows, int32_t* __restrict__ out_keys,
                  int32_t* __restrict__ part, int32_t* __restrict__ tickets, int Q, int Q2, int W2, int mode,
                  int sel, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  int* win_row = reinterpret_cast<int*>(smem);                  // [2][TW] the windows' rows
  float* win_w = reinterpret_cast<float*>(win_row + 2 * TW);    // [2][TW] their weights
  int* bkt = reinterpret_cast<int*>(win_w + 2 * TW);            // [NB] bucket counts, then their inclusive scan
  int* tmp = bkt + NB;                                          // [TW] window indices by bucket, then keys
  int* srt_row = tmp + TW;                                      // [TW] the ready postings in (row, slot) order
  float* srt_val = reinterpret_cast<float*>(srt_row + TW);      // [TW] their idf * weight
  int* s_a = reinterpret_cast<int*>(srt_val + TW);              // [Q2] first posting of each slot's window
  int* s_n = s_a + Q2;                                          // [Q2] postings the window holds
  float* s_idf = reinterpret_cast<float*>(s_n + Q2);            // [Q2]
  int* s_cur = reinterpret_cast<int*>(s_idf + Q2);              // [Q2] first posting past the windows read
  int* s_end = s_cur + Q2;                                      // [Q2] end of the CTA's range
  int* s_pre = s_end + Q2;                                      // [Q2 + 1] ready postings before each slot
  int* s_w = s_pre + Q2 + 1;                                    // [2][Q2] each window's postings a slot
  int* s_wo = s_w + 2 * Q2;                                     // [2][Q2 + 1] their exclusive prefix
  int* p_lo = s_wo + 2 * (Q2 + 1);                              // the search's arrays, as the tile walk's
  const int nc = search_cands(Q2);
  int* p_lb = p_lo + 4 * Q2;
  int* p_f = p_lb + 2 * nc * Q2;
  __shared__ int warp_tot[WARPS];
  __shared__ Query q;
  __shared__ Search sh;
  __shared__ int sh_m0, sh_hi, sh_last;

  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  query_setup(term_ids, offsets, idf, rows, b, Q, Q2, W2, s_a, s_n, s_idf, q);
  const int nterm = q.nterm, P = q.p;
  const int n = P > 0 ? (int)min((long long)G, ((long long)P + WALK_MIN - 1) / WALK_MIN) : 1;  // CTAs it takes
  if (g >= n) return;
  int fcur = 0;
  merge_path<false>(rows, Q2, g, n, q, s_a, s_n, s_cur, s_end, p_lo, p_lb, p_f, sh, nullptr, nullptr, nullptr, fcur);
  __syncthreads();
  int tops[SEL_MAX], pays[SEL_MAX];  // slot position p = tid
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    tops[l] = EMPTY;
    pays[l] = -1;
  }
  // the postings in merge order, in windows
  for (int i = tid; i < NB; i += THREADS) bkt[i] = 0;
  if (warp == 0) plan_window(s_cur, s_end, s_w, s_wo, Q2);
  __syncthreads();
  issue_window(rows, wnorm, win_row, win_w, s_cur, s_wo, Q2);
  int base = q.neg + sh.done;  // plane position of the window's first ready posting
  for (int cb = 0;; cb ^= 1) {
    const int nb = cb ^ 1;
    int* const wr = win_row + cb * TW;
    const float* const ww = win_w + cb * TW;
    const int* const w = s_w + cb * Q2;
    const int* const wo = s_wo + cb * (Q2 + 1);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (wo[Q2] == 0) break;  // nothing left
    // warp 0: the window's bound, each slot's ready postings, the next window
    if (warp == 0) {
      int m = INT_MAX, mx = -1, m0 = INT_MAX;
      for (int s = lane; s < Q2; s += 32) {
        if (w[s] > 0) {
          const int last = wr[wo[s] + w[s] - 1];
          m0 = min(m0, wr[wo[s]]);
          mx = max(mx, last);
          if (s_cur[s] + w[s] < s_end[s]) m = min(m, last);  // postings past its window
        }
      }
      const int hi = min(__reduce_min_sync(FULL, m), __reduce_max_sync(FULL, mx));
      m0 = __reduce_min_sync(FULL, m0);
      int carry = 0;
      for (int s0 = 0; s0 < Q2; s0 += 32) {
        const int s = s0 + lane;
        int r = 0;
        if (s < Q2) {
          r = w[s] > 0 ? count_le(wr + wo[s], w[s], hi) : 0;
          s_cur[s] += r;
        }
        int tot;
        const int e = warp_excl(r, tot);
        if (s < Q2) s_pre[s] = carry + e;
        carry += tot;
      }
      __syncwarp();
      plan_window(s_cur, s_end, s_w + nb * Q2, s_wo + nb * (Q2 + 1), Q2);
      if (lane == 0) {
        s_pre[Q2] = carry;
        sh_m0 = m0;
        sh_hi = hi;
      }
    }
    __syncthreads();
    issue_window(rows, wnorm, win_row + nb * TW, win_w + nb * TW, s_cur, s_wo + nb * (Q2 + 1), Q2);
    const int R = s_pre[Q2], m0 = sh_m0;
    if (R == 0) break;  // only on slices out of row order: the limiting slot's window is ready
    int shift = 0;
    while (((sh_hi - m0) >> shift) >= NB) ++shift;
    // counting sort of the ready postings by (row, slot): bucket counts, ...
    int it_e[IW], it_s[IW], it_b[IW], it_l[IW];
#pragma unroll
    for (int i = 0; i < IW; ++i) {
      const int k = tid + i * THREADS;
      it_b[i] = -1;
      if (k < R) {
        const int s = slot_of(s_pre, Q2, k);
        it_s[i] = s;
        it_e[i] = wo[s] + (k - s_pre[s]);
        it_b[i] = (wr[it_e[i]] - m0) >> shift;
        it_l[i] = atomicAdd(&bkt[it_b[i]], 1);
      }
    }
    __syncthreads();
    block_scan<NB / THREADS>(bkt, NB, warp_tot);
    // ... window indices scattered by bucket, ...
#pragma unroll
    for (int i = 0; i < IW; ++i)
      if (it_b[i] >= 0) tmp[(it_b[i] ? bkt[it_b[i] - 1] : 0) + it_l[i]] = it_e[i];
    __syncthreads();
    // ... each posting's rank among its bucket's (window index order is slot order)
#pragma unroll
    for (int i = 0; i < IW; ++i) {
      if (it_b[i] < 0) continue;
      const int e = it_e[i], row = wr[e];
      const int lo = it_b[i] ? bkt[it_b[i] - 1] : 0, hi = bkt[it_b[i]];
      int rank = lo;
      if (hi - lo > 1)
        for (int v = lo; v < hi; ++v) {
          const int ev = tmp[v], rv = wr[ev];
          rank += rv < row || (rv == row && ev < e);
        }
      srt_row[rank] = row;
      srt_val[rank] = __fmul_rn(s_idf[it_s[i]], ww[e]);
    }
    __syncthreads();
    // leaders: the last of each run sums it in slot order and keys its position
#pragma unroll
    for (int i = 0; i < IW; ++i) {
      const int j = tid + i * THREADS;
      if (j >= R) break;
      const int row = srt_row[j];
      int key = EMPTY;
      if (j == R - 1 || srt_row[j + 1] != row) {
        int j0 = j;
        while (j0 > 0 && srt_row[j0 - 1] == row) --j0;
        float sum = 0.f;
        for (int t = j0; t <= j; ++t) sum = __fadd_rn(sum, srt_val[t]);
        const int c = j - j0 + 1;
        if (sum > 0.f && (mode != MODE_ALL || c >= nterm)) {
          const int pos = base + j;
          key = sel_key(mode == MODE_COUNT ? __fadd_rn(sum, 4096.f * (float)c) : sum, pos / PK);
        }
      }
      tmp[j] = key;
    }
#pragma unroll
    for (int i = 0; i < NB / THREADS; ++i) bkt[tid + i * THREADS] = 0;
    __syncthreads();
    // thread p takes the window's positions at slot position p
    const int j0 = (tid - base % PK + PK) % PK;
#pragma unroll
    for (int i = 0; i < IW; ++i) {
      const int j = j0 + i * PK;
      if (j >= R) break;
      const int key = tmp[j];
      if (key != EMPTY) insert_top(tops, pays, sel, key, srt_row[j]);
    }
    base += R;
  }

  if (n == 1) {
    finish_list(tops, pays, sel);
    const size_t o = (size_t)b * sel * PK;
#pragma unroll
    for (int l = 0; l < SEL_MAX; ++l) {
      if (l < sel) {
        out_keys[o + (size_t)l * PK + tid] = tops[l];
        out_rows[o + (size_t)l * PK + tid] = pays[l];
      }
    }
    return;
  }
  // this CTA's live lists [sel keys][sel rows] x PK to the scratch, then the last CTA
  // of the query merges the n lists
  const size_t o = ((size_t)b * G + g) * sel * PK * 2;
#pragma unroll
  for (int l = 0; l < SEL_MAX; ++l) {
    if (l < sel) {
      part[o + (size_t)l * PK + tid] = tops[l];
      part[o + (size_t)(sel + l) * PK + tid] = pays[l];
    }
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) sh_last = atomicAdd(&tickets[b], 1) == n - 1;
  __syncthreads();
  if (!sh_last) return;
  __threadfence();
  merge_lists(part, out_rows, out_keys, b, G, n, sel);
  if (tid == 0) tickets[b] = 0;  // for the next launch
}

// G CTAs a query. sel = 0: enough for B * G to fill every SM's CTA slots, within one
// chunk of the plane a CTA and G_MAX. sel > 0: enough for a query of Q2 slices of W2 / 2
// postings at WALK_MIN a CTA, within G_MAX and PART_BYTES of the merge's scratch
int plan_g(int B, int Q2, int W2, int sel, int sms, int per_sm) {
  long long g;
  if (sel) {
    g = ((long long)Q2 * (W2 / 2) + WALK_MIN - 1) / WALK_MIN;
    const long long cap = PART_BYTES / ((long long)B * 2 * sel * PK * 4);
    g = g < cap ? g : cap;
  } else {
    const long long slots = (long long)sms * per_sm;
    g = B >= slots ? 1 : (slots + B - 1) / B;
    g = g < (long long)Q2 * W2 / PK ? g : (long long)Q2 * W2 / PK;
  }
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
// sel = 0 (row tiles, `k8_candidates`): out_rows [B, Q2*W2] i32, out_scores [B,
// Q2*W2] f32, out_keys, part and tickets unused; sel > 0 (the selection,
// `k8_candidates_sel`): out_rows and out_keys [B, sel*1024] i32, out_scores unused, and
// at G > 1 part [B, G, 2, sel, 1024] i32 scratch and tickets [B] i32 at zero (left at
// zero). Returns a cudaError_t (0 = launched).
int wax_k8_candidates(const int32_t* term_ids, const int32_t* offsets, const float* idf,
                      const int32_t* rows, const float* wnorm, int32_t* out_rows, float* out_scores,
                      int32_t* out_keys, int32_t* part, int32_t* tickets, int B, int Q, int Q2, int W2, int mode,
                      int sel, int G, cudaStream_t stream) {
  if (G < 1 || G > G_MAX) return (int)cudaErrorInvalidValue;
  cudaError_t e;
  if (sel) {
    const size_t smem = sel_smem_bytes(Q2);
    e = cudaFuncSetAttribute(k8_candidates_sel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    k8_candidates_sel<<<dim3(B, G), THREADS, smem, stream>>>(term_ids, offsets, idf, rows, wnorm, out_rows,
                                                              out_keys, part, tickets, Q, Q2, W2, mode, sel, G);
  } else {
    const size_t smem = smem_bytes(Q2);
    e = cudaFuncSetAttribute(k8_candidates, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    k8_candidates<<<dim3(B, G), THREADS, smem, stream>>>(term_ids, offsets, idf, rows, wnorm, out_rows, out_scores,
                                                         Q, Q2, W2, mode, G);
  }
  return (int)cudaGetLastError();
}

// K8's launch for B queries of Q2 slots x W2 at `sel`: out = [G, threads, rows a tile
// (sel 0) or postings a window (sel > 0), CTAs an SM holds, the device's SMs, dynamic
// shared memory bytes]. Launches nothing.
int wax_k8_plan(int B, int Q2, int W2, int sel, int* out) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const size_t smem = sel ? sel_smem_bytes(Q2) : smem_bytes(Q2);
  const void* kernel = sel ? (const void*)k8_candidates_sel : (const void*)k8_candidates;
  if (e == cudaSuccess) e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  out[0] = plan_g(B, Q2, W2, sel, sms, per_sm);
  out[1] = THREADS;
  out[2] = sel ? TW : TILE;
  out[3] = per_sm;
  out[4] = sms;
  out[5] = (int)smem;
  return (int)e;
}

}  // extern "C"
