// Exact BM25 rescore of candidate rows against the forward index for Hopper (sm_90a):
// kernel K3 (fused index) and kernel K5 (separate arrays), one templated body.
//
// `wax_k3_rescore_fused` replaces the TPU kernel wax_tpu/ops/bm25_rescore.py
// `_rescore_fused_kernel` (entry `_rescore_fused_blocks`, via `exact_rescore_fused`).
// Each forward row is [tids (L2 lanes, -1 pad) | f32 weight bits (L2 lanes)]. For query
// b and candidate row r = cand[b, f] (-1 dead) it returns
//     score = sum over query slots j = 0, 1, ..., Q-1 (in that order) of
//             w_l * idf[b, j] for the live lane l whose tid_l == tids[b, j] (>= 0)
//     count = the number of (l, j) matches,
// 0 / 0 for dead candidates. `wax_k5_rescore_split` replaces `_rescore_kernel` (entry
// `_rescore_blocks`, via `exact_rescore`): the same over the two arrays `fwd_tids` /
// `fwd_wnorm` [N, L], read over their first `width` lanes.
//
// Liveness: a K3 lane is live when its tid is >= 0 (a zero weight still counts); a K5
// lane when its tid is >= 0 and its weight > 0 (the TPU kernel's rule for tombstoned
// rows). Invariant of a valid forward index: a row holds each term at most once among
// its live lanes, in any lane layout (left-packed or with holes). So at most one lane
// matches a query slot, every product is one `__fmul_rn` and the slots are added in slot
// order with `__fadd_rn`: the plain twin adds in the same order, so the two agree bit
// for bit on any data, and K5 over every lane equals K3. A query that repeats a term
// matches it in several slots; `count` counts (lane, slot) pairs. (The TPU kernel sums
// per lane, then across lanes; its results differ in the last bits.)
//
// Design, `rescore<SPLIT, NL, CPW>`: CPW candidates per warp, S = 32 / CPW lanes per
// candidate, each thread holding NL register groups (group i = lanes sub + S * i), NL
// fixed at compile time (the row width over S, rounded up to a power of two; groups past
// the width are never loaded). A CTA serves CTA_CANDS candidates of one query: it stages
// the query's slots once, with a copy sorted by (tid, slot). Each warp walks its
// candidates in rounds of CPW, with the next round's tid loads issued before the current
// round is matched. Per round:
//   1. a register group that no lane of the warp holds live is skipped (a warp vote:
//      right on any layout, and on the left-packed rows of the snapshots most of a
//      row's later groups);
//   2. each live lane looks its tid up in the sorted slots (binary search) and loads
//      its weight only where it matched, so the sectors of dead and unmatched weights
//      are never fetched;
//   3. a matched lane writes __fmul_rn(w, idf[j]) into its candidate's product row
//      p[j] and sets bit j of the candidate's hit mask; one lane per candidate then
//      adds the marked slots in slot order.
// No loop runs over a width known only at run time, and no warp-wide round runs per
// query slot.
//
// What bounds it: the gathered rows, every lane of every row read once, B * F * 2 * L2
// * 4 bytes (at B 256, F 256, L2 128: 67 MB, 0.02 ms at 3.35 TB/s). The kernel reads
// fewer: the tid lanes of each row and the sectors of its matched weights.
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int QMAX = 128;
constexpr unsigned FULL = 0xFFFFFFFFu;
// The launch sizes (scripts/k3_k5_variants.py measures others by editing these lines):
constexpr int CTA_CANDS = 64;  // candidates of one query per CTA
constexpr int CTA_WARPS = 8;   // warps per CTA (fewer where CTA_CANDS / CPW is smaller)
constexpr int CPW2_MAX = 128;  // two candidates a warp at widths up to this, else one

__host__ __device__ constexpr int warps_for(int cpw) { return CTA_CANDS / cpw < CTA_WARPS ? CTA_CANDS / cpw : CTA_WARPS; }

__host__ __device__ constexpr int pow2_at_least(int x) {
  int p = 1;
  while (p < x) p *= 2;
  return p;
}

struct Plan {
  int nl, cpw;
};

// The launch choice for rows read over `width` lanes (<= 512): two candidates per warp
// at widths up to CPW2_MAX, else one; NL register groups cover the width.
__host__ __device__ inline Plan plan_for(int width) {
  const int cpw = width <= CPW2_MAX ? 2 : 1;
  return {pow2_at_least((width + 32 / cpw - 1) / (32 / cpw)), cpw};
}

struct Args {
  const int32_t* tsrc;  // tid lanes of row r at tsrc + r * stride
  const float* wsrc;    // weight lanes of row r at wsrc + r * stride
  int stride, width;    // lanes per row in memory; lanes read
  const int32_t* cand;  // [B, F]
  const int32_t* tids;  // [B, Q]
  const float* idf;     // [B, Q]
  float* scores;        // [B, F]
  int32_t* counts;      // [B, F]
  int F, Q;
};

template <int NL, int S>
__device__ __forceinline__ void load_tids(const Args& a, int row, int sub, int (&t)[NL]) {
  const int32_t* p = a.tsrc + (size_t)(row < 0 ? 0 : row) * a.stride + sub;
#pragma unroll
  for (int i = 0; i < NL; ++i) t[i] = row >= 0 && i * S < a.width ? __ldg(p + S * i) : -1;
}

template <bool SPLIT, int NL, int CPW>
__device__ __forceinline__ void rescore(const Args& a) {
  constexpr int S = 32 / CPW;  // lanes per candidate
  constexpr int WARPS = warps_for(CPW);
  constexpr int PER_WARP = CTA_CANDS / WARPS;  // candidates a warp serves
  constexpr int RPW = PER_WARP / CPW;          // its rounds
  static_assert(PER_WARP <= 32 && PER_WARP % CPW == 0, "a warp's candidate rows sit in its lanes");
  __shared__ int32_t qt[QMAX];  // the query's slots, in slot order
  __shared__ float qi[QMAX];
  __shared__ int32_t st[QMAX];  // the live slots sorted by (tid, slot), INT_MAX pads
  __shared__ int32_t sj[QMAX];  // their slot indices
  __shared__ int nv_s;
  __shared__ float pr[WARPS * CPW][QMAX];          // product rows, one per candidate in flight
  __shared__ unsigned hm[WARPS * CPW][QMAX / 32];  // their hit masks
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c = lane / S, sub = lane % S, Q = a.Q;

  if (tid == 0) nv_s = 0;
  for (int j = tid; j < WARPS * CPW * (QMAX / 32); j += WARPS * 32) (&hm[0][0])[j] = 0;
  for (int j = tid; j < Q; j += WARPS * 32) {
    qt[j] = __ldg(a.tids + (size_t)b * Q + j);
    qi[j] = __ldg(a.idf + (size_t)b * Q + j);
  }
  __syncthreads();
  for (int j = tid; j < Q; j += WARPS * 32) {
    const int v = qt[j];
    if (v >= 0) {
      int r = 0;
      for (int k = 0; k < Q; ++k) {
        const int u = qt[k];
        r += u >= 0 && (u < v || (u == v && k < j));
      }
      st[r] = v;
      sj[r] = j;
      atomicAdd(&nv_s, 1);
    }
  }
  __syncthreads();
  const int nv = nv_s;
  const int qp = pow2_at_least(nv);
  for (int r = nv + tid; r < qp; r += WARPS * 32) st[r] = INT_MAX;
  __syncthreads();

  const int f_warp = blockIdx.x * CTA_CANDS + warp * PER_WARP;
  // lane l holds the row of the warp's candidate l (-1: dead, past F, or no live slot)
  const int crow = lane < PER_WARP && f_warp + lane < a.F && nv > 0 ? __ldg(a.cand + (size_t)b * a.F + f_warp + lane)
                                                                     : -1;
  float* prc = pr[warp * CPW + c];
  unsigned* hmc = hm[warp * CPW + c];
  int tn[NL];
  int rown = __shfl_sync(FULL, crow, c);
  load_tids<NL, S>(a, rown, sub, tn);
#pragma unroll 1
  for (int r = 0; r < RPW; ++r) {
    const int row = rown;
    int t[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) t[i] = tn[i];
    if (r + 1 < RPW) {  // the next round's tids, in flight while this one is matched
      rown = __shfl_sync(FULL, crow, (r + 1) * CPW + c);
      load_tids<NL, S>(a, rown, sub, tn);
    }
    const float* wp = a.wsrc + (size_t)(row < 0 ? 0 : row) * a.stride + sub;
    float w[NL];
    unsigned gl = 0;  // the register groups some lane of the warp holds live (warp-uniform)
#pragma unroll
    for (int i = 0; i < NL; ++i)
      if (__any_sync(FULL, t[i] >= 0)) gl |= 1u << i;
    const int f = f_warp + r * CPW + c;
    // lo[i]: the first sorted slot holding t[i] (a lower bound over the padded slots), or -1
    int lo[NL];
#pragma unroll
    for (int i = 0; i < NL; ++i) lo[i] = 0;
    for (int step = qp >> 1; step > 0; step >>= 1) {
#pragma unroll
      for (int i = 0; i < NL; ++i)
        if ((gl >> i & 1) && st[lo[i] + step - 1] < t[i]) lo[i] += step;
    }
#pragma unroll
    for (int i = 0; i < NL; ++i) lo[i] = (gl >> i & 1) && t[i] >= 0 && lo[i] < nv && st[lo[i]] == t[i] ? lo[i] : -1;
#pragma unroll
    for (int i = 0; i < NL; ++i) w[i] = lo[i] >= 0 ? __ldg(wp + S * i) : 0.f;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (lo[i] >= 0 && (!SPLIT || w[i] > 0.f)) {
        for (int k = lo[i]; k < nv && st[k] == t[i]; ++k) {  // a repeated query term: each of its slots
          const int j = sj[k];
          prc[j] = __fmul_rn(w[i], qi[j]);
          atomicOr(&hmc[j >> 5], 1u << (j & 31));
        }
      }
    }
    __syncwarp();
    if (sub == 0) {  // the candidate's marked slots, in slot order
      float s = 0.f;
      int n = 0;
      for (int q = 0; q < (Q + 31) >> 5; ++q) {
        unsigned m = hmc[q];
        if (m) {
          hmc[q] = 0;
          n += __popc(m);
          do {
            s = __fadd_rn(s, prc[(q << 5) + __ffs(m) - 1]);
            m &= m - 1;
          } while (m);
        }
      }
      if (f < a.F) {
        a.scores[(size_t)b * a.F + f] = s;
        a.counts[(size_t)b * a.F + f] = n;
      }
    }
    __syncwarp();
  }
}

template <int NL, int CPW>
__global__ void __launch_bounds__(warps_for(CPW) * 32) k3_rescore_fused(const Args a) {
  rescore<false, NL, CPW>(a);
}

template <int NL, int CPW>
__global__ void __launch_bounds__(warps_for(CPW) * 32) k5_rescore_split(const Args a) {
  rescore<true, NL, CPW>(a);
}

template <bool SPLIT, int NL, int CPW>
auto kernel_of() {
  return SPLIT ? k5_rescore_split<NL, CPW> : k3_rescore_fused<NL, CPW>;
}

template <bool SPLIT, int CPW, typename Fn>
int with_kernel(int nl, Fn&& fn) {
  switch (nl) {
    case 1: return fn(kernel_of<SPLIT, 1, CPW>());
    case 2: return fn(kernel_of<SPLIT, 2, CPW>());
    case 4: return fn(kernel_of<SPLIT, 4, CPW>());
    case 8: return fn(kernel_of<SPLIT, 8, CPW>());
    case 16: return fn(kernel_of<SPLIT, 16, CPW>());
  }
  return (int)cudaErrorInvalidValue;
}

// fn(kernel) for the instance of plan p; returns fn's cudaError_t.
template <bool SPLIT, typename Fn>
int with_plan(const Plan& p, Fn&& fn) {
  switch (p.cpw) {
    case 1: return with_kernel<SPLIT, 1>(p.nl, fn);
    case 2: return with_kernel<SPLIT, 2>(p.nl, fn);
    case 4: return with_kernel<SPLIT, 4>(p.nl, fn);
  }
  return (int)cudaErrorInvalidValue;
}

template <bool SPLIT>
int launch(const Args& a, int B, cudaStream_t stream) {
  const Plan p = plan_for(a.width);
  const dim3 grid((a.F + CTA_CANDS - 1) / CTA_CANDS, B);
  return with_plan<SPLIT>(p, [&](auto kern) {
    kern<<<grid, warps_for(p.cpw) * 32, 0, stream>>>(a);
    return (int)cudaGetLastError();
  });
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: fused [N, 2*L2] i32 (L2 a multiple of
// 64, <= 512), cand [B, F] i32 (rows in [0, N) or -1), tids [B, Q] i32 (-1 pad), idf
// [B, Q] f32, Q <= 128; scores [B, F] f32 and counts [B, F] i32 out. Returns a
// cudaError_t (0 = launched).
int wax_k3_rescore_fused(const int32_t* fused, const int32_t* cand, const int32_t* tids,
                         const float* idf, float* scores, int32_t* counts, int B, int F, int Q,
                         int L2, cudaStream_t stream) {
  const Args a{fused, reinterpret_cast<const float*>(fused + L2), 2 * L2, L2, cand, tids, idf, scores, counts, F, Q};
  return launch<false>(a, B, stream);
}

// ftids [N, L] i32 and fwn [N, L] f32 (L a multiple of 32, <= 512), cand / tids / idf as
// for K3, width = 64 (the narrow form) or L: the lanes read. Returns a cudaError_t (0 =
// launched).
int wax_k5_rescore_split(const int32_t* ftids, const float* fwn, const int32_t* cand, const int32_t* tids,
                         const float* idf, float* scores, int32_t* counts, int B, int F, int Q, int L,
                         int width, cudaStream_t stream) {
  const Args a{ftids, fwn, L, width, cand, tids, idf, scores, counts, F, Q};
  return launch<true>(a, B, stream);
}

// How K3 (split = 0) or K5 (split = 1) launches for rows read over `width` lanes, B
// queries and F candidates: out = {NL register groups a thread, candidates per warp,
// candidates per CTA, threads per CTA, grid x, grid y, CTAs per SM}. Returns a
// cudaError_t.
int wax_k3k5_plan(int split, int width, int B, int F, int* out) {
  const Plan p = plan_for(width);
  int per_sm = 0;
  auto occ = [&](auto kern) {
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, warps_for(p.cpw) * 32, 0);
  };
  const int e = split ? with_plan<true>(p, occ) : with_plan<false>(p, occ);
  out[0] = p.nl;
  out[1] = p.cpw;
  out[2] = CTA_CANDS;
  out[3] = warps_for(p.cpw) * 32;
  out[4] = (F + CTA_CANDS - 1) / CTA_CANDS;
  out[5] = B;
  out[6] = per_sm;
  return e;
}

}  // extern "C"
