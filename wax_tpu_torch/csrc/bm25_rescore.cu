// Exact BM25 rescore of candidate rows against the forward index for Hopper (sm_90a):
// kernel K3 (fused index) and kernel K5 (separate arrays).
//
// `wax_k3_rescore_fused` replaces the TPU kernel wax_tpu/ops/bm25_rescore.py
// `_rescore_fused_kernel` (entry `_rescore_fused_blocks`, via `exact_rescore_fused`).
// Each forward row is [tids (L2 lanes, -1 pad) | f32 weight bits (L2 lanes)]. For query
// b and candidate row r = cand[b, f] (-1 dead) it returns
//     score = sum over query slots j = 0, 1, ..., Q-1 (in that order) of
//             w_l * idf[b, j] for the lane l whose tid_l == tids[b, j] (>= 0)
//     count = the number of (l, j) matches,
// 0 / 0 for dead candidates. A forward row holds each term once, so at most one lane
// matches a slot, and the sum runs in slot order whatever the row's layout: the plain
// twin adds in the same order, so the two agree bit for bit on any data. (The TPU
// kernel sums per lane, then across lanes; its results differ in the last bits.)
//
// Design: one warp per candidate. Each lane loads its tid lanes l = lane, lane+32, ...
// and their weights into registers with coalesced 4-byte loads; for each query slot,
// held in shared memory, the warp ballots the lanes that match, broadcasts the matching
// lane's product and every lane adds it to the running score, so no reduction is
// needed at the end. A CTA of 8 warps serves 8 candidates of one query, so the slots
// are staged once per CTA.
//
// What bounds it: the gathered rows, B * F * 2 * L2 * 4 bytes (at B 256, F 256,
// L2 128: 67 MB, 0.02 ms at 3.35 TB/s). Each row is a separate 1 KB gather, so in
// practice the row-gather latency, not the bytes, sets its time.
//
// `wax_k5_rescore_split` (kernel K5) replaces wax_tpu/ops/bm25_rescore.py
// `_rescore_kernel` (entry `_rescore_blocks`, via `exact_rescore`): the same
// arithmetic over the separate `fwd_tids` / `fwd_wnorm` arrays. Its bound is the same
// gather, now two rows per candidate (B * F * 2 * width * 4 bytes); the narrow form
// reads only the first 64 lanes when the forward width allows, which halves the
// bytes of a 128-wide index, and puts two candidates in one warp.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int QMAX = 128;
constexpr int LMAX = 16;  // tid lanes per thread: L2 <= 512 (the forward width cap)
constexpr unsigned FULL = 0xFFFFFFFFu;

__global__ void __launch_bounds__(THREADS)
k3_rescore_fused(const int32_t* __restrict__ fused, const int32_t* __restrict__ cand,
                 const int32_t* __restrict__ tids, const float* __restrict__ idf,
                 float* __restrict__ scores, int32_t* __restrict__ counts, int F, int Q, int L2) {
  __shared__ int32_t qt[QMAX];
  __shared__ float qi[QMAX];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < Q; j += THREADS) {
    qt[j] = tids[(size_t)b * Q + j];
    qi[j] = idf[(size_t)b * Q + j];
  }
  __syncthreads();
  const int f = blockIdx.x * WARPS + warp;
  if (f >= F) return;  // warp-uniform
  const int row = cand[(size_t)b * F + f];
  float s = 0.f;
  int c = 0;
  if (row >= 0) {  // warp-uniform
    const int32_t* fr = fused + (size_t)row * 2 * L2;
    const int nl = L2 / 32;
    int t[LMAX];
    float w[LMAX];
#pragma unroll
    for (int i = 0; i < LMAX; ++i) {
      t[i] = i < nl ? fr[lane + 32 * i] : -1;
      w[i] = i < nl ? __int_as_float(fr[L2 + lane + 32 * i]) : 0.f;
    }
    for (int j = 0; j < Q; ++j) {
      const int qtj = qt[j];
      if (qtj < 0) continue;  // uniform: every lane reads the same slot
      bool hit = false;
      float prod = 0.f;
#pragma unroll
      for (int i = 0; i < LMAX; ++i) {
        if (t[i] == qtj) {
          hit = true;
          prod = __fmul_rn(w[i], qi[j]);
        }
      }
      unsigned bal = __ballot_sync(FULL, hit);
      c += __popc(bal);
      while (bal) {  // ascending lane order; one lane unless a row repeats a term
        const int src = __ffs(bal) - 1;
        s = __fadd_rn(s, __shfl_sync(FULL, prod, src));
        bal &= bal - 1;
      }
    }
  }
  if (lane == 0) {
    scores[(size_t)b * F + f] = s;
    counts[(size_t)b * F + f] = c;
  }
}

// K5: the same rescore against the two separate forward arrays, tids [N, L] i32 and
// wnorm [N, L] f32, reading the first `width` lanes of each row. A lane matches a slot
// when its tid equals the slot's and its weight is > 0 (the TPU kernel's liveness).
// SUB threads serve one candidate: 32 (a warp) in the wide form, 16 in the narrow
// form (width <= 64), where one warp serves two candidates of the same query, as the
// TPU packs two candidates into one 128-lane row. The slots are added in slot order
// as in K3, so K5 equals K3 bit for bit on the same data.
template <int SUB>
__global__ void __launch_bounds__(THREADS)
k5_rescore_split(const int32_t* __restrict__ ftids, const float* __restrict__ fwn,
                 const int32_t* __restrict__ cand, const int32_t* __restrict__ tids,
                 const float* __restrict__ idf, float* __restrict__ scores,
                 int32_t* __restrict__ counts, int F, int Q, int L, int width) {
  constexpr int PER_WARP = 32 / SUB;
  constexpr int NL = SUB == 16 ? 64 / 16 : 512 / 32;  // lanes per thread: width 64, or the cap
  __shared__ int32_t qt[QMAX];
  __shared__ float qi[QMAX];
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int j = tid; j < Q; j += THREADS) {
    qt[j] = tids[(size_t)b * Q + j];
    qi[j] = idf[(size_t)b * Q + j];
  }
  __syncthreads();
  const int sub = lane % SUB, half = lane / SUB;
  const int f0 = (blockIdx.x * WARPS + warp) * PER_WARP;
  if (f0 >= F) return;  // warp-uniform
  const int f = f0 + half;
  const int row = f < F ? cand[(size_t)b * F + f] : -1;
  const unsigned mine_mask = SUB == 32 ? FULL : (0xFFFFu << (half * 16));
  const int nl = width / SUB;
  int t[NL];
  float w[NL];
#pragma unroll
  for (int i = 0; i < NL; ++i) {
    const bool in = row >= 0 && i < nl;
    t[i] = in ? ftids[(size_t)row * L + sub + SUB * i] : -1;
    w[i] = in ? fwn[(size_t)row * L + sub + SUB * i] : 0.f;
  }
  float s = 0.f;
  int c = 0;
  for (int j = 0; j < Q; ++j) {
    const int qtj = qt[j];
    if (qtj < 0) continue;  // uniform: every lane reads the same slot
    bool hit = false;
    float prod = 0.f;
#pragma unroll
    for (int i = 0; i < NL; ++i) {
      if (t[i] == qtj && w[i] > 0.f) {
        hit = true;
        prod = __fmul_rn(w[i], qi[j]);
      }
    }
    unsigned mine = __ballot_sync(FULL, hit) & mine_mask;
    c += __popc(mine);
    int n = __popc(mine);
    if (SUB < 32) n = max(n, __shfl_xor_sync(FULL, n, 16));
    for (int it = 0; it < n; ++it) {  // ascending lane order within the candidate
      const int src = mine ? __ffs(mine) - 1 : lane;
      const float v = __shfl_sync(FULL, prod, src);
      if (mine) {
        s = __fadd_rn(s, v);
        mine &= mine - 1;
      }
    }
  }
  if (sub == 0 && f < F) {
    scores[(size_t)b * F + f] = s;
    counts[(size_t)b * F + f] = c;
  }
}

}  // namespace

extern "C" {

// Arguments are validated by the Python wrapper: fused [N, 2*L2] i32, cand [B, F] i32
// (rows in [0, N) or -1), tids [B, Q] i32 (-1 pad), idf [B, Q] f32, Q <= 128; scores
// [B, F] f32 and counts [B, F] i32 out. Returns a cudaError_t (0 = launched).
int wax_k3_rescore_fused(const int32_t* fused, const int32_t* cand, const int32_t* tids,
                         const float* idf, float* scores, int32_t* counts, int B, int F, int Q,
                         int L2, cudaStream_t stream) {
  const dim3 grid((F + WARPS - 1) / WARPS, B);
  k3_rescore_fused<<<grid, THREADS, 0, stream>>>(fused, cand, tids, idf, scores, counts, F, Q, L2);
  return (int)cudaGetLastError();
}

// ftids [N, L] i32 and fwn [N, L] f32 (L a multiple of 32, <= 512), cand / tids / idf as
// for K3, width = 64 (the narrow form: two candidates per warp) or L. Returns a
// cudaError_t (0 = launched).
int wax_k5_rescore_split(const int32_t* ftids, const float* fwn, const int32_t* cand, const int32_t* tids,
                         const float* idf, float* scores, int32_t* counts, int B, int F, int Q, int L,
                         int width, cudaStream_t stream) {
  if (width == 64) {
    const dim3 grid((F + 2 * WARPS - 1) / (2 * WARPS), B);
    k5_rescore_split<16><<<grid, THREADS, 0, stream>>>(ftids, fwn, cand, tids, idf, scores, counts, F, Q, L,
                                                        width);
  } else {
    const dim3 grid((F + WARPS - 1) / WARPS, B);
    k5_rescore_split<32><<<grid, THREADS, 0, stream>>>(ftids, fwn, cand, tids, idf, scores, counts, F, Q, L,
                                                        width);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
