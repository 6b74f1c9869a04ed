// Packed score keys and the sorted per-query candidate lists shared by the flat-scan
// kernels (K1 and K2 in flat_scan.cu, K9 in packed_topk.cu).
#pragma once
#include <cuda_runtime.h>
#include <limits.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;

// The TPU backend's packed i32 key: sortable score bits with the low 11 bits replaced
// by (2047 - column within the tile). Unique within a tile; ties to the lowest column.
struct PackedKey {
  using T = int;
  static __device__ __forceinline__ T sentinel() { return INT_MIN; }
  static __device__ __forceinline__ T make(float s, int col) {
    int bits = __float_as_int(s);
    int key = bits >= 0 ? bits : ((~bits) ^ INT_MIN);
    return (key & ~0x7FF) | (0x7FF - col);
  }
};

// 128 keys held 4 per lane (element i = t * 32 + lane in v[t]) sorted descending by a
// bitonic network: shuffles across lanes, register swaps across the four rows.
template <typename KT>
__device__ __forceinline__ void cmp_swap_rows(KT (&v)[4], int tj, int k, int lane) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (t & tj) continue;  // the pair (t, t | tj), lower index first
    const bool desc = ((t * 32 + lane) & k) == 0;
    const KT a = v[t], b = v[t | tj];
    v[t] = (a > b) == desc ? a : b;
    v[t | tj] = (a > b) == desc ? b : a;
  }
}

template <typename KT>
__device__ __forceinline__ void cmp_swap_lanes(KT (&v)[4], int j, int k, int lane) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const KT w = __shfl_xor_sync(FULL, v[t], j);
    const bool keep_max = ((lane & j) == 0) == (((t * 32 + lane) & k) == 0);
    v[t] = (v[t] > w) == keep_max ? v[t] : w;
  }
}

template <typename KT>
__device__ __forceinline__ void sort128_desc(KT (&v)[4], int lane) {
#pragma unroll
  for (int k = 2; k <= 128; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      if (j >= 32) cmp_swap_rows(v, j >> 5, k, lane);
      else cmp_swap_lanes(v, j, k, lane);
    }
}

// lv (descending) := the 128 largest of lv and s (both descending), descending: the
// element-wise max of lv and s reversed holds them as a bitonic sequence, which a
// bitonic merge sorts.
template <typename KT>
__device__ __forceinline__ void merge128_desc(KT (&lv)[4], const KT (&s)[4], int lane) {
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const KT r = __shfl_sync(FULL, s[3 - t], 31 - lane);
    lv[t] = lv[t] > r ? lv[t] : r;
  }
  cmp_swap_rows(lv, 2, 128, lane);
  cmp_swap_rows(lv, 1, 128, lane);
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) cmp_swap_lanes(lv, j, 128, lane);
}

// lv (32 keys, descending across lanes) := the 32 largest of lv and w (both descending).
template <typename KT>
__device__ __forceinline__ void merge32_desc(KT& lv, KT w, int lane) {
  const KT r = __shfl_sync(FULL, w, 31 - lane);
  lv = lv > r ? lv : r;
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
    const KT o = __shfl_xor_sync(FULL, lv, j);
    lv = (lv > o) == ((lane & j) == 0) ? lv : o;
  }
}

// 32 keys, one per lane, sorted descending across lanes (bitonic).
template <typename KT>
__device__ __forceinline__ void sort32_desc(KT& w, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const KT o = __shfl_xor_sync(FULL, w, j);
      w = (w > o) == (((lane & j) == 0) == ((lane & k) == 0)) ? w : o;
    }
}

// The position of the i-th (from 0) set bit of m; i < popc(m).
__device__ __forceinline__ int nth_set_bit(unsigned m, int i) {
  int pos = 0;
#pragma unroll
  for (int sh = 16; sh > 0; sh >>= 1) {
    const unsigned low = m & ((1u << sh) - 1u);
    const int c = __popc(low);
    if (i >= c) {
      i -= c;
      m >>= sh;
      pos += sh;
    } else {
      m = low;
    }
  }
  return pos;
}

// One warp merges rows r0 .. r0 + nr of a block of scores sc[row * ld + col] (128
// columns, which are tile columns c0 ..) into the rows' sorted lists lists[row * KP ..],
// each row's list held in registers while the warp merges the block into it (lane l
// keeps list positions l, l + 32, ...; KP <= 128, kept sorted over all KP positions,
// those from K on with no promise). Keys are unique within a tile, so the lists are the
// exact top-k whatever order the blocks arrive in.
// The few keys that beat the k-th are inserted one at a time (a ballot count and a
// one-position shuffle of the tail); when more than SERIAL_MAX do, as in a tile's
// first blocks, the block's 128 keys are sorted and merged with the list in one
// bitonic pass instead. With SORT_WINNERS, when 32 or fewer keys win they are gathered
// one per lane, sorted and merged, and lists of 32 (K <= 32) merge as one register row:
// a third to a quarter of the shuffles of the 128-key sort.
constexpr int SERIAL_MAX = 3;

template <typename Key, bool SORT_WINNERS = false>
__device__ __forceinline__ void merge_rows(const float* sc, int ld, typename Key::T* lists, int KP, int K, int r0,
                                           int nr, int c0, int lane) {
  using KT = typename Key::T;
  const int KR = KP / 32, kr = (K - 1) >> 5, kl = (K - 1) & 31;  // list rows; the k-th's row, lane
  for (int r = r0; r < r0 + nr; ++r) {
    KT* L = lists + (size_t)r * KP;
    KT lv[4], kx[4], kth = Key::sentinel();
    unsigned mk[4];
    int n = 0;
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      lv[t] = t < KR ? L[t * 32 + lane] : Key::sentinel();
      if (t == kr) kth = __shfl_sync(FULL, lv[t], kl);
    }
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      kx[t] = Key::make(sc[r * ld + t * 32 + lane], c0 + t * 32 + lane);
      mk[t] = __ballot_sync(FULL, kx[t] > kth);
      n += __popc(mk[t]);
    }
    if (SORT_WINNERS && n > SERIAL_MAX && n <= 32) {
      KT w = Key::sentinel();  // lane i: the i-th winner in block order
      int base = 0;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = lane - base, c = __popc(mk[t]);
        const bool mine = i >= 0 && i < c;
        const KT x = __shfl_sync(FULL, kx[t], mine ? nth_set_bit(mk[t], i) : lane);
        w = mine ? x : w;
        base += c;
      }
      sort32_desc(w, lane);
      if (KR == 1) {
        merge32_desc(lv[0], w, lane);
      } else {
        const KT s[4] = {w, Key::sentinel(), Key::sentinel(), Key::sentinel()};
        merge128_desc(lv, s, lane);
      }
    } else if (n > SERIAL_MAX) {
      sort128_desc(kx, lane);
      if (SORT_WINNERS && KR == 1) {
        merge32_desc(lv[0], kx[0], lane);
      } else {
        merge128_desc(lv, kx, lane);
      }
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        while (mk[u]) {
          const int src = __ffs(mk[u]) - 1;
          mk[u] &= mk[u] - 1;
          const KT x = __shfl_sync(FULL, kx[u], src);
          if (!(x > kth)) continue;  // warp-uniform
          int p = 0;  // x's position: the count of larger keys (< K, as x beats the k-th)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            if (t < KR) p += __popc(__ballot_sync(FULL, lv[t] > x));
          KT carry = Key::sentinel();  // position t * 32 - 1 before the shift
#pragma unroll
          for (int t = 0; t < 4; ++t) {
            if (t < KR) {
              KT up = __shfl_up_sync(FULL, lv[t], 1);
              const KT last = __shfl_sync(FULL, lv[t], 31);
              if (lane == 0) up = carry;
              carry = last;
              const int i = t * 32 + lane;
              lv[t] = i < p ? lv[t] : (i == p ? x : up);
            }
            if (t == kr) kth = __shfl_sync(FULL, lv[t], kl);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < 4; ++t)
      if (t < KR) L[t * 32 + lane] = lv[t];
  }
}

}  // namespace
