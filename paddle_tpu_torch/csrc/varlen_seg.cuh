// Segment logic shared by the varlen flash-attention kernels, forward (K3,
// varlen_flash_attention.cu) and backward (K8a/K8b,
// varlen_flash_attention_bwd.cu): which (query, key) pairs of a packed
// (cu_seqlens) batch are live, and which contiguous ranges of keys (or
// queries) a 64-row tile has to walk. Keeping it in one place keeps the
// forward and the backward from ever disagreeing on a live pair, as
// flash_mma.cuh does for the dense kernels.
//
// Conventions (the TPU kernel's): a query at packed position qi of segment
// s has the bottom-right relative position rel_q = qi - cu_q[s] + len_k(s) -
// len_q(s), a key at kj has rel_k = kj - cu_k[s]; the pair is live when both
// lie in one segment and, with causal, rel_q >= rel_k and (with a window)
// rel_k > rel_q - window. Empty segments (cu[i] == cu[i + 1]) are legal.
// Query rows at or past cu_q[nseg] are padding (segment id -1) and keys at
// or past the end of a walked range get id -2, so neither is ever live.
#pragma once

#include "common.cuh"

namespace ptt {
namespace varlen {

constexpr int kTile = 64;  // query rows and keys per tile

// Segment of packed position pos (0 <= pos < cu[nseg]): the largest s with
// cu[s] <= pos, which is searchsorted(cu[1:], pos, side="right").
__device__ __forceinline__ int find_seg(const int* __restrict__ cu, int nseg,
                                        int pos) {
  int lo = 0, hi = nseg - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (cu[mid] <= pos)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__device__ __forceinline__ bool live_pair(int qs, int qr, int ks, int kr,
                                          int causal, int window) {
  if (qs != ks || qs < 0) return false;
  if (causal) {
    if (qr < kr) return false;
    if (window > 0 && kr <= qr - window) return false;
  }
  return true;
}

// Segment id and bottom-right relative position of query row qi.
__device__ __forceinline__ void query_row(const int* __restrict__ cu_q,
                                          const int* __restrict__ cu_k,
                                          int nseg, int tq, int qi, int* seg,
                                          int* rel) {
  if (qi < tq && qi < cu_q[nseg]) {
    const int s = find_seg(cu_q, nseg, qi);
    *seg = s;
    *rel = qi - cu_q[s] + (cu_k[s + 1] - cu_k[s]) - (cu_q[s + 1] - cu_q[s]);
  } else {
    *seg = -1;
    *rel = -(1 << 30);
  }
}

// query_row for the tile's rows q0 .. q0 + kTile - 1.
__device__ inline void query_rows(const int* __restrict__ cu_q,
                                  const int* __restrict__ cu_k, int nseg,
                                  int tq, int q0, int* qseg, int* qrel) {
  for (int r = threadIdx.x; r < kTile; r += blockDim.x)
    query_row(cu_q, cu_k, nseg, tq, q0 + r, qseg + r, qrel + r);
}

// Segment ids / relative positions of the keys k0 .. k0 + kTile - 1; keys at
// or past khi get an id no query has.
__device__ inline void key_rows(const int* __restrict__ cu_k, int nseg, int k0,
                                int khi, int* kseg, int* krel) {
  for (int c = threadIdx.x; c < kTile; c += blockDim.x) {
    const int kj = k0 + c;
    if (kj < khi) {
      const int s = find_seg(cu_k, nseg, kj);
      kseg[c] = s;
      krel[c] = kj - cu_k[s];
    } else {
      kseg[c] = -2;
      krel[c] = 1 << 30;
    }
  }
}

// The contiguous key range [lo, hi) that queries from (segment s_lo, rel_q
// first) to (segment s_hi, rel_q last) can see: their segments' keys, cut at
// the last query's causal diagonal and the first query's window edge (keys
// of the segments in between all stay inside).
__device__ __forceinline__ void key_range_of(const int* __restrict__ cu_k,
                                             int tk, int s_lo, int first,
                                             int s_hi, int last, int causal,
                                             int window, int* lo_out,
                                             int* hi_out) {
  int lo = cu_k[s_lo];
  int hi = cu_k[s_hi + 1];
  if (causal) {
    const int diag = cu_k[s_hi] + last + 1;
    hi = min(hi, max(diag, s_hi > s_lo ? cu_k[s_hi] : 0));
    if (window > 0) {
      const int edge = cu_k[s_lo] + first - window + 1;
      lo = max(lo, s_hi > s_lo ? min(edge, cu_k[s_lo + 1]) : edge);
    }
  }
  *lo_out = lo;
  *hi_out = min(hi, tk);
}

// The key range of the tile whose query_rows are qseg / qrel (called by one
// thread; an empty range when every row is padding).
__device__ inline void key_range(const int* __restrict__ cu_k, int tq, int tk,
                                 int q0, const int* qseg, const int* qrel,
                                 int causal, int window, int* range) {
  int last = min(q0 + kTile, tq) - 1 - q0;
  while (last >= 0 && qseg[last] < 0) --last;  // padding rows sit at the end
  if (last < 0) {
    range[0] = range[1] = 0;
    return;
  }
  key_range_of(cu_k, tk, qseg[0], qrel[0], qseg[last], qrel[last], causal,
               window, range, range + 1);
}

// The transpose of key_range_of: the contiguous query range [lo, hi) that
// sees any key from (segment s_lo, rel_k first) to (segment s_hi, rel_k
// last). It starts at the first query of s_lo whose rel_q reaches the first
// key (causal) and ends before the first query of s_hi whose window has
// passed the last key (keys and queries of the segments in between all stay
// inside).
__device__ __forceinline__ void query_range_of(const int* __restrict__ cu_q,
                                               const int* __restrict__ cu_k,
                                               int s_lo, int first, int s_hi,
                                               int last, int causal,
                                               int window, int* lo_out,
                                               int* hi_out) {
  int lo = cu_q[s_lo];
  int hi = cu_q[s_hi + 1];
  if (causal) {
    // query qi of segment s sees rel_k when qi >= cu_q[s] + rel_k - len_k +
    // len_q (its rel_q >= rel_k)
    const int shift_lo = (cu_q[s_lo + 1] - cu_q[s_lo]) -
                         (cu_k[s_lo + 1] - cu_k[s_lo]);
    const int start = cu_q[s_lo] + first + shift_lo;
    lo = max(lo, s_hi > s_lo ? min(start, cu_q[s_lo + 1]) : start);
    if (window > 0) {
      // ... and keeps it while rel_q - window < rel_k
      const int shift_hi = (cu_q[s_hi + 1] - cu_q[s_hi]) -
                           (cu_k[s_hi + 1] - cu_k[s_hi]);
      const int end = cu_q[s_hi] + last + window + shift_hi;
      hi = min(hi, s_hi > s_lo ? max(end, cu_q[s_hi]) : end);
    }
  }
  *lo_out = lo;
  *hi_out = max(hi, lo);
}

// The query range of the key tile whose key_rows are kseg / krel (called
// by one thread; empty when every key is padding).
__device__ inline void query_range(const int* __restrict__ cu_q,
                                   const int* __restrict__ cu_k,
                                   const int* kseg, const int* krel, int causal,
                                   int window, int* range) {
  int last = kTile - 1;
  while (last >= 0 && kseg[last] < 0) --last;
  if (last < 0) {
    range[0] = range[1] = 0;
    return;
  }
  query_range_of(cu_q, cu_k, kseg[0], krel[0], kseg[last], krel[last],
                 causal, window, range, range + 1);
}

enum TileState : int { kDead = 0, kPartial = 1, kFull = 2 };

// Whether no, some or every (query, key) pair of a tile is live, to every
// thread of the CTA (the index arrays must be visible to all threads).
__device__ inline int tile_pairs(const int* qseg, const int* qrel,
                                 const int* kseg, const int* krel, int causal,
                                 int window) {
  bool any = false, all = true;
  for (int idx = threadIdx.x; idx < kTile * kTile; idx += blockDim.x) {
    const int r = idx / kTile;
    const int c = idx - r * kTile;
    const bool live =
        live_pair(qseg[r], qrel[r], kseg[c], krel[c], causal, window);
    any |= live;
    all &= live;
  }
  if (!__syncthreads_or(any)) return kDead;
  return __syncthreads_and(all) ? kFull : kPartial;
}

// key_rows of the tile at k0, then whether any pair with the CTA's query
// rows is live (the forward's dead-tile test, before any K/V byte is read).
__device__ inline bool key_tile(const int* __restrict__ cu_k, int nseg, int k0,
                                int khi, const int* qseg, const int* qrel,
                                int* kseg, int* krel, int causal, int window) {
  key_rows(cu_k, nseg, k0, khi, kseg, krel);
  __syncthreads();
  return tile_pairs(qseg, qrel, kseg, krel, causal, window) != kDead;
}

}  // namespace varlen
}  // namespace ptt
