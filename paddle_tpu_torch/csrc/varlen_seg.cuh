// Segment logic shared by the varlen flash-attention kernels, forward (K3,
// varlen_flash_attention.cu) and backward (K8, and K8a/K8b in f32,
// varlen_flash_attention_bwd.cu): which (query, key) pairs of a packed
// (cu_seqlens) batch are live, which contiguous ranges of keys (or
// queries) a 64-row tile has to walk, which tiles of a range hold a live
// pair, and the order in which the tiles are launched. Keeping it in one
// place keeps the forward and the backward from ever disagreeing on a live
// pair, as flash_mma.cuh does for the dense kernels.
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

// A pair inside one segment, from its relative positions.
__device__ __forceinline__ bool rel_live(int qr, int kr, int causal,
                                         int window) {
  return !causal || (kr <= qr && (window <= 0 || kr > qr - window));
}

__device__ __forceinline__ bool live_pair(int qs, int qr, int ks, int kr,
                                          int causal, int window) {
  return qs == ks && qs >= 0 && rel_live(qr, kr, causal, window);
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

// The state of a pair of runs inside one segment: queries of relative
// positions q_lo .. q_hi against keys k_lo .. k_hi (each a run without
// gaps; an empty run when lo > hi), `whole` when both runs fill their
// tiles (no row of either tile lies outside them).
__device__ __forceinline__ int run_pairs(int q_lo, int q_hi, int k_lo,
                                         int k_hi, bool whole, int causal,
                                         int window) {
  if (q_lo > q_hi || k_lo > k_hi) return kDead;
  if (!causal) return whole ? kFull : kPartial;
  // live: rel_k <= rel_q and (window) rel_k > rel_q - window
  const bool any = k_lo <= q_hi && (window <= 0 || k_hi > q_lo - window);
  const bool all =
      whole && k_hi <= q_lo && (window <= 0 || k_lo > q_hi - window);
  return !any ? kDead : all ? kFull : kPartial;
}

// The queries [*qa, *qb) that see key kj (at or past kend: a padding key,
// which no query sees): those of its segment with rel_q >= rel_k and, with
// a window, rel_q < rel_k + window.
__device__ __forceinline__ void key_queries(const int* __restrict__ cu_q,
                                            const int* __restrict__ cu_k,
                                            int nseg, int tq, int kend,
                                            int kj, int causal, int window,
                                            int* qa, int* qb) {
  if (kj >= kend) {
    *qa = *qb = 0;
    return;
  }
  const int ks = find_seg(cu_k, nseg, kj);
  const int kr = kj - cu_k[ks];
  // query qi of segment ks has rel_q = qi - cu_q[ks] + shift
  const int shift = (cu_k[ks + 1] - cu_k[ks]) - (cu_q[ks + 1] - cu_q[ks]);
  int a = cu_q[ks];
  int b = min(cu_q[ks + 1], tq);
  if (causal) {
    a = max(a, cu_q[ks] + kr - shift);
    if (window > 0) b = min(b, cu_q[ks] + kr + window - shift);
  }
  *qa = a;
  *qb = max(a, b);
}

// Whether any query of the rows [q0, q1) and any key of [k0, k1) form a
// live pair, from positions alone: run_pairs of the two runs in each
// segment they share. The caller bounds the rows by min(tq, cu_q[nseg])
// and the keys by min(tk, cu_k[nseg]). The fused backward K8 tests its
// tiles and finds a query tile's other contributors with it.
__device__ inline bool runs_live(const int* __restrict__ cu_q,
                                 const int* __restrict__ cu_k, int nseg,
                                 int q0, int q1, int k0, int k1, int causal,
                                 int window) {
  if (q0 >= q1 || k0 >= k1) return false;
  const int s_hi =
      min(find_seg(cu_q, nseg, q1 - 1), find_seg(cu_k, nseg, k1 - 1));
  for (int s = max(find_seg(cu_q, nseg, q0), find_seg(cu_k, nseg, k0));
       s <= s_hi; ++s) {
    const int qs = cu_q[s], ks = cu_k[s];
    // bottom-right: rel_q = qi - cu_q[s] + len_k - len_q
    const int shift = (cu_k[s + 1] - ks) - (cu_q[s + 1] - qs);
    if (run_pairs(max(q0, qs) - qs + shift,
                  min(q1, cu_q[s + 1]) - 1 - qs + shift, max(k0, ks) - ks,
                  min(k1, cu_k[s + 1]) - 1 - ks, false, causal,
                  window) != kDead)
      return true;
  }
  return false;
}

// Whether no, some or every (query, key) pair of a tile is live, to every
// thread of the CTA, testing every pair (the index arrays must be visible
// to all threads; the call ends with a barrier, so the caller may
// overwrite them next).
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

// How a CTA tests the tiles of the range it walks (keys for K3, queries
// for each 64-key half of K8) against its own 64 rows. When its own rows
// all lie in one segment (the common case), every walked row lies in that
// segment too, at relative position = packed position - off: a tile's
// state and a pair's liveness follow from positions alone, with no index
// arrays and no barrier. Otherwise (`one_seg` false) K3 writes each tile's
// indices and tests its pairs (tile_pairs), and K8 tests the tile by
// runs_live.
struct Walk {
  bool one_seg;
  bool keys;   // the walked side is the keys
  int lo, hi;  // walked positions inside the segment
  int off;     // walked position - off = its relative position
  int own0;    // relative position of the CTA's first own row
  int causal, window;

  // the state of the walked tile at p0 (one_seg)
  __device__ __forceinline__ int state(int p0) const {
    const int a = max(p0, lo) - off;
    const int b = min(p0 + kTile, hi) - 1 - off;
    const bool whole = p0 >= lo && p0 + kTile <= hi;
    const int e = own0 + kTile - 1;
    return keys ? run_pairs(own0, e, a, b, whole, causal, window)
                : run_pairs(a, b, own0, e, whole, causal, window);
  }
  // whether the own query row (own_seg, own_rel) and key c of the walked
  // key tile at p0 (indices wseg / wrel when not one_seg) are a live pair
  // (K3's walk; K8 masks its pairs by key_queries)
  __device__ __forceinline__ bool live(int own_seg, int own_rel,
                                       const int* wseg, const int* wrel,
                                       int p0, int c) const {
    if (one_seg) {
      const int p = p0 + c;
      return p >= lo && p < hi &&
             rel_live(own_rel, p - off, causal, window);
    }
    return live_pair(own_seg, own_rel, wseg[c], wrel[c], causal, window);
  }
};

// The walk of a query tile (query_rows qseg / qrel) over keys below khi.
__device__ inline Walk key_walk(const int* __restrict__ cu_k,
                                const int* qseg, const int* qrel, int khi,
                                int causal, int window) {
  const int sq = qseg[0];
  if (sq < 0 || qseg[kTile - 1] != sq)
    return Walk{false, true, 0, 0, 0, 0, causal, window};
  return Walk{true, true, cu_k[sq], khi, cu_k[sq], qrel[0], causal, window};
}

// The walk of the key tile of kTile keys from kw (keys at or past kend are
// padding) over the queries of a batch of tq rows, and its query range
// [*lo, *hi) (query_range), from the segments of its first and last key:
// a query qi of segment s has rel_q = qi - (cu_q[s + 1] - len_k(s)).
__device__ inline Walk query_walk(const int* __restrict__ cu_q,
                                  const int* __restrict__ cu_k, int nseg,
                                  int tq, int kend, int kw, int causal,
                                  int window, int* lo, int* hi) {
  const int last = min(kw + kTile, kend) - 1;
  const Walk none{false, false, 0, 0, 0, 0, causal, window};
  if (last < kw) {
    *lo = *hi = 0;
    return none;
  }
  const int sf = find_seg(cu_k, nseg, kw);
  const int sl = find_seg(cu_k, nseg, last);
  query_range_of(cu_q, cu_k, sf, kw - cu_k[sf], sl, last - cu_k[sl], causal,
                 window, lo, hi);
  if (sl != sf || last != kw + kTile - 1) return none;
  return Walk{true,           false,
              cu_q[sf],       min(cu_q[sf + 1], tq),
              cu_q[sf + 1] - (cu_k[sf + 1] - cu_k[sf]),
              kw - cu_k[sf],  causal,
              window};
}

// The state of the key tile at k0 against the CTA's query rows (kDead,
// kPartial or kFull): from positions when w.one_seg, else from its key
// rows, written to kseg / krel. Called by every thread (may synchronise).
__device__ inline int key_tile_state(const int* __restrict__ cu_k, int nseg,
                                     const Walk& w, int k0, int khi,
                                     const int* qseg, const int* qrel,
                                     int* kseg, int* krel) {
  if (w.one_seg) return w.state(k0);
  key_rows(cu_k, nseg, k0, khi, kseg, krel);
  __syncthreads();
  return tile_pairs(qseg, qrel, kseg, krel, w.causal, w.window);
}

// From the key tile at *k0 on, in steps of kTile below khi, the first one
// with a live pair against the CTA's query rows: *k0 moves to it, its key
// rows go to kseg / krel (unless w.one_seg), and its state is returned
// (kDead when none is left). No K/V byte is read for the tiles passed over.
__device__ inline int next_key_tile(const int* __restrict__ cu_k, int nseg,
                                    const Walk& w, int* k0, int khi,
                                    const int* qseg, const int* qrel,
                                    int* kseg, int* krel) {
  for (; *k0 < khi; *k0 += kTile) {
    const int state =
        key_tile_state(cu_k, nseg, w, *k0, khi, qseg, qrel, kseg, krel);
    if (state != kDead) return state;
  }
  return kDead;
}

struct Seg {
  int tq, tk, nseg, h, hk;
  int causal, window;  // window 0: none
  float scale;
};

// ------------------------------------------------------------ tile order
// Heaviest tiles first: a one-CTA kernel ranks the tiles by the length of
// the range each walks (longest first, ties by index) into `order`, and the
// main kernel walks that order, so the longest tiles of long segments do
// not trail at the end of the grid. The ranks live in shared memory: past
// kMaxOrderTiles tiles (3.7M rows) the order is the packing order. Static:
// each kernel file that includes this header gets its own copy.
constexpr int kOrderThreads = 1024;
constexpr size_t kMaxOrderSmem = 232448;  // a block's shared memory
constexpr int kMaxOrderTiles = kMaxOrderSmem / sizeof(int);

// order[rank] = tile: key tiles by their query range (by_keys, K8b f32) or
// query tiles by their key range (K3, K8a f32).
static __global__ void __launch_bounds__(kOrderThreads)
    tile_order_kernel(const int* __restrict__ cu_q,
                      const int* __restrict__ cu_k, Seg s, int by_keys,
                      int ntiles, int* __restrict__ order) {
  extern __shared__ int work[];
  if (ntiles > kMaxOrderTiles) {
    for (int t = threadIdx.x; t < ntiles; t += blockDim.x) order[t] = t;
    return;
  }
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const int r0 = t * kTile;
    int lo = 0, hi = 0;
    if (by_keys) {
      const int end = min(min(r0 + kTile, s.tk), cu_k[s.nseg]);
      if (r0 < end) {
        const int s_lo = find_seg(cu_k, s.nseg, r0);
        const int s_hi = find_seg(cu_k, s.nseg, end - 1);
        query_range_of(cu_q, cu_k, s_lo, r0 - cu_k[s_lo], s_hi,
                       end - 1 - cu_k[s_hi], s.causal, s.window, &lo, &hi);
      }
    } else {
      const int end = min(min(r0 + kTile, s.tq), cu_q[s.nseg]);
      if (r0 < end) {
        int sf, rf, sl, rl;
        query_row(cu_q, cu_k, s.nseg, s.tq, r0, &sf, &rf);
        query_row(cu_q, cu_k, s.nseg, s.tq, end - 1, &sl, &rl);
        key_range_of(cu_k, s.tk, sf, rf, sl, rl, s.causal, s.window, &lo,
                     &hi);
      }
    }
    work[t] = max(hi - lo, 0);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < ntiles; t += blockDim.x) {
    const int w = work[t];
    int rank = 0;
    for (int u = 0; u < ntiles; ++u)
      rank += work[u] > w || (work[u] == w && u < t);
    order[rank] = t;
  }
}

static inline int launch_tile_order(const int* cu_q, const int* cu_k,
                                    const Seg& s, int by_keys, int ntiles,
                                    int* order, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t bytes =
      ntiles > kMaxOrderTiles ? 0 : sizeof(int) * static_cast<size_t>(ntiles);
  if (bytes > configured) {
    cudaError_t e = cudaFuncSetAttribute(
        tile_order_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kMaxOrderSmem));
    if (e != cudaSuccess) return static_cast<int>(e);
    configured = kMaxOrderSmem;
  }
  tile_order_kernel<<<1, kOrderThreads, bytes, st>>>(cu_q, cu_k, s, by_keys,
                                                      ntiles, order);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace varlen
}  // namespace ptt
