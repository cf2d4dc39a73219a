// Sorted top-k lists in shared memory, shared by the exact and packed scans
// (pipe_scan_kernel and box_scan_kernel, topk.cu: #1 #2) and the split
// per-list IVF probes (probe_split_kernel and probe_f32_kernel,
// ivf_probe.cu: #6).
//
// A list holds k entries (score, row) in the order (score desc, row asc);
// empty entries are (-inf, INT_MAX) and sort last.  Rows are unique, so the
// order is total and a list's k-th entry is the threshold a candidate must
// beat.
#pragma once

#include <limits.h>
#include <math.h>

#include "common.cuh"

namespace tr_tile {

// kSub (rows of a bucket and of a scan's row tile) and kMaxK (the longest
// per-list selection): layout.h
constexpr int kMaxQc = 64;       // queries one scan block takes at once
constexpr int kMaxDeepK = 1024;  // longest list warp_merge keeps (#1, #2)
constexpr unsigned kFull = 0xffffffffu;

__device__ inline bool better(float s, int r, float s2, int r2) {
  return s > s2 || (s == s2 && r < r2);
}

// One warp merges its lanes' candidates (s, row; s = -inf for none) into a
// sorted list of k <= 1024 entries (score desc, row asc; empty entries
// -inf, INT_MAX) in shared memory, all at once.  A candidate's new place is
// the number of entries (binary search) and of other candidates better than
// it, marked in the warp's 1024-bit map `bm` (zero on entry and on exit).
// Then each place from the top down to the best candidate's takes the entry
// it receives (the place less the candidates placed below it, counted from
// the map): an entry only ever moves up, so with the chunks of 32 taken
// from the top no entry is overwritten before it is read.  Whatever lands
// at k or beyond drops out: the list that inserting the candidates one at a
// time gives.  A caller that knows the list's real entries (`filled`; the
// rest are empty) starts the moves at the last place a real entry can take,
// filled + placed - 1, not at the top: past the real entries an empty entry
// would only move onto an empty one.  Returns the candidates placed.
__device__ inline int warp_merge(float* Ls, int* Li, int k, float s, int row, unsigned* bm,
                                 int filled = INT_MAX) {
  const int lane = threadIdx.x & 31;
  const bool real = s > -INFINITY && better(s, row, Ls[k - 1], Li[k - 1]);
  const unsigned cand = __ballot_sync(kFull, real);
  if (!cand) return 0;
  int rank = 0;  // candidates better than this one
  for (unsigned m = cand; m; m &= m - 1) {
    const int src = __ffs(m) - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int cr = __shfl_sync(kFull, row, src);
    rank += better(cs, cr, s, row);
  }
  int pos = k;
  if (real) {
    int lo = 0, hi = k - 1;  // entries [0, lo) are better; entry k - 1 is not
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      if (better(Ls[mid], Li[mid], s, row)) lo = mid + 1;
      else hi = mid;
    }
    pos = lo + rank;
    if (pos < k) atomicOr(bm + (pos >> 5), 1u << (pos & 31));
  }
  const int pmin = __reduce_min_sync(kFull, pos);
  int below = __popc(__ballot_sync(kFull, pos < k));  // candidates placed under the chunk
  const int placed = below;
  const int top = filled >= k - placed ? k - 1 : filled + placed - 1;  // the last real place
  __syncwarp();
  for (int w = top >> 5; w >= (pmin >> 5) && pmin < k; --w) {
    const unsigned bits = bm[w];
    below -= __popc(bits);
    const int o = (w << 5) + lane;
    const bool from_list = o < k && !((bits >> lane) & 1u);
    const int j = o - below - __popc(bits & ((1u << lane) - 1u));
    float es = 0.f;
    int ei = 0;
    if (from_list) {
      es = Ls[j];
      ei = Li[j];
    }
    __syncwarp();
    if (from_list) {
      Ls[o] = es;
      Li[o] = ei;
    }
    __syncwarp();
  }
  if (pos < k) {
    Ls[pos] = s;
    Li[pos] = row;
    bm[pos >> 5] = 0u;
  }
  __syncwarp();
  return placed;
}

// Entries of the sorted list (Ls, Li) of k that are better than (s, r): a
// binary search, since `better` holds for a prefix of the list.  With
// (-inf, INT_MAX) it counts the list's real entries.  The list may lie in
// this block's shared memory or, through a mapped address, in a peer's of
// the cluster.
__device__ inline int count_better(const float* Ls, const int* Li, int k, float s, int r) {
  int lo = 0, hi = k;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (better(Ls[mid], Li[mid], s, r)) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

}  // namespace tr_tile
