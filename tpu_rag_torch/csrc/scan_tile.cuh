// The scoring step of the f32 kernels: the f32 scan (topk.cu) and the f32
// per-list IVF probe (ivf_probe.cu's probe_list_kernel).  A block of
// kThreads threads scores kSub rows of a row-major f32 database against up
// to kMaxQc queries staged in shared memory, on the CUDA cores (no TF32).  Rows are staged 128 bytes deep
// through shared memory; rows at or past `valid` read as zero.  (bf16 and
// int8 rows go through the pipelined kernels' tensor-core products.)
//
// Callers own the loop over steps and the selection that reads the scores.
#pragma once

#include <math.h>

#include "common.cuh"

namespace tr_tile {

constexpr int kSub = 128;       // rows per step
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQc = 64;      // queries one block scores at once
constexpr int kMaxK = 128;      // longest list warp_insert keeps in registers
constexpr int kMaxDeepK = 1024; // longest list warp_insert_deep keeps
constexpr unsigned kFull = 0xffffffffu;

// Staged chunk depth: 128 bytes of each row.  f32 rows get one element of
// padding in shared memory (its scalar dot loop reads a column per lane).
__host__ __device__ inline int chunk_elems(int elt) { return 128 / elt; }
__host__ __device__ inline int row_pad(int elt) { return elt == 4 ? 1 : 0; }

// Shared-memory bytes of the staged queries (qc rows of d), the staged row
// chunk, and the (qc x kSub) score tile.
__host__ __device__ inline size_t q_bytes(int elt, int d, int qc) {
  return tr_align128(size_t(qc) * (d + row_pad(elt)) * elt);
}
__host__ __device__ inline size_t x_bytes(int elt) {
  return tr_align128(size_t(kSub) * (chunk_elems(elt) + row_pad(elt)) * elt);
}
__host__ __device__ inline size_t s_bytes(int qc) { return tr_align128(size_t(qc) * kSub * 4); }

// Copy `rows` rows of `cols` f32 elements from global (row stride gld) into
// shared memory (row stride sld); rows at or past `valid` are zero.
__device__ inline void stage(const float* __restrict__ g, size_t gld, int valid, float* s,
                             int sld, int rows, int cols) {
  for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
    const int r = i / cols, c = i % cols;
    s[r * sld + c] = r < valid ? __ldg(g + size_t(r) * gld + c) : 0.f;
  }
}

// Stage qc f32 queries (the first `valid` of them real) into Qs.
__device__ inline void stage_queries(const float* __restrict__ q, int valid, int d, int qc,
                                     float* Qs) {
  stage(q, size_t(d), valid, Qs, d + row_pad(4), qc, d);
}

// Scores of kSub f32 rows x[0 .. kSub) (row stride d; rows at or past
// `valid` are zero) against the qc staged queries: S[qi * kSub + r].  Every
// thread of the block must call it; the caller syncs before reading S.
__device__ inline void score_step(const float* __restrict__ x, int valid, int d, int qc,
                                  const float* Qs, float* Xs, void* S) {
  const int pad = row_pad(4);
  const int qld = d + pad;
  const int xld = chunk_elems(4) + pad;
  const int tid = threadIdx.x;
  constexpr int kPairs = kMaxQc * kSub / kThreads;
  float accf[kPairs];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) accf[i] = 0.f;
  for (int c0 = 0; c0 < d; c0 += chunk_elems(4)) {
    const int kc = min(chunk_elems(4), d - c0);
    __syncthreads();
    stage(x + c0, size_t(d), valid, Xs, xld, kSub, kc);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      const int p = tid + i * kThreads, qi = p / kSub, r = p % kSub;
      if (qi < qc) {
        const float* qa = Qs + qi * qld + c0;
        const float* xa = Xs + r * xld;
        float s = accf[i];
        for (int c = 0; c < kc; ++c) s = fmaf(qa[c], xa[c], s);
        accf[i] = s;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int p = tid + i * kThreads, qi = p / kSub, r = p % kSub;
    if (qi < qc) static_cast<float*>(S)[qi * kSub + r] = accf[i];
  }
}

// One warp merges its 32 lanes' candidates (s, row) into a sorted list of k
// entries (score desc, row asc) in shared memory, inserting only those that
// beat the list's last entry, one at a time: ties go to the lowest row.
// -inf candidates are never inserted; empty entries are (-inf, INT_MAX).
__device__ inline void warp_insert(float* Ls, int* Li, int k, float s, int row) {
  const int lane = threadIdx.x & 31;
  float ts = Ls[k - 1];
  int ti = Li[k - 1];
  unsigned m = __ballot_sync(kFull, s > -INFINITY && (s > ts || (s == ts && row < ti)));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int cr = __shfl_sync(kFull, row, src);
    ts = Ls[k - 1];
    ti = Li[k - 1];
    if (!(cs > ts || (cs == ts && cr < ti))) continue;  // warp-uniform
    float es[kMaxK / 32];
    int ei[kMaxK / 32];
    int better = 0;
#pragma unroll
    for (int t = 0; t < kMaxK / 32; ++t) {
      const int j = lane + 32 * t;
      if (j < k) {
        es[t] = Ls[j];
        ei[t] = Li[j];
        better += es[t] > cs || (es[t] == cs && ei[t] < cr);
      }
    }
    const int pos = __reduce_add_sync(kFull, better);
    __syncwarp();
#pragma unroll
    for (int t = 0; t < kMaxK / 32; ++t) {
      const int j = lane + 32 * t;
      if (j >= pos && j + 1 < k) {
        Ls[j + 1] = es[t];
        Li[j + 1] = ei[t];
      }
    }
    if (lane == 0) {
      Ls[pos] = cs;
      Li[pos] = cr;
    }
    __syncwarp();
  }
}

// warp_insert for lists longer than kMaxK (up to kMaxDeepK), same order and
// ties.  The list stays in shared memory: the insert position is counted a
// 32-entry chunk at a time (the list is sorted, so the count stops at the
// first chunk holding an entry that is not better), and the tail shifts one
// place chunk by chunk from the end, so each lane holds one entry at a time.
__device__ inline void warp_insert_deep(float* Ls, int* Li, int k, float s, int row) {
  const int lane = threadIdx.x & 31;
  unsigned m = __ballot_sync(
      kFull, s > -INFINITY && (s > Ls[k - 1] || (s == Ls[k - 1] && row < Li[k - 1])));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cs = __shfl_sync(kFull, s, src);
    const int cr = __shfl_sync(kFull, row, src);
    const float ts = Ls[k - 1];
    const int ti = Li[k - 1];
    if (!(cs > ts || (cs == ts && cr < ti))) continue;  // warp-uniform
    int pos = 0;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int j = c0 + lane;
      const unsigned b = __ballot_sync(
          kFull, j < k && (Ls[j] > cs || (Ls[j] == cs && Li[j] < cr)));
      pos += __popc(b);
      if (b != kFull) break;
    }
    // entries [pos, k - 2] move up one place, highest chunk first: a chunk's
    // lane 31 writes into the chunk above, whose entries have already moved
    for (int c0 = (k - 2) & ~31; c0 >= (pos & ~31); c0 -= 32) {
      const int j = c0 + lane;
      const bool mv = j >= pos && j + 1 < k;
      float es = 0.f;
      int ei = 0;
      if (mv) {
        es = Ls[j];
        ei = Li[j];
      }
      __syncwarp();
      if (mv) {
        Ls[j + 1] = es;
        Li[j + 1] = ei;
      }
      __syncwarp();
    }
    if (lane == 0) {
      Ls[pos] = cs;
      Li[pos] = cr;
    }
    __syncwarp();
  }
}

}  // namespace tr_tile
