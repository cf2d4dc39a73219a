// The scoring step shared by the scan kernels (topk.cu) and the IVF probe
// kernels (ivf_probe.cu): a block of kThreads threads scores kSub rows of a
// row-major database against up to kMaxQc queries staged in shared memory.
//
//   bf16 x bf16 -> f32 and int8 x int8 -> s32 on the tensor cores (WMMA
//   16x16x16; warp w multiplies rows [16w, 16w + 16)), f32 x f32 -> f32 on
//   the CUDA cores (no TF32).  Rows are staged 128 bytes deep through shared
//   memory with 16-byte loads; rows at or past `valid` read as zero.
//
// Callers own the loop over steps and the selection that reads the scores.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace tr_tile {

using namespace nvcuda;

constexpr int kSub = 128;       // rows per step
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxQc = 64;      // queries one block scores at once
constexpr int kMaxK = 128;      // longest list warp_insert keeps in registers
constexpr int kMaxDeepK = 1024; // longest list warp_insert_deep keeps
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

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

// Copy `rows` rows of `cols` elements from global (row stride gld) into
// shared memory (row stride sld); rows at or past `valid` are zero.
template <typename T>
__device__ inline void stage(const T* __restrict__ g, size_t gld, int valid, T* s,
                             int sld, int rows, int cols) {
  if constexpr (std::is_same<T, float>::value) {
    for (int i = threadIdx.x; i < rows * cols; i += kThreads) {
      const int r = i / cols, c = i % cols;
      s[r * sld + c] = r < valid ? __ldg(g + size_t(r) * gld + c) : 0.f;
    }
  } else {
    constexpr int vec = 16 / sizeof(T);
    const int per_row = cols / vec;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, c = (i % per_row) * vec;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r < valid) v = __ldg(reinterpret_cast<const uint4*>(g + size_t(r) * gld + c));
      *reinterpret_cast<uint4*>(s + r * sld + c) = v;
    }
  }
}

// Stage qc queries (the first `valid` of them real) into Qs.
template <typename T>
__device__ inline void stage_queries(const T* __restrict__ q, int valid, int d, int qc, T* Qs) {
  stage(q, size_t(d), valid, Qs, d + row_pad(sizeof(T)), qc, d);
}

// Scores of kSub rows x[0 .. kSub) (row stride d; rows at or past `valid`
// are zero) against the qc staged queries: S[qi * kSub + r], f32 for
// bf16/f32 rows and raw s32 sums for int8 rows.  qc % 16 == 0.  Every
// thread of the block must call it; the caller syncs before reading S.
template <typename T>
__device__ inline void score_step(const T* __restrict__ x, int valid, int d, int qc,
                                  const T* Qs, T* Xs, void* S) {
  constexpr int kElt = sizeof(T);
  const int pad = row_pad(kElt);
  const int qld = d + pad;
  const int xld = chunk_elems(kElt) + pad;
  const int tid = threadIdx.x, warp = tid >> 5;
  if constexpr (!std::is_same<T, float>::value) {
    using A = typename Acc<T>::type;
    wmma::fragment<wmma::accumulator, 16, 16, 16, A> acc[kMaxQc / 16];
#pragma unroll
    for (int i = 0; i < kMaxQc / 16; ++i) wmma::fill_fragment(acc[i], A(0));
    const int mf = qc / 16;
    for (int c0 = 0; c0 < d; c0 += chunk_elems(kElt)) {
      const int kc = min(chunk_elems(kElt), d - c0);
      __syncthreads();
      stage(x + c0, size_t(d), valid, Xs, xld, kSub, kc);
      __syncthreads();
      for (int kk = 0; kk < kc; kk += 16) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
        wmma::load_matrix_sync(b, Xs + warp * 16 * xld + kk, xld);
#pragma unroll
        for (int i = 0; i < kMaxQc / 16; ++i) {
          if (i < mf) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
            wmma::load_matrix_sync(a, Qs + i * 16 * qld + c0 + kk, qld);
            wmma::mma_sync(acc[i], a, b, acc[i]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxQc / 16; ++i) {
      if (i < mf)
        wmma::store_matrix_sync(static_cast<A*>(S) + i * 16 * kSub + warp * 16, acc[i],
                                kSub, wmma::mem_row_major);
    }
  } else {
    constexpr int kPairs = kMaxQc * kSub / kThreads;
    float accf[kPairs];
#pragma unroll
    for (int i = 0; i < kPairs; ++i) accf[i] = 0.f;
    for (int c0 = 0; c0 < d; c0 += chunk_elems(kElt)) {
      const int kc = min(chunk_elems(kElt), d - c0);
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
