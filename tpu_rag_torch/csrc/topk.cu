// Fused similarity scan + selection for the flat index.
//
// Replaces two Pallas kernels of tpu_rag/ops/topk.py:
//   #1 _topk_tile_kernel      (mode "exact"):    per tile of rows, the exact
//      top-k rows per query, ties to the lowest row;
//   #3 _bucketed_tile_kernel  (mode "bucketed"): per query, the max score and
//      its row in each run of 128 consecutive global rows, ties to the
//      lowest row.
// Both compute scores = Q . X^T (bf16 x bf16 -> f32, int8 x int8 -> s32 then
// scaled, f32 x f32 -> f32), drop rows whose ns tag is PAD_TAG or whose
// ns/canon tag differs from a non-negative want, and select on the fly, so
// the (queries x rows) score matrix never reaches device memory.
//
// What bounds it on the H100: one streaming read of the database (n x d
// bf16 or int8) — at 64 queries the product is ~150-300 operations a byte,
// at or below the card's ~295 bf16 ops/byte ridge, so bytes bound it, and
// the selection must stay off the critical path.  This first version does
// the simple things right:
//   - one block holds a chunk of up to 64 queries in shared memory and walks
//     its own tile of rows 128 at a time (one bucket per step), so the
//     database is read once per query chunk;
//   - rows are staged 128 bytes deep through shared memory with 16-byte
//     loads and multiplied on the tensor cores with WMMA (bf16 and int8;
//     the f32 path uses CUDA cores);
//   - exact selection keeps a sorted (score desc, row asc) list of k per
//     query in shared memory; a 128-row step inserts only the rows that beat
//     the list's last entry, which after the first few steps is almost none;
//   - the bucketed step reduces each query's 128 scores with one warp.
// Not yet: TMA / cp.async double buffering and wgmma (loads and math do not
// overlap within a block; two blocks per SM hide part of it).
//
// Output: exact -> (nq, n_tiles, k) candidates, sorted within a tile, with
// id -1 for -inf slots (the caller merges them with a stable sort);
// bucketed -> (nq, ceil(n / 128)) bucket maxima and their rows.

#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <mma.h>

#include <type_traits>

#include "common.cuh"

using namespace nvcuda;

namespace {

constexpr int kSub = 128;       // rows per step = bucket width
constexpr int kThreads = 256;   // 8 warps; warp w multiplies rows [16w, 16w + 16)
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kMaxQc = 64;
constexpr int kPadTag = INT_MIN;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct Acc { using type = float; };
template <> struct Acc<int8_t> { using type = int; };

// Staged chunk depth: 128 bytes of each row.  f32 rows get one element of
// padding in shared memory (its scalar dot loop reads a column per lane).
__host__ __device__ inline int chunk_elems(int elt) { return 128 / elt; }
__host__ __device__ inline int row_pad(int elt) { return elt == 4 ? 1 : 0; }

struct ScanSmem { size_t q, x, s, m, l, total; };

__host__ __device__ inline ScanSmem scan_smem(int elt, int d, int qc, int k, bool exact) {
  const int pad = row_pad(elt);
  ScanSmem o;
  o.q = 0;
  o.x = o.q + tr_align128(size_t(qc) * (d + pad) * elt);
  o.s = o.x + tr_align128(size_t(kSub) * (chunk_elems(elt) + pad) * elt);
  o.m = o.s + tr_align128(size_t(qc) * kSub * 4);
  o.l = o.m + tr_align128(size_t(kSub) * 8);
  o.total = o.l + (exact ? size_t(qc) * k * 8 : 0);
  return o;
}

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

template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ scale, const int* __restrict__ ns,
            const int* __restrict__ canon, const float* __restrict__ qscale,
            int n, int d, int nq, int want_ns, int want_canon, int tile_rows,
            int qc, int k, float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kElt = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const ScanSmem lay = scan_smem(kElt, d, qc, k, kExact);
  const int pad = row_pad(kElt);
  const int qld = d + pad;
  const int xld = chunk_elems(kElt) + pad;
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Xs = reinterpret_cast<T*>(smem + lay.x);
  float* Sf = reinterpret_cast<float*>(smem + lay.s);  // int8: raw s32 sums
  int* okS = reinterpret_cast<int*>(smem + lay.m);
  float* rsS = reinterpret_cast<float*>(smem + lay.m) + kSub;
  float* Lsc = reinterpret_cast<float*>(smem + lay.l);
  int* Lid = reinterpret_cast<int*>(Lsc + qc * k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.y * qc;
  const int nql = min(qc, nq - q0);
  const int row_begin = blockIdx.x * tile_rows;
  const int row_end = min(n, row_begin + tile_rows);

  stage(q + size_t(q0) * d, size_t(d), nql, Qs, qld, qc, d);
  if constexpr (kExact) {
    for (int i = tid; i < qc * k; i += kThreads) {
      Lsc[i] = -INFINITY;
      Lid[i] = INT_MAX;
    }
  }

  for (int row0 = row_begin; row0 < row_end; row0 += kSub) {
    __syncthreads();  // the previous step's readers are done
    for (int r = tid; r < kSub; r += kThreads) {
      const int row = row0 + r;
      int ok = 0;
      float rs = 0.f;
      if (row < n) {
        const int t = ns[row], c = canon[row];
        ok = t != kPadTag && (want_ns < 0 || t == want_ns) &&
             (want_canon < 0 || c == want_canon);
        if constexpr (kInt8) rs = scale[row];
      }
      okS[r] = ok;
      rsS[r] = rs;
    }

    // ---- scores of this step: Sf[qi][r], qc x kSub
    if constexpr (!kF32) {
      using A = typename Acc<T>::type;
      wmma::fragment<wmma::accumulator, 16, 16, 16, A> acc[kMaxQc / 16];
#pragma unroll
      for (int i = 0; i < kMaxQc / 16; ++i) wmma::fill_fragment(acc[i], A(0));
      const int mf = qc / 16;
      for (int c0 = 0; c0 < d; c0 += chunk_elems(kElt)) {
        const int kc = min(chunk_elems(kElt), d - c0);
        __syncthreads();
        stage(x + size_t(row0) * d + c0, size_t(d), n - row0, Xs, xld, kSub, kc);
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
          wmma::store_matrix_sync(reinterpret_cast<A*>(Sf) + i * 16 * kSub + warp * 16,
                                  acc[i], kSub, wmma::mem_row_major);
      }
    } else {
      constexpr int kPairs = kMaxQc * kSub / kThreads;
      float accf[kPairs];
#pragma unroll
      for (int i = 0; i < kPairs; ++i) accf[i] = 0.f;
      for (int c0 = 0; c0 < d; c0 += chunk_elems(kElt)) {
        const int kc = min(chunk_elems(kElt), d - c0);
        __syncthreads();
        stage(x + size_t(row0) * d + c0, size_t(d), n - row0, Xs, xld, kSub, kc);
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
        if (qi < qc) Sf[qi * kSub + r] = accf[i];
      }
    }
    __syncthreads();

    // ---- selection
    for (int qi = warp; qi < nql; qi += kWarps) {
      float qs = 1.f;
      if constexpr (kInt8 && kExact) qs = qscale[q0 + qi];
      auto score = [&](int r) -> float {
        if (!okS[r]) return -INFINITY;
        if constexpr (kInt8) {
          const float a = float(reinterpret_cast<const int*>(Sf)[qi * kSub + r]);
          // exact: (acc * query scale) * row scale, in the reference's order;
          // bucketed: the query scale is applied by the caller after selection
          return kExact ? (a * qs) * rsS[r] : a * rsS[r];
        } else {
          return Sf[qi * kSub + r];
        }
      };
      if constexpr (kExact) {
        float* Ls = Lsc + qi * k;
        int* Li = Lid + qi * k;
#pragma unroll
        for (int h = 0; h < kSub / 32; ++h) {
          const int r = h * 32 + lane, row = row0 + r;
          const float s = score(r);
          float ts = Ls[k - 1];
          int ti = Li[k - 1];
          // candidates that beat the list's last entry in (score desc, row asc)
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
      } else {
        float best = -INFINITY;
        int brow = INT_MAX;
#pragma unroll
        for (int h = 0; h < kSub / 32; ++h) {
          const int r = h * 32 + lane, row = row0 + r;
          const float s = score(r);
          if (s > best || (s == best && row < brow)) {
            best = s;
            brow = row;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float os = __shfl_down_sync(kFull, best, off);
          const int orow = __shfl_down_sync(kFull, brow, off);
          if (os > best || (os == best && orow < brow)) {
            best = os;
            brow = orow;
          }
        }
        if (lane == 0) {
          const size_t nb = (size_t(n) + kSub - 1) / kSub;
          const size_t o = size_t(q0 + qi) * nb + row0 / kSub;
          out_sc[o] = best;
          out_id[o] = brow;
        }
      }
    }
  }

  if constexpr (kExact) {
    __syncthreads();
    for (int i = tid; i < nql * k; i += kThreads) {
      const int qi = i / k, j = i % k;
      const float s = Lsc[qi * k + j];
      const size_t o = (size_t(q0 + qi) * gridDim.x + blockIdx.x) * k + j;
      out_sc[o] = s;
      out_id[o] = s > -INFINITY ? Lid[qi * k + j] : -1;
    }
  }
}

template <typename T, bool kExact>
int launch(const void* q, const void* x, const void* scale, const void* ns,
           const void* canon, const void* qscale, int n, int d, int nq,
           int want_ns, int want_canon, int tile_rows, int qc, int k,
           void* out_sc, void* out_id, cudaStream_t stream) {
  const size_t smem = scan_smem(sizeof(T), d, qc, k, kExact).total;
  auto kern = scan_kernel<T, kExact>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  dim3 grid((n + tile_rows - 1) / tile_rows, (nq + qc - 1) / qc);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x),
      static_cast<const float*>(scale), static_cast<const int*>(ns),
      static_cast<const int*>(canon), static_cast<const float*>(qscale), n, d,
      nq, want_ns, want_canon, tile_rows, qc, k, static_cast<float*>(out_sc),
      static_cast<int*>(out_id));
  return int(cudaGetLastError());
}

int elt_of(int dtype) { return dtype == TR_F32 ? 4 : dtype == TR_BF16 ? 2 : 1; }

}  // namespace

extern "C" size_t tr_scan_smem_bytes(int dtype, int d, int qc, int k, int exact) {
  return scan_smem(elt_of(dtype), d, qc, k, exact != 0).total;
}

// exact != 0: kernel #1 -> out (nq, ceil(n / tile_rows), k);
// exact == 0: kernel #3 -> out (nq, ceil(n / 128)).
// q (nq, d) and x (n, d) share `dtype`; scale (n,) and qscale (nq,) f32 are
// read for int8 only; ns/canon (n,) int32.
extern "C" int tr_scan(const void* q, const void* x, const void* scale,
                       const void* ns, const void* canon, const void* qscale,
                       int n, int d, int nq, int want_ns, int want_canon,
                       int tile_rows, int qc, int k, int exact, int dtype,
                       void* out_sc, void* out_id, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % 16 != 0 || tile_rows <= 0 ||
      tile_rows % kSub != 0 || qc <= 0 || qc % 16 != 0 || qc > kMaxQc ||
      (exact && (k <= 0 || k > kMaxK)))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define TR_SCAN(T, E) \
  launch<T, E>(q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, tile_rows, qc, k, out_sc, out_id, s)
  switch (dtype) {
    case TR_F32: return exact ? TR_SCAN(float, true) : TR_SCAN(float, false);
    case TR_BF16: return exact ? TR_SCAN(__nv_bfloat16, true) : TR_SCAN(__nv_bfloat16, false);
    case TR_I8: return exact ? TR_SCAN(int8_t, true) : TR_SCAN(int8_t, false);
  }
#undef TR_SCAN
  return int(cudaErrorInvalidValue);
}
