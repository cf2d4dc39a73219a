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
// The scoring step and the sorted insertion live in scan_tile.cuh, shared
// with the IVF probe kernels (ivf_probe.cu).
// Not yet: TMA / cp.async double buffering and wgmma (loads and math do not
// overlap within a block; two blocks per SM hide part of it).
//
// Output: exact -> (nq, n_tiles, k) candidates, sorted within a tile, with
// id -1 for -inf slots (the caller merges them with a stable sort);
// bucketed -> (nq, ceil(n / 128)) bucket maxima and their rows.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "scan_tile.cuh"

using namespace tr_tile;

namespace {

constexpr int kPadTag = INT_MIN;

struct ScanSmem { size_t q, x, s, m, l, total; };

__host__ __device__ inline ScanSmem scan_smem(int elt, int d, int qc, int k, bool exact) {
  ScanSmem o;
  o.q = 0;
  o.x = o.q + q_bytes(elt, d, qc);
  o.s = o.x + x_bytes(elt);
  o.m = o.s + s_bytes(qc);
  o.l = o.m + tr_align128(size_t(kSub) * 8);
  o.total = o.l + (exact ? size_t(qc) * k * 8 : 0);
  return o;
}

template <typename T, bool kExact>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ scale, const int* __restrict__ ns,
            const int* __restrict__ canon, const float* __restrict__ qscale,
            int n, int d, int nq, int want_ns, int want_canon, int tile_rows,
            int qc, int k, float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int kElt = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const ScanSmem lay = scan_smem(kElt, d, qc, k, kExact);
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

  stage_queries(q + size_t(q0) * d, nql, d, qc, Qs);
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
    score_step(x + size_t(row0) * d, n - row0, d, qc, Qs, Xs, Sf);
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
          warp_insert(Ls, Li, k, score(r), row);
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
