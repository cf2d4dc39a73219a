// Fused similarity scan + selection for the flat index.
//
// Replaces four Pallas kernels of tpu_rag/ops/topk.py:
//   #1 _topk_tile_kernel      (mode "exact"):    per tile of rows, the exact
//      top-k rows per query, ties to the lowest row;
//   #2 _packed_tile_kernel    (mode "packed"):   the same at 18-bit score
//      resolution: each score keeps the top 18 bits of its f32 pattern (sign,
//      exponent, 9 mantissa bits), selection is by that score and then the
//      lowest row, and the rounded score is what comes out;
//   #3 _bucketed_tile_kernel  (mode "bucketed"): per query, the max score and
//      its row in each run of 128 consecutive global rows, ties to the
//      lowest row;
//   #4 _stream_only_kernel    (read_sum_kernel below): the f32 sum of a whole
//      matrix, a pure streaming read that measures the read rate the scans'
//      access pattern can reach.
// The scans compute scores = Q . X^T (bf16 x bf16 -> f32, int8 x int8 -> s32
// then scaled, f32 x f32 -> f32), drop rows whose ns tag is PAD_TAG or whose
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
//     lists up to 128 shift through registers (warp_insert), longer ones up
//     to 1024 chunk by chunk in shared memory (warp_insert_deep), where the
//     wrapper shrinks the query chunk so the lists fit;
//   - packed selection is the exact selection of the rounded scores: on the
//     TPU, packing (score | 14-bit lane) into one int32 made each of k passes
//     a single max-reduce over a tile of at most 16,384 rows; here the
//     sorted list already breaks ties by row, so neither the lane field nor
//     the tile cap carries over;
//   - the bucketed step reduces each query's 128 scores with one warp.
// The scoring step and the sorted insertion live in scan_tile.cuh, shared
// with the IVF probe kernels (ivf_probe.cu).
// Not yet: TMA / cp.async double buffering and wgmma (loads and math do not
// overlap within a block; two blocks per SM hide part of it).
//
// Output: exact/packed -> (nq, n_tiles, k) candidates, sorted within a tile, with
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

// selection of scan_kernel
enum ScanMode { kBucketed = 0, kExact = 1, kPacked = 2 };

// #2's rounding: the top 18 bits of the f32 pattern.  The TPU kernel's
// sortable-key round trip with its low-bit fill gives exactly this value
// (-inf stays -inf), and the rounded values order as the keys do.
__device__ inline float round18(float s) { return __int_as_float(__float_as_int(s) & ~0x3FFF); }

template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
            const float* __restrict__ scale, const int* __restrict__ ns,
            const int* __restrict__ canon, const float* __restrict__ qscale,
            int n, int d, int nq, int want_ns, int want_canon, int tile_rows,
            int qc, int k, float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kList = kMode != kBucketed;  // a sorted list of k per query
  constexpr int kElt = sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  const ScanSmem lay = scan_smem(kElt, d, qc, k, kList);
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
  if constexpr (kList) {
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
      if constexpr (kInt8 && kList) qs = qscale[q0 + qi];
      auto score = [&](int r) -> float {
        if (!okS[r]) return -INFINITY;
        if constexpr (kInt8) {
          const float a = float(reinterpret_cast<const int*>(Sf)[qi * kSub + r]);
          // exact/packed: (acc * query scale) * row scale, in the reference's
          // order; bucketed: the caller applies the query scale after selection
          return kList ? (a * qs) * rsS[r] : a * rsS[r];
        } else {
          return Sf[qi * kSub + r];
        }
      };
      if constexpr (kList) {
        float* Ls = Lsc + qi * k;
        int* Li = Lid + qi * k;
        if (k <= kMaxK) {  // warp-uniform
#pragma unroll
          for (int h = 0; h < kSub / 32; ++h) {
            const int r = h * 32 + lane, row = row0 + r;
            const float s = score(r);
            warp_insert(Ls, Li, k, kMode == kPacked ? round18(s) : s, row);
          }
        } else {
          for (int h = 0; h < kSub / 32; ++h) {
            const int r = h * 32 + lane, row = row0 + r;
            const float s = score(r);
            warp_insert_deep(Ls, Li, k, kMode == kPacked ? round18(s) : s, row);
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

  if constexpr (kList) {
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

template <typename T, int kMode>
int launch(const void* q, const void* x, const void* scale, const void* ns,
           const void* canon, const void* qscale, int n, int d, int nq,
           int want_ns, int want_canon, int tile_rows, int qc, int k,
           void* out_sc, void* out_id, cudaStream_t stream) {
  const size_t smem = scan_smem(sizeof(T), d, qc, k, kMode != kBucketed).total;
  auto kern = scan_kernel<T, kMode>;
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

// ---- #4: read-rate probe.  The TPU kernel streamed (bn, d) tiles through
// VMEM and reduced each to one row so the DMA could not be elided.  Here
// every thread walks the matrix as 16-byte vectors (neighbouring threads on
// neighbouring addresses), keeps kInFlight loads in flight, and adds them in
// f32 (int8 through __dp4a, exact per vector); a block writes one partial
// sum and the caller adds the partials.  Bound by bytes: one read of x.
constexpr int kSumThreads = 256;
constexpr int kInFlight = 4;

template <typename T>
__device__ inline float sum16(uint4 v) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
  if constexpr (std::is_same<T, float>::value) {
    return (__uint_as_float(w[0]) + __uint_as_float(w[1])) +
           (__uint_as_float(w[2]) + __uint_as_float(w[3]));
  } else if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a += __uint_as_float(w[i] << 16) + __uint_as_float(w[i] & 0xFFFF0000u);
    return a;
  } else {
    int a = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) a = __dp4a(int(w[i]), 0x01010101, a);
    return float(a);
  }
}

template <typename T>
__device__ inline float to_f32(T v) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) return __bfloat162float(v);
  else return float(v);
}

template <typename T>
__global__ void __launch_bounds__(kSumThreads)
read_sum_kernel(const T* __restrict__ x, long long n_elems, float* __restrict__ partial) {
  constexpr int kPer = 16 / sizeof(T);
  const uint4* xv = reinterpret_cast<const uint4*>(x);
  const long long nvec = n_elems / kPer;
  const long long stride = (long long)gridDim.x * kSumThreads;
  long long i = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  float acc = 0.f;
  for (; i + (kInFlight - 1) * stride < nvec; i += kInFlight * stride) {
    uint4 v[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) v[u] = __ldg(xv + i + u * stride);
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) acc += sum16<T>(v[u]);
  }
  for (; i < nvec; i += stride) acc += sum16<T>(__ldg(xv + i));
  if (blockIdx.x == 0)  // the elements past the last whole vector
    for (long long e = nvec * kPer + threadIdx.x; e < n_elems; e += kSumThreads)
      acc += to_f32(x[e]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(kFull, acc, off);
  __shared__ float warp_sums[kSumThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float b = 0.f;
#pragma unroll
    for (int w = 0; w < kSumThreads / 32; ++w) b += warp_sums[w];
    partial[blockIdx.x] = b;
  }
}

}  // namespace

extern "C" size_t tr_scan_smem_bytes(int dtype, int d, int qc, int k, int exact) {
  return scan_smem(elt_of(dtype), d, qc, k, exact != 0).total;
}

// mode 1 (exact, #1) or 2 (packed, #2) -> out (nq, ceil(n / tile_rows), k);
// mode 0 (bucketed, #3) -> out (nq, ceil(n / 128)).
// q (nq, d) and x (n, d) share `dtype`; scale (n,) and qscale (nq,) f32 are
// read for int8 only; ns/canon (n,) int32.
extern "C" int tr_scan(const void* q, const void* x, const void* scale,
                       const void* ns, const void* canon, const void* qscale,
                       int n, int d, int nq, int want_ns, int want_canon,
                       int tile_rows, int qc, int k, int mode, int dtype,
                       void* out_sc, void* out_id, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % 16 != 0 || tile_rows <= 0 ||
      tile_rows % kSub != 0 || qc <= 0 || qc % 16 != 0 || qc > kMaxQc ||
      mode < kBucketed || mode > kPacked ||
      (mode != kBucketed && (k <= 0 || k > kMaxDeepK)))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
#define TR_SCAN(T, M) \
  launch<T, M>(q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, tile_rows, qc, k, out_sc, out_id, s)
#define TR_MODES(T) \
  (mode == kExact ? TR_SCAN(T, kExact) : mode == kPacked ? TR_SCAN(T, kPacked) : TR_SCAN(T, kBucketed))
  switch (dtype) {
    case TR_F32: return TR_MODES(float);
    case TR_BF16: return TR_MODES(__nv_bfloat16);
    case TR_I8: return TR_MODES(int8_t);
  }
#undef TR_MODES
#undef TR_SCAN
  return int(cudaErrorInvalidValue);
}

// #4: partial (blocks,) f32 sums of the n_elems elements of x (16-byte
// aligned); the caller adds them.
extern "C" int tr_read_sum(const void* x, long long n_elems, int dtype, int blocks,
                           void* partial, void* stream) {
  if (n_elems <= 0 || blocks <= 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  auto out = static_cast<float*>(partial);
  switch (dtype) {
    case TR_F32:
      read_sum_kernel<float><<<blocks, kSumThreads, 0, s>>>(static_cast<const float*>(x), n_elems, out);
      break;
    case TR_BF16:
      read_sum_kernel<__nv_bfloat16><<<blocks, kSumThreads, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), n_elems, out);
      break;
    case TR_I8:
      read_sum_kernel<int8_t><<<blocks, kSumThreads, 0, s>>>(static_cast<const int8_t*>(x), n_elems, out);
      break;
    default:
      return int(cudaErrorInvalidValue);
  }
  return int(cudaGetLastError());
}
