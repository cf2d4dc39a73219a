// IVF probe kernels: score the rows of the probed inverted lists and select
// candidates in the kernel, so no (queries x rows) score matrix reaches
// device memory.
//
// Replaces two Pallas kernels of tpu_rag/ops/ivf_probe.py:
//   #6 _probe_topk_kernel (ivf_probe_pallas): for each (query, probed list),
//      the exact top k of the list's cap slots, ties to the lowest slot;
//   #7 _batched_bucket_kernel (ivf_probe_batched): for each list of the
//      batch's deduplicated probe union, every query's top m of each 128-slot
//      bucket, ties to the lowest slot.
// Scores: bf16 x bf16 -> f32, int8 x int8 -> s32 times the row scale (the
// query scale is the caller's, after its merge), f32 x f32 -> f32; slots
// whose ns tag is PAD_TAG or whose ns/canon tag differs from a non-negative
// want score -inf.  Scoring is the tile step of scan_tile.cuh, shared with
// the flat scan (topk.cu).
//
// What bounds them on the H100: bytes.
//   #6 reads Q * nprobe lists of cap x d (a list probed by two queries is
//      read twice); at one query it is a matrix-vector product, ~2 operations
//      a byte.  One block per (query, probe) walks its list 128 slots at a
//      time; warp 0 keeps the sorted top-k list of topk.cu's exact scan.  At
//      one query the grid is only nprobe blocks, so the card is not full:
//      splitting a list over several blocks is the next step.
//   #7 reads each list of the union once for the whole batch.  One block per
//      (union slot, run of buckets, query chunk of <= 64) stages the queries
//      once and walks its buckets; each warp selects for its queries with m
//      rounds of a warp arg-max (lowest slot on ties) and a knock-out.  The
//      union size stays on the device: blocks past it write -inf/-1, as the
//      TPU kernel's padding steps do, so the host never waits for it.
// Not yet: cp.async/TMA double buffering (loads and math do not overlap
// inside a block).

#include <limits.h>
#include <math.h>

#include "scan_tile.cuh"

using namespace tr_tile;

namespace {

constexpr int kPadTag = INT_MIN;
constexpr int kOneQ = 16;   // #6 stages its one query as a 16-row WMMA tile

struct ProbeSmem { size_t q, x, s, m, l, total; };

// kind 0: #6 (one query, a k-long list); kind 1: #7 (qc queries).
__host__ __device__ inline ProbeSmem probe_smem(int kind, int elt, int d, int qc, int k) {
  const int rows = kind == 0 ? kOneQ : qc;
  ProbeSmem o;
  o.q = 0;
  o.x = o.q + q_bytes(elt, d, rows);
  o.s = o.x + x_bytes(elt);
  o.m = o.s + s_bytes(rows);
  o.l = o.m + tr_align128(size_t(kSub) * 8);
  o.total = o.l + (kind == 0 ? size_t(k) * 8 : 0);
  return o;
}

// Tag mask and row scale of the kSub slots [slot0, slot0 + kSub) of a list
// whose first slot is `base`; slots at or past `cap` are masked.
template <bool kInt8>
__device__ inline void slot_mask(const float* __restrict__ scale, const int* __restrict__ ns,
                                 const int* __restrict__ canon, size_t base, int slot0,
                                 int cap, int want_ns, int want_canon, int* okS, float* rsS) {
  for (int r = threadIdx.x; r < kSub; r += kThreads) {
    const int slot = slot0 + r;
    int ok = 0;
    float rs = 0.f;
    if (slot < cap) {
      const int t = ns[base + slot], c = canon[base + slot];
      ok = t != kPadTag && (want_ns < 0 || t == want_ns) && (want_canon < 0 || c == want_canon);
      if constexpr (kInt8) rs = scale[base + slot];
    }
    okS[r] = ok;
    rsS[r] = rs;
  }
}

// Masked score of staged slot r for query row qi of the score tile.
template <bool kInt8>
__device__ inline float masked_score(const void* S, const int* okS, const float* rsS, int qi,
                                     int r) {
  if (!okS[r]) return -INFINITY;
  if constexpr (kInt8) {
    return float(static_cast<const int*>(S)[qi * kSub + r]) * rsS[r];
  } else {
    return static_cast<const float*>(S)[qi * kSub + r];
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
probe_list_kernel(const T* __restrict__ q, const int* __restrict__ lists,
                  const T* __restrict__ vec, const float* __restrict__ scale,
                  const int* __restrict__ ns, const int* __restrict__ canon, int nprobe,
                  int cap, int d, int want_ns, int want_canon, int k,
                  float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const ProbeSmem lay = probe_smem(0, sizeof(T), d, kOneQ, k);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Xs = reinterpret_cast<T*>(smem + lay.x);
  void* S = smem + lay.s;
  int* okS = reinterpret_cast<int*>(smem + lay.m);
  float* rsS = reinterpret_cast<float*>(smem + lay.m) + kSub;
  float* Lsc = reinterpret_cast<float*>(smem + lay.l);
  int* Lid = reinterpret_cast<int*>(Lsc + k);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qp = blockIdx.x;            // query * nprobe + probe
  const size_t base = size_t(lists[qp]) * cap;
  stage_queries(q + size_t(qp / nprobe) * d, 1, d, kOneQ, Qs);
  for (int i = tid; i < k; i += kThreads) {
    Lsc[i] = -INFINITY;
    Lid[i] = INT_MAX;
  }
  for (int slot0 = 0; slot0 < cap; slot0 += kSub) {
    __syncthreads();  // the previous step's readers are done
    slot_mask<kInt8>(scale, ns, canon, base, slot0, cap, want_ns, want_canon, okS, rsS);
    score_step(vec + (base + slot0) * d, cap - slot0, d, kOneQ, Qs, Xs, S);
    __syncthreads();
    if (warp == 0) {
#pragma unroll
      for (int h = 0; h < kSub / 32; ++h) {
        const int r = h * 32 + lane;
        warp_insert(Lsc, Lid, k, masked_score<kInt8>(S, okS, rsS, 0, r), slot0 + r);
      }
    }
  }
  __syncthreads();
  for (int j = tid; j < k; j += kThreads) {
    const float s = Lsc[j];
    out_sc[size_t(qp) * k + j] = s;
    out_id[size_t(qp) * k + j] = s > -INFINITY ? Lid[j] : -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
batched_bucket_kernel(const T* __restrict__ q, const int* __restrict__ uniq,
                      const int* __restrict__ n_uniq, const T* __restrict__ vec,
                      const float* __restrict__ scale, const int* __restrict__ ns,
                      const int* __restrict__ canon, int nq, int cap, int d, int want_ns,
                      int want_canon, int qc, int m, int bpb, float* __restrict__ out_sc,
                      int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  const ProbeSmem lay = probe_smem(1, sizeof(T), d, qc, 0);
  T* Qs = reinterpret_cast<T*>(smem + lay.q);
  T* Xs = reinterpret_cast<T*>(smem + lay.x);
  void* S = smem + lay.s;
  int* okS = reinterpret_cast<int*>(smem + lay.m);
  float* rsS = reinterpret_cast<float*>(smem + lay.m) + kSub;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int u = blockIdx.x;
  const int nb = cap / kSub, cols = m * nb;
  const int b_begin = blockIdx.y * bpb, b_end = min(nb, b_begin + bpb);
  const int q0 = blockIdx.z * qc, nql = min(qc, nq - q0);
  if (b_begin >= b_end) return;
  if (u >= *n_uniq) {  // past the union: defined, never gathered
    const int nbb = b_end - b_begin;
    for (int i = tid; i < nql * m * nbb; i += kThreads) {
      const int qi = i / (m * nbb), p = (i / nbb) % m, b = b_begin + i % nbb;
      const size_t o = (size_t(u) * nq + q0 + qi) * cols + p * nb + b;
      out_sc[o] = -INFINITY;
      out_id[o] = -1;
    }
    return;
  }
  const size_t base = size_t(uniq[u]) * cap;
  stage_queries(q + size_t(q0) * d, nql, d, qc, Qs);
  for (int b = b_begin; b < b_end; ++b) {
    const int slot0 = b * kSub;
    __syncthreads();  // the previous step's readers are done
    slot_mask<kInt8>(scale, ns, canon, base, slot0, cap, want_ns, want_canon, okS, rsS);
    score_step(vec + (base + slot0) * d, kSub, d, qc, Qs, Xs, S);
    __syncthreads();
    for (int qi = warp; qi < nql; qi += kWarps) {
      float v[kSub / 32];
#pragma unroll
      for (int h = 0; h < kSub / 32; ++h) v[h] = masked_score<kInt8>(S, okS, rsS, qi, h * 32 + lane);
      const size_t o = (size_t(u) * nq + q0 + qi) * cols + b;
      for (int p = 0; p < m; ++p) {
        float best = -INFINITY;
        int br = INT_MAX;
#pragma unroll
        for (int h = 0; h < kSub / 32; ++h) {
          const int r = h * 32 + lane;
          if (v[h] > best || (v[h] == best && r < br)) {
            best = v[h];
            br = r;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float os = __shfl_xor_sync(kFull, best, off);
          const int orow = __shfl_xor_sync(kFull, br, off);
          if (os > best || (os == best && orow < br)) {
            best = os;
            br = orow;
          }
        }
        if (lane == 0) {
          out_sc[o + size_t(p) * nb] = best;
          out_id[o + size_t(p) * nb] = best > -INFINITY ? slot0 + br : -1;
        }
#pragma unroll
        for (int h = 0; h < kSub / 32; ++h)
          if (h * 32 + lane == br) v[h] = -INFINITY;  // knock the winner out
      }
    }
  }
}

int elt_of(int dtype) { return dtype == TR_F32 ? 4 : dtype == TR_BF16 ? 2 : 1; }

template <typename K>
int launch_prep(K kern, size_t smem) {
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

}  // namespace

extern "C" size_t tr_probe_smem_bytes(int kind, int dtype, int d, int qc, int k) {
  return probe_smem(kind, elt_of(dtype), d, qc, k).total;
}

// #6: q (nq, d) and vec (nlist, cap, d) share `dtype`; lists (nq * nprobe)
// int32; scale (nlist, cap) f32 is read for int8 only; ns/canon (nlist, cap)
// int32.  Out (nq * nprobe, k): each list's top k, sorted, slot -1 for -inf.
extern "C" int tr_probe_list(const void* q, const void* lists, const void* vec,
                             const void* scale, const void* ns, const void* canon, int nq,
                             int nprobe, int cap, int d, int want_ns, int want_canon, int k,
                             int dtype, void* out_sc, void* out_id, void* stream) {
  if (nq <= 0 || nprobe <= 0 || cap <= 0 || d <= 0 || d % 16 != 0 || k <= 0 || k > kMaxK ||
      k > cap)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = probe_smem(0, elt_of(dtype), d, kOneQ, k).total;
#define TR_PROBE(T)                                                                         \
  do {                                                                                      \
    auto kern = probe_list_kernel<T>;                                                       \
    if (int e = launch_prep(kern, smem)) return e;                                          \
    kern<<<nq * nprobe, kThreads, smem, s>>>(                                               \
        static_cast<const T*>(q), static_cast<const int*>(lists), static_cast<const T*>(vec), \
        static_cast<const float*>(scale), static_cast<const int*>(ns),                     \
        static_cast<const int*>(canon), nprobe, cap, d, want_ns, want_canon, k,             \
        static_cast<float*>(out_sc), static_cast<int*>(out_id));                            \
    return int(cudaGetLastError());                                                         \
  } while (0)
  switch (dtype) {
    case TR_F32: TR_PROBE(float);
    case TR_BF16: TR_PROBE(__nv_bfloat16);
    case TR_I8: TR_PROBE(int8_t);
  }
#undef TR_PROBE
  return int(cudaErrorInvalidValue);
}

// #7: q (nq, d) and vec (nlist, cap, d) share `dtype`; uniq (u_max) int32
// list ids, of which the first *n_uniq (a device int) are live; scale / ns /
// canon as for #6.  cap % 128 == 0.  Grid (u_max, ceil(cap / 128 / bpb),
// ceil(nq / qc)).  Out (u_max, nq, m * cap / 128): pass-major, then bucket.
extern "C" int tr_probe_batched(const void* q, const void* uniq, const void* n_uniq,
                                const void* vec, const void* scale, const void* ns,
                                const void* canon, int nq, int u_max, int cap, int d,
                                int want_ns, int want_canon, int qc, int m, int bpb, int dtype,
                                void* out_sc, void* out_id, void* stream) {
  if (nq <= 0 || u_max <= 0 || cap <= 0 || cap % kSub != 0 || d <= 0 || d % 16 != 0 ||
      qc <= 0 || qc % 16 != 0 || qc > kMaxQc || m < 1 || m > 4 || bpb <= 0)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const size_t smem = probe_smem(1, elt_of(dtype), d, qc, 0).total;
  const int nb = cap / kSub;
  dim3 grid(u_max, (nb + bpb - 1) / bpb, (nq + qc - 1) / qc);
#define TR_BATCHED(T)                                                                        \
  do {                                                                                       \
    auto kern = batched_bucket_kernel<T>;                                                    \
    if (int e = launch_prep(kern, smem)) return e;                                           \
    kern<<<grid, kThreads, smem, s>>>(                                                       \
        static_cast<const T*>(q), static_cast<const int*>(uniq),                            \
        static_cast<const int*>(n_uniq), static_cast<const T*>(vec),                        \
        static_cast<const float*>(scale), static_cast<const int*>(ns),                      \
        static_cast<const int*>(canon), nq, cap, d, want_ns, want_canon, qc, m, bpb,         \
        static_cast<float*>(out_sc), static_cast<int*>(out_id));                             \
    return int(cudaGetLastError());                                                          \
  } while (0)
  switch (dtype) {
    case TR_F32: TR_BATCHED(float);
    case TR_BF16: TR_BATCHED(__nv_bfloat16);
    case TR_I8: TR_BATCHED(int8_t);
  }
#undef TR_BATCHED
  return int(cudaErrorInvalidValue);
}
