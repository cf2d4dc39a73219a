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
// want score -inf.
//
// What bounds them on the H100: bytes.
//   #6 reads Q * nprobe lists of cap x d (a list probed by two queries is
//      read twice); at one query it is a matrix-vector product, ~2 operations
//      a byte.  One block per (query, probe) walks its list 128 slots at a
//      time through scan_tile.cuh's scoring step (staged 128 bytes deep,
//      WMMA); warp 0 keeps the sorted top-k list of topk.cu's exact scan.
//   #7 reads each list of the union once for the whole batch: 2.7 GB at 64
//      queries over the ivf-4M lists, ~2 operations a byte per query, so even
//      at 64 queries bytes bound it (int8: ~175 operations a byte, the card
//      does ~590).  bf16 and int8 lists (pipe_bucket_kernel):
//      - a persistent grid: about one block per SM and query chunk (<= 64
//        queries, staged once), each walking one contiguous range of the
//        flattened items u * nb + b over the live union, whose size it reads
//        on the device; a bucket never straddles two blocks;
//      - a ring of 2-8 stages, each a bucket (128 rows; 64 rows, half a
//        bucket, where three 128-row stages do not fit), filled by the TMA
//        unit from a 2-D tensor map over the lists' bytes: one box of 128
//        bytes x the stage's rows per 128-byte column block (3 copies for an
//        int8 bucket at d 384), stored with the 128-byte swizzle so ldmatrix
//        is conflict-free, columns past d zero-filled, and one bulk copy each
//        for the stage's ns, canon and scale, all completing on the stage's
//        mbarrier, while the block multiplies the stage that landed
//        `stages - 1` stages earlier.  (One bulk copy a row, ~130 a stage,
//        stalled the warps that issued them, so loads and selection did not
//        overlap.)  The barrier that frees a stage comes before its refill,
//        the wait for the next stage after it;
//      - mma.sync (m16n8k32 s8 -> s32, m16n8k16 bf16 -> f32) with rows on M
//        and queries on N in tiles of 8, so 8 queries waste no MMA work; at
//        64 queries a warp multiplies 32 rows x 32 queries (~197 KB of
//        ldmatrix a bucket against ~246 KB for 16 x 64, and half the
//        columns a thread selects for); int8 query rows of up to 384 bytes
//        stay in registers for the whole block (staged in the last ring
//        stage before its first fill, which buys a fourth stage at 64
//        queries), so a bucket's ldmatrix traffic is its rows alone;
//      - selection from the accumulators: each thread masks and scales its
//        scores in registers.  At 32 x 32 a warp transposes its 8 query
//        columns over the 8 lanes of other rows g (three xor-shuffle
//        stages), and each lane keeps the top m of one column's 32 rows;
//        other tiles keep a sorted top m per column of a thread's rows and
//        merge them in three xor-shuffle rounds, by (score desc, slot asc).
//        Each warp's top m of its rows goes to a small table, which one
//        thread per query folds (a merge tree) after the next stage's
//        barrier, writing its m winners (slot -1 for -inf) at a bucket's
//        last stage.  No score tile passes through shared memory.  A warp
//        whose rows of a stage are all masked skips product and selection;
//      - union slots past the live count are written -inf/-1 by the whole
//        grid, so the host never waits for the union's size.
//      f32 lists keep batched_bucket_kernel: one block per (union slot, run
//      of buckets, query chunk) through scan_tile.cuh's scoring step, each
//      warp selecting for its queries with m rounds of a warp arg-max.

#include <cuda.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "scan_tile.cuh"

using namespace tr_mma;
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

// ---- #7 on bf16 and int8 lists: the pipelined bucket probe
constexpr int kBucketWarps = 8;
constexpr int kBucketThreads = 32 * kBucketWarps;
constexpr int kMaxStages = 8;
constexpr int kMaxM = 4;                    // bucket winners a query keeps
constexpr size_t kSmemMax = 232448;         // dynamic shared memory of one block

// Warp tiling of one stage of `rows` rows for qc = 8 nt queries: a warp
// multiplies kMTW m16 row tiles by kNTW n8 query tiles; the 8 warps are
// kWR row tiles x kWQ query groups (at rows 64 and 8 queries, 4 warps idle
// in the product).  Mirrored by ops/ivf_probe.py's _bucket_tiles.
__host__ __device__ constexpr int bucket_mtw(int nt, int rows) {
  return rows == 128 ? (nt >= 2 ? 2 : 1) : (nt >= 4 ? 2 : 1);
}
__host__ __device__ constexpr int bucket_wr(int nt, int rows) {
  return rows / (16 * bucket_mtw(nt, rows));
}

// int8 query rows of at most kQRegBytes: each warp keeps its query
// fragments in registers for the whole block
constexpr int kQRegBytes = 384;

// Shared-memory layout of pipe_bucket_kernel (mirrored by ops/ivf_probe.py's
// _bucket_smem), from a 1024-byte aligned base (1024 bytes of slack): the
// queries (qc rows of d * elt bytes rounded up to the 32-byte MMA step, plus
// 16: an odd number of 16-byte units, so the eight rows an ldmatrix reads
// fall in distinct banks), then `stages` stages, each `boxes` blocks of
// `rows` rows x 128 bytes (the tensor map's swizzled boxes) and the rows'
// ns, canon and scale, rounded up to 1024 bytes; the two tables of the
// warps' winners ([2][row tile][query][kMaxM] scores, then slots); one
// mbarrier per possible stage.  Where the queries live in registers (qreg)
// they are staged in the last ring stage, which the ring first fills after
// the warps have read them.
struct BucketSmem {
  int kbytes, ld, boxes;
  bool qreg;
  size_t q, ring, meta, stage, tab, bar, total;
};

__host__ __device__ inline size_t align1024(size_t x) { return (x + 1023) & ~size_t(1023); }

__host__ __device__ inline BucketSmem bucket_smem(int elt, int d, int qc, int stages, int rows) {
  BucketSmem o;
  o.kbytes = (d * elt + 31) / 32 * 32;
  o.ld = o.kbytes + 16;
  o.boxes = (d * elt + 127) / 128;
  o.qreg = elt == 1 && o.kbytes <= kQRegBytes;
  o.ring = o.qreg ? 0 : align1024(size_t(qc) * o.ld);
  o.meta = size_t(o.boxes) * rows * 128;                   // within a stage
  o.stage = align1024(o.meta + 3 * size_t(rows) * 4);
  o.q = o.qreg ? size_t(stages > 0 ? stages - 1 : 0) * o.stage : 0;
  o.tab = o.ring + size_t(stages) * o.stage;
  o.bar = o.tab + 2 * size_t(bucket_wr(qc / 8, rows)) * qc * kMaxM * 8;
  o.total = 1024 + o.bar + size_t(kMaxStages) * 8;
  return o;
}

// Rows of a stage: 128 (one bucket) where three such stages fit, else 64.
__host__ __device__ inline int bucket_rows(int elt, int d, int qc) {
  const size_t fixed = bucket_smem(elt, d, qc, 0, 128).total;
  const size_t stage = bucket_smem(elt, d, qc, 1, 128).total - fixed;
  return fixed < kSmemMax && (kSmemMax - fixed) / stage >= 3 ? 128 : 64;
}

__device__ inline bool better(float s, int r, float s2, int r2) {
  return s > s2 || (s == s2 && r < r2);
}

__device__ inline void swap_if_better(float& s, int& r, float& s2, int& r2) {
  if (better(s2, r2, s, r)) {
    const float ts = s;
    const int tr = r;
    s = s2;
    r = r2;
    s2 = ts;
    r2 = tr;
  }
}

// a := the top M of the sorted lists a and b (their slots differ): the
// better of a[j] and b[M - 1 - j] keeps the top M (the half-cleaner of a
// bitonic merge), which a sorting network then orders.
template <int M>
__device__ inline void list_merge(float (&as)[M], int (&ar)[M], const float (&bs)[M],
                                  const int (&br)[M]) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (better(bs[M - 1 - j], br[M - 1 - j], as[j], ar[j])) {
      as[j] = bs[M - 1 - j];
      ar[j] = br[M - 1 - j];
    }
  }
  if constexpr (M == 2) {
    swap_if_better(as[0], ar[0], as[1], ar[1]);
  } else if constexpr (M == 3) {
    swap_if_better(as[0], ar[0], as[1], ar[1]);
    swap_if_better(as[1], ar[1], as[2], ar[2]);
    swap_if_better(as[0], ar[0], as[1], ar[1]);
  } else if constexpr (M == 4) {
    swap_if_better(as[0], ar[0], as[1], ar[1]);
    swap_if_better(as[2], ar[2], as[3], ar[3]);
    swap_if_better(as[0], ar[0], as[2], ar[2]);
    swap_if_better(as[1], ar[1], as[3], ar[3]);
    swap_if_better(as[1], ar[1], as[2], ar[2]);
  }
}

// (s, r) into a sorted list of M whose slots all precede r: it passes only
// strictly greater scores.
template <int M>
__device__ inline void list_insert_later(float (&ls)[M], int (&lr)[M], float s, int r) {
#pragma unroll
  for (int j = 0; j < M; ++j) {
    if (s > ls[j]) {
      const float ts = ls[j];
      const int tr = lr[j];
      ls[j] = s;
      lr[j] = r;
      s = ts;
      r = tr;
    }
  }
}

// The sorted top M (score desc, slot asc) of N = 2 or 4 candidates: a
// sorting network (1 or 5 comparators; the best of 4 in 3), then the first
// M, padded with (-inf, INT_MAX).
template <int M, int N>
__device__ inline void top_of(float (&cs)[N], int (&cr)[N], float (&ls)[M], int (&lr)[M]) {
  if constexpr (N == 2) {
    swap_if_better(cs[0], cr[0], cs[1], cr[1]);
  } else if constexpr (M == 1) {
    swap_if_better(cs[0], cr[0], cs[1], cr[1]);
    swap_if_better(cs[2], cr[2], cs[3], cr[3]);
    swap_if_better(cs[0], cr[0], cs[2], cr[2]);
  } else {
    swap_if_better(cs[0], cr[0], cs[1], cr[1]);
    swap_if_better(cs[2], cr[2], cs[3], cr[3]);
    swap_if_better(cs[0], cr[0], cs[2], cr[2]);
    swap_if_better(cs[1], cr[1], cs[3], cr[3]);
    swap_if_better(cs[1], cr[1], cs[2], cr[2]);
  }
#pragma unroll
  for (int p = 0; p < M; ++p) {
    ls[p] = p < N ? cs[p < N ? p : 0] : -INFINITY;
    lr[p] = p < N ? cr[p < N ? p : 0] : INT_MAX;
  }
}

template <typename T, int NT, int kRows, int M>
__global__ void __launch_bounds__(kBucketThreads, 1)
pipe_bucket_kernel(const T* __restrict__ q, const int* __restrict__ uniq,
                   const int* __restrict__ n_uniq, const T* __restrict__ vec,
                   const float* __restrict__ scale, const int* __restrict__ ns,
                   const int* __restrict__ canon, const __grid_constant__ CUtensorMap rows_map,
                   int nq, int u_max, int cap, int d, int want_ns, int want_canon, int stages,
                   float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int qc = 8 * NT;
  constexpr int kMTW = bucket_mtw(NT, kRows);
  constexpr int kWR = bucket_wr(NT, kRows);
  constexpr int kWQ = kBucketWarps / kWR < NT ? kBucketWarps / kWR : NT;
  constexpr int kNTW = NT / kWQ;
  constexpr int kSPB = kSub / kRows;                  // stages a bucket
  constexpr int kTags = kInt8 ? 3 : 2;                // ns, canon (, scale) a stage
  constexpr int kKReg = kInt8 ? kQRegBytes / 32 : 0;  // k steps of queries in registers
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle unit
  const BucketSmem lay = bucket_smem(sizeof(T), d, qc, stages, kRows);
  const int ld = lay.ld, kbytes = lay.kbytes;
  unsigned char* Qs = smem + lay.q;
  float* tabS = reinterpret_cast<float*>(smem + lay.tab);  // [2][kWR][qc][M]
  int* tabR = reinterpret_cast<int*>(tabS + 2 * kWR * qc * kMaxM);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // a stage landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kWR, qb = (warp / kWR) * 8 * kNTW;
  const bool mma_warp = warp / kWR < kWQ;
  const int q0 = blockIdx.y * qc, nql = min(qc, nq - q0);
  const int nb = cap / kSub, cols = M * nb;
  const int nu = min(*n_uniq, u_max);                 // live union slots
  const long long n_items = (long long)nu * nb;       // (slot, bucket) items
  const long long ib = n_items * blockIdx.x / gridDim.x;
  const long long ie = n_items * (blockIdx.x + 1) / gridDim.x;
  const int ntiles = int(ie - ib) * kSPB;
  const int row_bytes = d * int(sizeof(T));

  // queries (zero past nql and past d)
  for (int i = tid; i < qc * (kbytes / 16); i += kBucketThreads) {
    const int r = i / (kbytes / 16), c = (i % (kbytes / 16)) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nql && c < row_bytes)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(q) +
                                          size_t(q0 + r) * row_bytes + c);
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = v;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // tile -> stage tile % stages: the rows' 128-byte column blocks by one
  // tensor-map box each, their ns, canon and scale by one bulk copy each,
  // from threads 0, 1, ...; thread 0 announces all the bytes on the
  // stage's barrier
  auto fetch = [&](int tile) {
    if (tile >= ntiles) return;
    const int stg = tile % stages;
    unsigned char* st = smem + lay.ring + size_t(stg) * lay.stage;
    const long long item = ib + tile / kSPB;
    const size_t slot0 = size_t(__ldg(uniq + item / nb)) * cap + size_t(item % nb) * kSub +
                         (tile % kSPB) * kRows;
    if (tid == 0)
      mbar_arrive_expect_tx(full + stg, uint32_t((lay.boxes * 128 + kTags * 4) * kRows));
    if (tid < lay.boxes) {
      fence_proxy_async();  // the stage's last readers passed the loop's barrier
      tensor_g2s_2d(st + tid * kRows * 128, &rows_map, tid * 128, int(slot0), full + stg);
    } else if (tid < lay.boxes + kTags) {
      const int a = tid - lay.boxes;
      const void* src = a == 0 ? static_cast<const void*>(ns + slot0)
                      : a == 1 ? static_cast<const void*>(canon + slot0)
                               : static_cast<const void*>(scale + slot0);
      fence_proxy_async();
      bulk_g2s(st + lay.meta + a * kRows * 4, src, kRows * 4, full + stg);
    }
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);

  // int8 rows of at most 384 bytes: this warp's query fragments stay in
  // registers for the whole block (96 at 32 queries), so a stage's ldmatrix
  // traffic is its rows alone
  const int r_lo = wr * 16 * kMTW;  // this warp's first row of a stage
  const unsigned char* bq =
      Qs + (qb + (lane & 7) + (kNTW > 1 ? (lane >> 4) << 3 : 0)) * ld + ((lane >> 3) & 1) * 16;
  const bool breg = kKReg > 0 && lay.qreg;
  uint32_t bfr[kKReg > 0 ? kKReg : 1][kNTW][2];
  if constexpr (kKReg > 0) {
#pragma unroll
    for (int ks = 0; ks < kKReg; ++ks) {
      if (breg && mma_warp && ks * 32 < kbytes) {
        if constexpr (kNTW == 1) {
          ldsm_x2(bfr[ks][0], bq + ks * 32);
        } else {
#pragma unroll
          for (int p = 0; p < kNTW / 2; ++p) {
            uint32_t b[4];
            ldsm_x4(b, bq + p * 16 * ld + ks * 32);
            bfr[ks][2 * p][0] = b[0];
            bfr[ks][2 * p][1] = b[1];
            bfr[ks][2 * p + 1][0] = b[2];
            bfr[ks][2 * p + 1][1] = b[3];
          }
        }
      }
    }
  }

  // union slots past the live ones: -inf/-1 over this chunk's rows, spread
  // over the grid (for a slot u they are one contiguous run)
  {
    const long long per_u = (long long)nql * cols;
    const long long dead = (long long)(u_max - nu) * per_u;
    for (long long i = (long long)blockIdx.x * kBucketThreads + tid; i < dead;
         i += (long long)gridDim.x * kBucketThreads) {
      const size_t o = (size_t(nu + i / per_u) * nq + q0) * cols + size_t(i % per_u);
      out_sc[o] = -INFINITY;
      out_id[o] = -1;
    }
  }

  // the fold: query mq (lanes < NT of each warp) merges the row tiles'
  // winners of tile `tile` from its table (a merge tree; every lane computes,
  // so the warp does not diverge) and writes them at a bucket's end
  const int mq = lane * kBucketWarps + warp;
  const bool merger = lane < NT && mq < nql;
  const int mqc = mq < qc ? mq : qc - 1;
  float run_s[M];
  int run_r[M];
#pragma unroll
  for (int p = 0; p < M; ++p) {
    run_s[p] = -INFINITY;
    run_r[p] = INT_MAX;
  }
  auto fold = [&](int tile) {
    float ws[kWR][M];
    int wrr[kWR][M];
    const int base = ((tile & 1) * kWR * qc + mqc) * kMaxM;
#pragma unroll
    for (int w = 0; w < kWR; ++w)
#pragma unroll
      for (int p = 0; p < M; ++p) {
        ws[w][p] = tabS[base + w * qc * kMaxM + p];
        wrr[w][p] = tabR[base + w * qc * kMaxM + p];
      }
#pragma unroll
    for (int step = 1; step < kWR; step *= 2)
#pragma unroll
      for (int w = 0; w + step < kWR; w += 2 * step) list_merge(ws[w], wrr[w], ws[w + step], wrr[w + step]);
    if constexpr (kSPB == 1) {
      if (merger) {  // the bucket closes: slots in the list
        const long long item = ib + tile;
        const int b = int(item % nb);
        const size_t o = (size_t(item / nb) * nq + q0 + mq) * cols + b;
#pragma unroll
        for (int p = 0; p < M; ++p) {
          out_sc[o + size_t(p) * nb] = ws[0][p];
          out_id[o + size_t(p) * nb] = ws[0][p] > -INFINITY ? b * kSub + wrr[0][p] : -1;
        }
      }
    } else if (tile % kSPB == 0) {  // the bucket's first half
#pragma unroll
      for (int p = 0; p < M; ++p) {
        run_s[p] = ws[0][p];
        run_r[p] = wrr[0][p];
      }
    } else {
      list_merge(run_s, run_r, ws[0], wrr[0]);
      if (merger) {
        const long long item = ib + tile / kSPB;
        const int b = int(item % nb);
        const size_t o = (size_t(item / nb) * nq + q0 + mq) * cols + b;
#pragma unroll
        for (int p = 0; p < M; ++p) {
          out_sc[o + size_t(p) * nb] = run_s[p];
          out_id[o + size_t(p) * nb] = run_s[p] > -INFINITY ? b * kSub + run_r[p] : -1;
        }
      }
    }
  };

  for (int it = 0; it < ntiles; ++it) {
    __syncthreads();  // stage (it - 1) % stages is free; table (it - 1) & 1 is full
    fetch(it + stages - 1);
    mbar_wait(full + it % stages, (it / stages) & 1);
    if (it > 0) fold(it - 1);
    if (!mma_warp) continue;
    const unsigned char* st = smem + lay.ring + size_t(it % stages) * lay.stage;
    const int* meta = reinterpret_cast<const int*>(st + lay.meta);
    const int sbase = (it % kSPB) * kRows + r_lo;  // slot in the bucket of row r_lo
    const int tb = ((it & 1) * kWR + wr) * qc * kMaxM;

    // ---- masks and row scales of this thread's rows (g, g + 8 of each tile)
    bool ok[kMTW][2];
    float rs[kMTW][2];
    bool any = false;
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int lr = r_lo + mi * 16 + g + 8 * h;
        const int tg = meta[lr], c = meta[kRows + lr];
        ok[mi][h] = tg != kPadTag && (want_ns < 0 || tg == want_ns) &&
                    (want_canon < 0 || c == want_canon);
        rs[mi][h] = kInt8 ? __int_as_float(meta[2 * kRows + lr]) : 1.f;
        any |= ok[mi][h];
      }
    if (!__any_sync(kFull, any)) {  // every row of this warp masked: -inf winners
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < kNTW; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
#pragma unroll
            for (int p = 0; p < M; ++p) {
              tabS[tb + (qb + j * 8 + 2 * t + e) * kMaxM + p] = -INFINITY;
              tabR[tb + (qb + j * 8 + 2 * t + e) * kMaxM + p] = INT_MAX;
            }
      }
      continue;
    }

    // ---- the product: rows [r_lo, r_lo + 16 kMTW) x queries [qb, qb + 8 kNTW)
    Acc acc[kMTW][kNTW][4];
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
      for (int j = 0; j < kNTW; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = Acc(0);
    // row r of a stage at r * 128 in each 128-byte block; its 16-byte chunk
    // j at (j ^ (r & 7)) * 16, and r & 7 is lane & 7 for every row this
    // lane addresses
    const unsigned char* arow = st + (r_lo + (lane & 15)) * 128;
    auto a_at = [&](int mi, int kb) {
      return arow + (kb >> 7) * (kRows * 128) + mi * 16 * 128 +
             (((((kb & 127) >> 4) + (lane >> 4)) ^ (lane & 7)) << 4);
    };
    auto mma = [&](int mi, int j, const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
      if constexpr (kInt8) mma_s8(acc[mi][j], a, b0, b1);
      else mma_bf16(acc[mi][j], a, b0, b1);
    };
    if (breg) {
#pragma unroll
      for (int ks = 0; ks < (kKReg > 0 ? kKReg : 1); ++ks) {
        if (ks * 32 < kbytes) {
          uint32_t a[kMTW][4];
#pragma unroll
          for (int mi = 0; mi < kMTW; ++mi) ldsm_x4(a[mi], a_at(mi, ks * 32));
#pragma unroll
          for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
            for (int j = 0; j < kNTW; ++j) mma(mi, j, a[mi], bfr[ks][j][0], bfr[ks][j][1]);
        }
      }
    } else {
#pragma unroll 2
      for (int kb = 0; kb < kbytes; kb += 32) {
        uint32_t a[kMTW][4];
#pragma unroll
        for (int mi = 0; mi < kMTW; ++mi) ldsm_x4(a[mi], a_at(mi, kb));
        if constexpr (kNTW == 1) {
          uint32_t b[2];
          ldsm_x2(b, bq + kb);
#pragma unroll
          for (int mi = 0; mi < kMTW; ++mi) mma(mi, 0, a[mi], b[0], b[1]);
        } else {
#pragma unroll
          for (int p = 0; p < kNTW / 2; ++p) {
            uint32_t b[4];
            ldsm_x4(b, bq + p * 16 * ld + kb);
#pragma unroll
            for (int mi = 0; mi < kMTW; ++mi) {
              mma(mi, 2 * p, a[mi], b[0], b[1]);
              mma(mi, 2 * p + 1, a[mi], b[2], b[3]);
            }
          }
        }
      }
    }

    // ---- selection from the accumulators into the table.  Masked rows
    // score -inf; int8 scores are float(acc) * row scale, the plain
    // version's f32 product (|acc| < 2^24, exact in f32).
    auto score = [&](int mi, int j, int h, int e) {
      return !ok[mi][h] ? -INFINITY
             : kInt8   ? float(acc[mi][j][2 * h + e]) * rs[mi][h]
                       : float(acc[mi][j][2 * h + e]);
    };
    if constexpr (kMTW == 2 && kNTW == 4) {
      // 32 rows x 32 queries a warp: a thread holds 8 query columns c = 2j +
      // e of 4 rows g + 8k (k = h + 2 mi).  Three xor-shuffle stages
      // transpose those 8 x 8 packets over the 8 lanes of other g, so lane g
      // holds column g of all 32 rows (v[g'][k] = row g' + 8k); it keeps the
      // column's top M as four chains in slot order, merged.
      float v[8][4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
#pragma unroll
          for (int mi = 0; mi < 2; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) v[2 * j + e][h + 2 * mi] = score(mi, j, h, e);
#pragma unroll
      for (int b = 0; b < 3; ++b) {
        const bool up = (g >> b) & 1;
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          if (c & (1 << b)) continue;
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const float recv =
                __shfl_xor_sync(kFull, up ? v[c][k] : v[c | (1 << b)][k], 4 << b);
            if (up) v[c][k] = recv;
            else v[c | (1 << b)][k] = recv;
          }
        }
      }
      float ls[4][M];
      int lsr[4][M];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int p = 0; p < M; ++p) {
          ls[k][p] = -INFINITY;
          lsr[k][p] = INT_MAX;
        }
#pragma unroll
        for (int gg = 0; gg < 8; ++gg) list_insert_later(ls[k], lsr[k], v[gg][k], sbase + gg + 8 * k);
      }
      list_merge(ls[0], lsr[0], ls[1], lsr[1]);
      list_merge(ls[2], lsr[2], ls[3], lsr[3]);
      list_merge(ls[0], lsr[0], ls[2], lsr[2]);
      const int qi = qb + (g >> 1) * 8 + 2 * t + (g & 1);
#pragma unroll
      for (int p = 0; p < M; ++p) {
        tabS[tb + qi * kMaxM + p] = ls[0][p];
        tabR[tb + qi * kMaxM + p] = lsr[0][p];
      }
    } else {
      // per query column: the sorted top M of this thread's rows, merged
      // over the 8 lanes of other rows g
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float cs[2 * kMTW];
          int cr[2 * kMTW];
#pragma unroll
          for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              cs[2 * mi + h] = score(mi, j, h, e);
              cr[2 * mi + h] = sbase + mi * 16 + g + 8 * h;
            }
          float ls[M];
          int lsr[M];
          top_of(cs, cr, ls, lsr);
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            float os[M];
            int osr[M];
#pragma unroll
            for (int p = 0; p < M; ++p) {
              os[p] = __shfl_xor_sync(kFull, ls[p], off);
              osr[p] = __shfl_xor_sync(kFull, lsr[p], off);
            }
            list_merge(ls, lsr, os, osr);
          }
          if (g == 0) {
            const int qi = qb + j * 8 + 2 * t + e;
#pragma unroll
            for (int p = 0; p < M; ++p) {
              tabS[tb + qi * kMaxM + p] = ls[p];
              tabR[tb + qi * kMaxM + p] = lsr[p];
            }
          }
        }
    }
  }
  if (ntiles > 0) {
    __syncthreads();
    fold(ntiles - 1);
  }
}

struct BucketArgs {
  const void *q, *uniq, *n_uniq, *vec, *scale, *ns, *canon;
  CUtensorMap rows_map;
  int nq, u_max, cap, d, want_ns, want_canon, stages, blocks;
  void *out_sc, *out_id;
  cudaStream_t stream;
};

template <typename T, int NT, int R, int M>
int launch_bucket(const BucketArgs& a) {
  const size_t smem = bucket_smem(sizeof(T), a.d, 8 * NT, a.stages, R).total;
  auto kern = pipe_bucket_kernel<T, NT, R, M>;
  if (int e = int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem))))
    return e;
  dim3 grid(a.blocks, (a.nq + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kBucketThreads, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const int*>(a.uniq),
      static_cast<const int*>(a.n_uniq), static_cast<const T*>(a.vec),
      static_cast<const float*>(a.scale), static_cast<const int*>(a.ns),
      static_cast<const int*>(a.canon), a.rows_map, a.nq, a.u_max, a.cap, a.d, a.want_ns,
      a.want_canon, a.stages, static_cast<float*>(a.out_sc), static_cast<int*>(a.out_id));
  return int(cudaGetLastError());
}

template <typename T, int NT, int R>
int launch_bucket_m(int m, const BucketArgs& a) {
  switch (m) {
    case 1: return launch_bucket<T, NT, R, 1>(a);
    case 2: return launch_bucket<T, NT, R, 2>(a);
    case 3: return launch_bucket<T, NT, R, 3>(a);
    case 4: return launch_bucket<T, NT, R, 4>(a);
  }
  return int(cudaErrorInvalidValue);
}

template <typename T>
int launch_bucket_qc(int qc, int rows, int m, const BucketArgs& a) {
#define TR_BUCKET(NT) \
  (rows == 128 ? launch_bucket_m<T, NT, 128>(m, a) : launch_bucket_m<T, NT, 64>(m, a))
  switch (qc) {
    case 8: return TR_BUCKET(1);
    case 16: return TR_BUCKET(2);
    case 32: return TR_BUCKET(4);
    case 64: return TR_BUCKET(8);
  }
#undef TR_BUCKET
  return int(cudaErrorInvalidValue);
}

int elt_of(int dtype) { return dtype == TR_F32 ? 4 : dtype == TR_BF16 ? 2 : 1; }

template <typename K>
int launch_prep(K kern, size_t smem) {
  return int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem)));
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (the runtime API has no tensor maps; linking libcuda would tie the
// library to a driver stub).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// The lists' rows as a 2-D tensor of bytes (row_bytes x rows), read in boxes
// of 128 bytes x box_rows with the 128-byte swizzle; columns past row_bytes
// read as zero.
bool rows_tensor_map(CUtensorMap* map, const void* base, long long rows, int row_bytes,
                     int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {cuuint64_t(row_bytes), cuuint64_t(rows)};
  const cuuint64_t strides[1] = {cuuint64_t(row_bytes)};
  const cuuint32_t box[2] = {128, cuuint32_t(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Shared-memory bytes of one block: kind 0, #6 (a k-long list); kind 1, #7
// (qc queries): f32 lists batched_bucket_kernel, bf16/int8 lists
// pipe_bucket_kernel with `stages` ring stages of bucket_rows rows.
extern "C" size_t tr_probe_smem_bytes(int kind, int dtype, int d, int qc, int k, int stages) {
  if (kind == 1 && dtype != TR_F32) {
    const int elt = elt_of(dtype);
    return bucket_smem(elt, d, qc, stages, bucket_rows(elt, d, qc)).total;
  }
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
// canon as for #6.  cap % 128 == 0, 1 <= m <= 4.  Out (u_max, nq, m * cap /
// 128): pass-major, then bucket.  Query chunks of qc on the last grid axis.
//   bf16/int8 (pipe_bucket_kernel): qc in {8, 16, 32, 64}, 2 <= stages <= 8,
//     `blocks` blocks a chunk; q, vec, ns, canon (and scale for int8)
//     16-byte aligned (bulk copies).
//   f32 (batched_bucket_kernel): qc % 16 == 0, stages ignored; each list's
//     buckets split over `blocks` blocks: grid (u_max, blocks, chunks).
extern "C" int tr_probe_batched(const void* q, const void* uniq, const void* n_uniq,
                                const void* vec, const void* scale, const void* ns,
                                const void* canon, int nlist, int nq, int u_max, int cap, int d,
                                int want_ns, int want_canon, int qc, int m, int stages,
                                int blocks, int dtype, void* out_sc, void* out_id,
                                void* stream) {
  if (nlist <= 0 || nq <= 0 || u_max <= 0 || cap <= 0 || cap % kSub != 0 || d <= 0 ||
      d % 16 != 0 || qc <= 0 || qc > kMaxQc || m < 1 || m > kMaxM || blocks <= 0)
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int nb = cap / kSub;
  if (dtype == TR_BF16 || dtype == TR_I8) {
    const int elt = elt_of(dtype), rows = bucket_rows(elt, d, qc);
    if ((qc != 8 && qc != 16 && qc != 32 && qc != 64) || stages < 2 || stages > kMaxStages ||
        !aligned16(q) || !aligned16(vec) || !aligned16(ns) || !aligned16(canon) ||
        (dtype == TR_I8 && !aligned16(scale)) ||
        bucket_smem(elt, d, qc, stages, rows).total > kSmemMax)
      return int(cudaErrorInvalidValue);
    BucketArgs a{q, uniq, n_uniq, vec, scale, ns, canon, {}, nq, u_max, cap, d,
                 want_ns, want_canon, stages, blocks, out_sc, out_id, s};
    if (!rows_tensor_map(&a.rows_map, vec, (long long)nlist * cap, d * elt, rows))
      return int(cudaErrorInvalidValue);
    return dtype == TR_BF16 ? launch_bucket_qc<__nv_bfloat16>(qc, rows, m, a)
                            : launch_bucket_qc<int8_t>(qc, rows, m, a);
  }
  if (dtype != TR_F32 || qc % 16 != 0) return int(cudaErrorInvalidValue);
  const size_t smem = probe_smem(1, 4, d, qc, 0).total;
  const int bpb = (nb + blocks - 1) / blocks;
  dim3 grid(u_max, (nb + bpb - 1) / bpb, (nq + qc - 1) / qc);
  auto kern = batched_bucket_kernel<float>;
  if (int e = launch_prep(kern, smem)) return e;
  kern<<<grid, kThreads, smem, s>>>(
      static_cast<const float*>(q), static_cast<const int*>(uniq),
      static_cast<const int*>(n_uniq), static_cast<const float*>(vec),
      static_cast<const float*>(scale), static_cast<const int*>(ns),
      static_cast<const int*>(canon), nq, cap, d, want_ns, want_canon, qc, m, bpb,
      static_cast<float*>(out_sc), static_cast<int*>(out_id));
  return int(cudaGetLastError());
}
