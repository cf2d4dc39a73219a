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
// bf16 or int8; 300-770 MB at the main path's shapes).  At 64 queries the
// product is 49 GFLOP at 1M x 384 (50 us at peak, against ~230 us of bytes),
// so bytes bound it: loads must stay in flight all the time, and the
// selection must stay off the critical path.
//
// bf16 and int8 (pipe_scan_kernel):
//   - a persistent grid: one block of 8 warps per SM (per query chunk),
//     each walking one contiguous range of rows (a multiple of 128, so a
//     bucket never straddles two blocks, and candidates come out in row
//     order for the caller's stable merge);
//   - a ring of 2-8 stages in shared memory, each a full-depth tile of 64
//     rows (48 KB bf16, 24 KB int8 at d 384; 128 rows for a chunk of 8
//     queries where that keeps 64 KB in flight) plus the rows' ns, canon
//     and scale, filled while the block multiplies the tile that landed
//     `stages - 1` tiles earlier: each row by one bulk copy (the TMA unit;
//     thread r copies row r, thread 0 announces the tile's bytes on the
//     stage's mbarrier), the tags by cp.async.  With 16-byte cp.async the
//     copying warps stalled on the SM's outstanding-load limit, so the
//     selection never overlapped the loads;
//   - the product on the tensor cores with mma.sync (m16n8k16 bf16 -> f32,
//     m16n8k32 s8 -> s32), rows on the M side (16 a warp) and queries on the
//     N side in tiles of 8, so 1 or 8 queries waste no MMA work; operands
//     by ldmatrix from rows padded by 16 bytes (conflict-free);
//   - exact/packed: each thread compares its scores, straight from the
//     accumulator registers, with its queries' thresholds (the sorted
//     list's last entry, kept in registers, never below the caller's seed),
//     lowest row winning a tie; only a candidate's score goes to shared
//     memory (and its row to its query's bit mask), and only when some
//     thread found one do the list owners (warp w keeps queries w, w + 8,
//     ...) merge a mask word's candidates into the list at once
//     (warp_merge, select.cuh: one pass over the list, where warp_insert
//     takes one shift per candidate);
//   - bucketed: each warp reduces its 16 rows per query with shuffles, and
//     one thread per query folds the row tiles of a stage, in row order,
//     and closes a 128-row bucket at its last row.
// f32 databases keep the first version (scan_kernel): one block holds up
// to 64 queries and walks its rows 128 at a time, staged 128 bytes deep,
// CUDA-core FMAs (no TF32), the same selections.  The sorted insertion
// lives in scan_tile.cuh, shared with the IVF probe kernels (ivf_probe.cu).
//
// Output: exact/packed -> (nq, n_blocks, k) candidates, sorted within a block's
// range, with id -1 for -inf slots (the caller merges them with a stable sort);
// bucketed -> (nq, ceil(n / 128)) bucket maxima and their rows.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "mma_sm90.cuh"
#include "scan_tile.cuh"
#include "select.cuh"

using namespace tr_mma;
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

// ---- bf16 / int8: the pipelined scan
constexpr int kPipeWarps = 8;
constexpr int kPipeThreads = 32 * kPipeWarps;
constexpr int kMaxStages = 8;
constexpr int kSmemMax = 232448;            // dynamic shared memory of one block

// Shared-memory layout of pipe_scan_kernel (mirrored by ops/topk.py's
// _pipe_smem).  A staged row is its d * elt bytes rounded up to the 32-byte
// MMA step, plus 16 bytes: an odd number of 16-byte units, so the eight
// rows an ldmatrix reads fall in distinct banks.
struct PipeSmem { int kbytes, ld; size_t qs, ring, meta, stage, list, scratch, cmask, bmap, bar, total; };

__host__ __device__ inline PipeSmem pipe_smem(int elt, int d, int qc, int k, int mode,
                                              int stages, int rows) {
  PipeSmem o;
  o.kbytes = (d * elt + 31) / 32 * 32;
  o.ld = o.kbytes + 16;
  o.qs = tr_align128(size_t(qc) * o.ld);                   // queries at 0
  o.ring = o.qs + tr_align128(size_t(qc) * 4);             // then query scales
  o.meta = tr_align128(size_t(rows) * o.ld);               // ns, canon, scale after the rows
  o.stage = o.meta + 3 * rows * 4;
  o.list = o.ring + size_t(stages) * o.stage;
  const bool list = mode != kBucketed;
  o.scratch = o.list + (list ? tr_align128(size_t(qc) * k * 8) : 0);
  o.cmask = o.scratch + tr_align128(list ? size_t(rows) * (qc + 1) * 4
                                         : size_t(rows / 16) * qc * 8);
  o.bmap = o.cmask + (list ? tr_align128(size_t(qc) * (rows / 32) * 4) : 0);
  o.bar = o.bmap + (list ? size_t(kPipeWarps) * 32 * 4 : 0);  // a 1024-bit map a warp
  o.total = o.bar + size_t(kMaxStages) * 8;                     // a stage's mbarrier
  return o;
}

// Stages of `rows` rows that fit beside the rest of a block's shared memory.
__host__ __device__ inline size_t pipe_fit(int elt, int d, int qc, int k, int mode, int rows) {
  const size_t fixed = pipe_smem(elt, d, qc, k, mode, 0, rows).total;
  const size_t stage = pipe_smem(elt, d, qc, k, mode, 1, rows).total - fixed;
  const size_t fit = fixed < size_t(kSmemMax) ? (size_t(kSmemMax) - fixed) / stage : 0;
  return fit < size_t(kMaxStages) ? fit : size_t(kMaxStages);
}

// Rows of one ring stage: 128 (one m16 tile a warp) for a chunk of 8
// queries where the stages that fit beside the lists keep 64 KB of rows in
// flight, else 64, the 8 warps then splitting the queries in two halves (a
// chunk of 8: 4 warps multiply); 32 (2 warps multiply) for a chunk of 8
// where two 64-row stages do not fit beside the lists (bf16 at d 768 and
// k above 252: a 64-row stage is 100,096 bytes there).
__host__ __device__ inline int pipe_rows(int elt, int d, int qc, int k, int mode) {
  if (qc != 8) return 64;
  const size_t stages = pipe_fit(elt, d, qc, k, mode, 128);
  if (stages >= 2 && (stages - 1) * 128 * d * elt >= 65536) return 128;
  return pipe_fit(elt, d, qc, k, mode, 64) >= 2 ? 64 : 32;
}

template <typename T, int kMode, int NT, int kRows>
__global__ void __launch_bounds__(kPipeThreads, 1)
pipe_scan_kernel(const T* __restrict__ q, const T* __restrict__ x,
                 const float* __restrict__ scale, const int* __restrict__ ns,
                 const int* __restrict__ canon, const float* __restrict__ qscale,
                 int n, int d, int nq, int want_ns, int want_canon, int block_rows,
                 int k, int stages, const float* __restrict__ seed,
                 float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr bool kList = kMode != kBucketed;
  constexpr int qc = 8 * NT;
  constexpr int kMT = kRows / 16;              // m16 row tiles of a stage
  constexpr int kGroups = kPipeWarps / kMT < NT ? kPipeWarps / kMT : NT;  // query groups
  constexpr int NTW = NT / kGroups;            // n8 query tiles of one warp
  constexpr int kSld = qc + 1;                 // score scratch row stride
  constexpr int kWords = kRows / 32;           // candidate bit mask words of a query
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem[];
  const PipeSmem lay = pipe_smem(sizeof(T), d, qc, k, kMode, stages, kRows);
  const int ld = lay.ld, kbytes = lay.kbytes;
  unsigned char* Qs = smem;
  float* qsS = reinterpret_cast<float*>(smem + lay.qs);
  float* Lsc = reinterpret_cast<float*>(smem + lay.list);
  int* Lid = reinterpret_cast<int*>(Lsc + qc * k);
  float* Sc = reinterpret_cast<float*>(smem + lay.scratch);  // exact: [kRows][kSld]
  int* Sr = reinterpret_cast<int*>(Sc + kMT * qc);           // bucketed: [kMT][qc] rows
  unsigned* cmask = reinterpret_cast<unsigned*>(smem + lay.cmask);  // [qc][kWords]
  unsigned* bmap = reinterpret_cast<unsigned*>(smem + lay.bmap) + 32 * (threadIdx.x >> 5);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // a stage's rows landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int mt = warp % kMT, grp = warp / kMT, qb = grp * 8 * NTW;
  const bool mma_warp = grp < kGroups;  // else idle in the product (64 rows, 8 queries)
  const int q0 = blockIdx.y * qc;
  const int nql = min(qc, nq - q0);
  const int row_begin = blockIdx.x * block_rows;
  const int row_end = min(n, row_begin + block_rows);
  const int ntiles = (row_end - row_begin + kRows - 1) / kRows;
  const int row_bytes = d * int(sizeof(T));
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x);

  // queries (zero past nql and past d), query scales, lists; the ring's
  // pad columns past d are zeroed once (cp.async never writes them)
  for (int i = tid; i < qc * (kbytes / 16); i += kPipeThreads) {
    const int r = i / (kbytes / 16), c = (i % (kbytes / 16)) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nql && c < row_bytes)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(q) +
                                          size_t(q0 + r) * row_bytes + c);
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = v;
  }
  for (int i = tid; i < qc; i += kPipeThreads)
    qsS[i] = (kInt8 && kList && i < nql) ? qscale[q0 + i] : 1.f;
  if (kbytes > row_bytes)
    for (int i = tid; i < stages * kRows; i += kPipeThreads)
      *reinterpret_cast<uint4*>(smem + lay.ring + size_t(i / kRows) * lay.stage +
                                (i % kRows) * ld + row_bytes) = make_uint4(0, 0, 0, 0);
  if constexpr (kList) {
    for (int i = tid; i < qc * k; i += kPipeThreads) {
      Lsc[i] = -INFINITY;
      Lid[i] = INT_MAX;
    }
    for (int i = tid; i < qc * kWords; i += kPipeThreads) cmask[i] = 0u;
    for (int i = tid; i < kPipeWarps * 32; i += kPipeThreads)
      reinterpret_cast<unsigned*>(smem + lay.bmap)[i] = 0u;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // tile -> stage tile % stages: row r by one bulk copy from thread r (the
  // TMA unit moves the bytes; thread 0 announces them on the stage's
  // barrier), the rows' ns, canon and scale by cp.async in one commit group
  // (empty past the last tile)
  auto fetch = [&](int tile) {
    if (tile < ntiles) {
      const int stg = tile % stages;
      unsigned char* st = smem + lay.ring + size_t(stg) * lay.stage;
      const int r0 = row_begin + tile * kRows;
      const int nrows = min(kRows, row_end - r0);
      if (tid == 0) mbar_arrive_expect_tx(full + stg, uint32_t(nrows * row_bytes));
      if (tid < nrows) {
        fence_proxy_async();  // the stage's last readers passed the loop's barrier
        bulk_g2s(st + tid * ld, xb + size_t(r0 + tid) * row_bytes, row_bytes, full + stg);
      }
      int* meta = reinterpret_cast<int*>(st + lay.meta);
      for (int i = tid; i < 3 * kRows; i += kPipeThreads) {
        const int a = i / kRows, row = r0 + i % kRows;
        const bool ok = row < row_end && (a < 2 || kInt8);
        const void* m = !ok ? static_cast<const void*>(ns)
                        : a == 0 ? static_cast<const void*>(ns + row)
                        : a == 1 ? static_cast<const void*>(canon + row)
                                 : static_cast<const void*>(scale + row);
        cp_async4(meta + i, m, ok);
      }
    }
    cp_commit();
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);

  // thresholds of this thread's queries (qb + j * 8 + 2t + e): the lists'
  // last entries, never below the seed (a lower bound of each query's k-th
  // score over all rows, or -inf), which a row scoring at least it passes
  float thr_s[2 * NTW], seed_s[2 * NTW];
  int thr_r[2 * NTW];
#pragma unroll
  for (int i = 0; i < 2 * NTW; ++i) {
    const int qi = qb + (i >> 1) * 8 + 2 * t + (i & 1);
    seed_s[i] = seed != nullptr && mma_warp && qi < nql ? seed[q0 + qi] : -INFINITY;
    thr_s[i] = seed_s[i];
    thr_r[i] = INT_MAX;
  }
  float bbest = -INFINITY;  // bucketed: thread tid's query, the open bucket
  int brow = INT_MAX;
  const int lr[2] = {mt * 16 + g, mt * 16 + g + 8};

  for (int it = 0; it < ntiles; ++it) {
    cp_wait_dyn(stages - 2);                           // this thread's tags of tile it
    mbar_wait(full + it % stages, (it / stages) & 1);  // its rows
    __syncthreads();  // everyone's tags; stage (it - 1) % stages is free
    fetch(it + stages - 1);
    const unsigned char* st = smem + lay.ring + size_t(it % stages) * lay.stage;
    const int* meta = reinterpret_cast<const int*>(st + lay.meta);
    const int r0 = row_begin + it * kRows;

    // ---- the product: rows [16 mt, 16 mt + 16) x queries [qb, qb + 8 NTW)
    Acc acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = Acc(0);
    const unsigned char* arow = st + (mt * 16 + (lane & 15)) * ld + (lane >> 4) * 16;
    const unsigned char* bq =
        Qs + (qb + (lane & 7) + (NTW > 1 ? (lane >> 4) << 3 : 0)) * ld + ((lane >> 3) & 1) * 16;
#pragma unroll 2
    for (int kb = 0; mma_warp && kb < kbytes; kb += 32) {
      uint32_t a[4];
      ldsm_x4(a, arow + kb);
      if constexpr (NTW == 1) {
        uint32_t b[2];
        ldsm_x2(b, bq + kb);
        if constexpr (kInt8) mma_s8(acc[0], a, b[0], b[1]);
        else mma_bf16(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < NTW / 2; ++p) {
          uint32_t b[4];
          ldsm_x4(b, bq + p * 16 * ld + kb);
          if constexpr (kInt8) {
            mma_s8(acc[2 * p], a, b[0], b[1]);
            mma_s8(acc[2 * p + 1], a, b[2], b[3]);
          } else {
            mma_bf16(acc[2 * p], a, b[0], b[1]);
            mma_bf16(acc[2 * p + 1], a, b[2], b[3]);
          }
        }
      }
    }

    // ---- scores: masked, scaled, rounded (packed); rows g and g + 8
    bool ok[2];
    float rs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int tg = meta[lr[h]], c = meta[kRows + lr[h]];
      ok[h] = r0 + lr[h] < row_end && tg != kPadTag && (want_ns < 0 || tg == want_ns) &&
              (want_canon < 0 || c == want_canon);
      rs[h] = kInt8 ? __int_as_float(meta[2 * kRows + lr[h]]) : 1.f;
    }
    float sc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qb + j * 8 + 2 * t + (e & 1), h = e >> 1;
        float s;
        if constexpr (kInt8) {
          // exact/packed: (acc * query scale) * row scale, in the reference's
          // order; bucketed: the caller applies the query scale after selection
          const float a = float(acc[j][e]);
          s = kList ? (a * qsS[qi]) * rs[h] : a * rs[h];
        } else {
          s = acc[j][e];
        }
        s = (ok[h] && qi < nql && mma_warp) ? s : -INFINITY;
        sc[j][e] = kMode == kPacked ? round18(s) : s;
      }
    }

    if constexpr (kList) {
      // a candidate beats its query's threshold: its score goes to the
      // scratch and its row to the query's bit mask
      bool mine = false;
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 2 * j + (e & 1), l = lr[e >> 1], qi = qb + j * 8 + 2 * t + (e & 1);
          const float s = sc[j][e];
          if (s > -INFINITY && (s > thr_s[i] || (s == thr_s[i] && r0 + l < thr_r[i]))) {
            Sc[l * kSld + qi] = s;
            atomicOr(cmask + qi * kWords + (l >> 5), 1u << (l & 31));
            mine = true;
          }
        }
      if (__syncthreads_or(mine)) {
        // list owners: warp w keeps queries w, w + 8, ...; lane l reads the
        // mask word l % kWords of its (l / kWords)-th query, and each word
        // that holds a candidate is one merge
        const int nown = (nql - warp + kPipeWarps - 1) / kPipeWarps;
        const int wi = (warp + kPipeWarps * (lane / kWords)) * kWords + lane % kWords;
        const unsigned wb = lane < nown * kWords ? cmask[wi] : 0u;
        for (unsigned todo = __ballot_sync(kFull, wb != 0u); todo; todo &= todo - 1) {
          const int src = __ffs(todo) - 1;
          const unsigned bits = __shfl_sync(kFull, wb, src);
          const int qi = warp + kPipeWarps * (src / kWords), l = (src % kWords) * 32 + lane;
          warp_merge(Lsc + qi * k, Lid + qi * k, k,
                     (bits >> lane) & 1u ? Sc[l * kSld + qi] : -INFINITY, r0 + l, bmap);
        }
        if (wb) cmask[wi] = 0u;
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 2 * NTW; ++i) {
          const int qi = qb + (i >> 1) * 8 + 2 * t + (i & 1);
          if (mma_warp) {  // an idle warp's queries lie past the lists
            const float ls = Lsc[qi * k + k - 1];
            const int li = Lid[qi * k + k - 1];
            if (better(ls, li, seed_s[i], INT_MAX)) {
              thr_s[i] = ls;
              thr_r[i] = li;
            }
          }
        }
      }
    } else {
      // per query: the max of this warp's 16 rows, lowest row on a tie
#pragma unroll
      for (int j = 0; j < NTW; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float best = sc[j][e];
          int bro = r0 + lr[0];
          if (sc[j][e + 2] > best) {  // row g + 8 comes after row g
            best = sc[j][e + 2];
            bro = r0 + lr[1];
          }
#pragma unroll
          for (int off = 4; off < 32; off <<= 1) {
            const float os = __shfl_xor_sync(kFull, best, off);
            const int orow = __shfl_xor_sync(kFull, bro, off);
            if (os > best || (os == best && orow < bro)) {
              best = os;
              bro = orow;
            }
          }
          if (g == 0 && mma_warp) {
            Sc[mt * qc + qb + j * 8 + 2 * t + e] = best;
            Sr[mt * qc + qb + j * 8 + 2 * t + e] = bro;
          }
        }
      __syncthreads();
      if (tid < nql) {
#pragma unroll
        for (int m = 0; m < kMT; ++m) {  // row tiles in row order
          const float s = Sc[m * qc + tid];
          const int r = Sr[m * qc + tid];
          if (s > bbest || (s == bbest && r < brow)) {
            bbest = s;
            brow = r;
          }
        }
        if ((r0 + kRows) % kSub == 0 || it == ntiles - 1) {  // the bucket closes
          const size_t nb = (size_t(n) + kSub - 1) / kSub;
          const size_t o = size_t(q0 + tid) * nb + r0 / kSub;
          out_sc[o] = bbest;
          out_id[o] = brow;
          bbest = -INFINITY;
          brow = INT_MAX;
        }
      }
    }
  }
  cp_wait<0>();

  if constexpr (kList) {
    __syncthreads();
    for (int i = tid; i < nql * k; i += kPipeThreads) {
      const int qi = i / k, j = i % k;
      const float s = Lsc[qi * k + j];
      const size_t o = (size_t(q0 + qi) * gridDim.x + blockIdx.x) * k + j;
      out_sc[o] = s;
      out_id[o] = s > -INFINITY ? Lid[qi * k + j] : -1;
    }
  }
}

template <typename T, int kMode, int NT, int kRows>
int launch_pipe(const void* q, const void* x, const void* scale, const void* ns,
                const void* canon, const void* qscale, int n, int d, int nq, int want_ns,
                int want_canon, int block_rows, int k, int stages, const void* seed,
                void* out_sc, void* out_id, cudaStream_t stream) {
  const size_t smem = pipe_smem(sizeof(T), d, 8 * NT, k, kMode, stages, kRows).total;
  auto kern = pipe_scan_kernel<T, kMode, NT, kRows>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  dim3 grid((n + block_rows - 1) / block_rows, (nq + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kPipeThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(x), static_cast<const float*>(scale),
      static_cast<const int*>(ns), static_cast<const int*>(canon),
      static_cast<const float*>(qscale), n, d, nq, want_ns, want_canon, block_rows, k, stages,
      static_cast<const float*>(seed), static_cast<float*>(out_sc), static_cast<int*>(out_id));
  return int(cudaGetLastError());
}

template <typename T, int kMode>
int launch_pipe_qc(int qc, int rows, const void* q, const void* x, const void* scale,
                   const void* ns, const void* canon, const void* qscale, int n, int d,
                   int nq, int want_ns, int want_canon, int block_rows, int k, int stages,
                   const void* seed, void* out_sc, void* out_id, cudaStream_t stream) {
#define TR_PIPE(NT, R) \
  launch_pipe<T, kMode, NT, R>(q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, \
                               block_rows, k, stages, seed, out_sc, out_id, stream)
  switch (qc) {
    case 8: return rows == 128 ? TR_PIPE(1, 128) : rows == 64 ? TR_PIPE(1, 64) : TR_PIPE(1, 32);
    case 16: return TR_PIPE(2, 64);
    case 32: return TR_PIPE(4, 64);
    case 64: return TR_PIPE(8, 64);
  }
#undef TR_PIPE
  return int(cudaErrorInvalidValue);
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

// Shared-memory bytes of one scan block: f32 (scan_kernel) or, for bf16 and
// int8, pipe_scan_kernel with `stages` ring stages.
extern "C" size_t tr_scan_smem_bytes(int dtype, int d, int qc, int k, int mode, int stages) {
  if (dtype == TR_F32) return scan_smem(4, d, qc, k, mode != kBucketed).total;
  const int elt = elt_of(dtype);
  return pipe_smem(elt, d, qc, k, mode, stages, pipe_rows(elt, d, qc, k, mode)).total;
}

// mode 1 (exact, #1) or 2 (packed, #2) -> out (nq, ceil(n / tile_rows), k);
// mode 0 (bucketed, #3) -> out (nq, ceil(n / 128)).
// q (nq, d) and x (n, d) share `dtype`; scale (n,) and qscale (nq,) f32 are
// read for int8 only; ns/canon (n,) int32.  Each block scans tile_rows
// consecutive rows (a multiple of 128) for qc queries.  bf16 and int8 take
// qc in {8, 16, 32, 64}, 2 <= stages <= 8 and 16-byte aligned q and x, and
// for exact/packed an optional seed (nq,) f32: a lower bound of each
// query's k-th score, below which no row is a candidate; f32 takes
// qc % 16 == 0 and ignores stages and seed.
extern "C" int tr_scan(const void* q, const void* x, const void* scale,
                       const void* ns, const void* canon, const void* qscale,
                       int n, int d, int nq, int want_ns, int want_canon,
                       int tile_rows, int qc, int k, int mode, int dtype, int stages,
                       const void* seed, void* out_sc, void* out_id, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % 16 != 0 || tile_rows <= 0 ||
      tile_rows % kSub != 0 || qc <= 0 || qc > kMaxQc ||
      mode < kBucketed || mode > kPacked ||
      (mode != kBucketed && (k <= 0 || k > kMaxDeepK)))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == TR_F32) {
    if (qc % 16 != 0) return int(cudaErrorInvalidValue);
#define TR_SCAN(M) \
  launch<float, M>(q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, tile_rows, qc, k, out_sc, out_id, s)
    return mode == kExact ? TR_SCAN(kExact) : mode == kPacked ? TR_SCAN(kPacked) : TR_SCAN(kBucketed);
#undef TR_SCAN
  }
  const int elt = elt_of(dtype), rows = pipe_rows(elt, d, qc, k, mode);
  if ((dtype != TR_BF16 && dtype != TR_I8) || stages < 2 || stages > kMaxStages ||
      reinterpret_cast<uintptr_t>(q) % 16 != 0 || reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
      pipe_smem(elt, d, qc, k, mode, stages, rows).total > size_t(kSmemMax))
    return int(cudaErrorInvalidValue);
#define TR_PIPE(T, M) \
  launch_pipe_qc<T, M>(qc, rows, q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, tile_rows, k, stages, seed, out_sc, out_id, s)
#define TR_MODES(T) \
  (mode == kExact ? TR_PIPE(T, kExact) : mode == kPacked ? TR_PIPE(T, kPacked) : TR_PIPE(T, kBucketed))
  return dtype == TR_BF16 ? TR_MODES(__nv_bfloat16) : TR_MODES(int8_t);
#undef TR_MODES
#undef TR_PIPE
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
