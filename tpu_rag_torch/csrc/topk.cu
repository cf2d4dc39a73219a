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
// int8 rows (pipe_scan_kernel):
//   - a persistent grid: one block of 8 warps per SM (per query chunk),
//     each walking one contiguous range of rows (a multiple of 128, so a
//     bucket never straddles two blocks, and candidates come out in row
//     order for the caller's stable merge);
//   - a ring of 2-8 stages in shared memory, each a full-depth tile of 64
//     rows (24 KB at d 384; 128 rows for a chunk of 8 queries where that
//     keeps 64 KB in flight) plus the rows' ns, canon
//     and scale, filled while the block multiplies the tile that landed
//     `stages - 1` tiles earlier: each row by one bulk copy (the TMA unit;
//     thread r copies row r, thread 0 announces the tile's bytes on the
//     stage's mbarrier), the tags by cp.async.  With 16-byte cp.async the
//     copying warps stalled on the SM's outstanding-load limit, so the
//     selection never overlapped the loads;
//   - the product on the tensor cores with mma.sync (m16n8k32 s8 -> s32),
//     rows on the M side (16 a warp) and queries on the N side in tiles of
//     8, so 1 or 8 queries waste no MMA work; operands by ldmatrix from
//     rows padded by 16 bytes (conflict-free);
//   - exact/packed: each thread compares its scores, straight from the
//     accumulator registers, with its queries' thresholds (the sorted
//     list's last entry, kept in registers, never below the caller's seed),
//     lowest row winning a tie; only a candidate's score goes to shared
//     memory (and its row to its query's bit mask), and only when some
//     thread found one do the list owners (warp w keeps queries w, w + 8,
//     ...) merge a mask word's candidates into the list at once
//     (warp_merge, select.cuh: one pass over the list, where inserting
//     one candidate at a time takes one shift each);
//   - bucketed: each warp reduces its 16 rows per query with shuffles, and
//     one thread per query folds the row tiles of a stage, in row order,
//     and closes a 128-row bucket at its last row.
// f32 and bf16 rows (box_scan_kernel).  f32: 1.5 GB at
// 1M x 384, and at 64 queries 49 GFLOP on the CUDA cores (the reference is
// f32: no TF32), 0.73 ms at the 67 TFLOP/s f32 peak against 0.46 ms of
// bytes, so operations bound it from ~40 queries and bytes below.  bf16
// at bge-base's d 768: 1.5 GB at 1M rows against 98 GFLOP at 64 queries
// (0.1 ms on the tensor cores), so bytes bound it, but full-depth stages
// (a 64-row bf16 tile is 97 KB there) left a 64-query chunk no room
// beside its queries: the plan took chunks of 8 and read the rows 8
// times.  At MiniLM's d 384 too, bf16 scans take less device time on the
// box ring than they did on full-depth stages, most at 32-64 queries.  A
// stage here is one box, whatever d:
//   - the same persistent grid of contiguous 128-aligned row ranges, one
//     block per SM for each query chunk (f32: 1, 8, 16, 32 or 64 queries,
//     a single query not padded to 16, the chunks one wave after another;
//     bf16: 8-64, the chunks sharing one wave as pipe_scan_kernel's do);
//   - a TMA ring of 2-8 one-box stages (128 rows x 128 bytes, 16 KB: 32
//     floats or 64 bf16 columns) kept in flight by a producer warp,
//     released per stage by the 8 consumer warps on `empty` mbarriers; a
//     tile's rows' tags are read by the threads that own the rows when the
//     tile starts and used at its last box;
//   - the product in registers over a tile's boxes (box_ring.cuh): f32 one
//     query as box_one_query (each row float4 read by one lane), 8-64 as
//     box_tile micro-tiles in mma.sync's accumulator layout (a thread 4
//     rows x 8 queries at 64); bf16 as box_tile_bf16, mma.sync m16n8k16
//     with the rows' fragments by ldmatrix from the swizzled box, in the
//     same accumulator layout (a warp 32 rows x 32 queries at 64);
//   - pipe_scan_kernel's selection from those registers: thresholds,
//     candidates, warp_merge by the list owners, and the bucketed fold of
//     a tile (one bucket) per query.  The consumers' named barrier at a
//     tile's selection is the only one of the walk.
//
// Output: exact/packed -> (nq, n_blocks, k) candidates, sorted within a block's
// range, with id -1 for -inf slots (the caller merges them with a stable sort);
// bucketed -> (nq, ceil(n / 128)) bucket maxima and their rows.

#include <limits.h>
#include <math.h>

#include <type_traits>

#include "box_ring.cuh"
#include "mma_sm90.cuh"
#include "select.cuh"

using namespace tr_layout;
using namespace tr_mma;
using namespace tr_tile;

namespace {

constexpr int kPadTag = INT_MIN;

// #2's rounding: the top 18 bits of the f32 pattern.  The TPU kernel's
// sortable-key round trip with its low-bit fill gives exactly this value
// (-inf stays -inf), and the rounded values order as the keys do.
__device__ inline float round18(float s) { return __int_as_float(__float_as_int(s) & ~0x3FFF); }

// ---- int8: the pipelined scan (its layout: layout.h's pipe_smem)
constexpr int kPipeThreads = 32 * kPipeWarps;

template <int kMode, int NT, int kRows>
__global__ void __launch_bounds__(kPipeThreads, 1)
pipe_scan_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ x,
                 const float* __restrict__ scale, const int* __restrict__ ns,
                 const int* __restrict__ canon, const float* __restrict__ qscale,
                 int n, int d, int nq, int want_ns, int want_canon, int block_rows,
                 int k, int stages, const float* __restrict__ seed,
                 float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kList = kMode != kBucketed;
  constexpr int qc = 8 * NT;
  constexpr int kMT = kRows / 16;              // m16 row tiles of a stage
  constexpr int kGroups = kPipeWarps / kMT < NT ? kPipeWarps / kMT : NT;  // query groups
  constexpr int NTW = NT / kGroups;            // n8 query tiles of one warp
  constexpr int kSld = qc + 1;                 // score scratch row stride
  constexpr int kWords = kRows / 32;           // candidate bit mask words of a query
  extern __shared__ __align__(128) unsigned char smem[];
  const PipeSmem lay = pipe_smem(d, qc, k, kMode, stages, kRows);
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
  const int row_bytes = d;
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
    qsS[i] = (kList && i < nql) ? qscale[q0 + i] : 1.f;
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
        const bool ok = row < row_end;
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
    int acc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0;
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
        mma_s8(acc[0], a, b[0], b[1]);
      } else {
#pragma unroll
        for (int p = 0; p < NTW / 2; ++p) {
          uint32_t b[4];
          ldsm_x4(b, bq + p * 16 * ld + kb);
          mma_s8(acc[2 * p], a, b[0], b[1]);
          mma_s8(acc[2 * p + 1], a, b[2], b[3]);
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
      rs[h] = __int_as_float(meta[2 * kRows + lr[h]]);
    }
    float sc[NTW][4];
#pragma unroll
    for (int j = 0; j < NTW; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = qb + j * 8 + 2 * t + (e & 1), h = e >> 1;
        // exact/packed: (acc * query scale) * row scale, in the reference's
        // order; bucketed: the caller applies the query scale after selection
        const float a = float(acc[j][e]);
        float s = kList ? (a * qsS[qi]) * rs[h] : a * rs[h];
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

template <int kMode, int NT, int kRows>
int launch_pipe(const void* q, const void* x, const void* scale, const void* ns,
                const void* canon, const void* qscale, int n, int d, int nq, int want_ns,
                int want_canon, int block_rows, int k, int stages, const void* seed,
                void* out_sc, void* out_id, cudaStream_t stream) {
  const size_t smem = pipe_smem(d, 8 * NT, k, kMode, stages, kRows).total;
  auto kern = pipe_scan_kernel<kMode, NT, kRows>;
  cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
  dim3 grid((n + block_rows - 1) / block_rows, (nq + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kPipeThreads, smem, stream>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(x),
      static_cast<const float*>(scale), static_cast<const int*>(ns),
      static_cast<const int*>(canon),
      static_cast<const float*>(qscale), n, d, nq, want_ns, want_canon, block_rows, k, stages,
      static_cast<const float*>(seed), static_cast<float*>(out_sc), static_cast<int*>(out_id));
  return int(cudaGetLastError());
}

template <int kMode>
int launch_pipe_qc(int qc, int rows, const void* q, const void* x, const void* scale,
                   const void* ns, const void* canon, const void* qscale, int n, int d,
                   int nq, int want_ns, int want_canon, int block_rows, int k, int stages,
                   const void* seed, void* out_sc, void* out_id, cudaStream_t stream) {
#define TR_PIPE(NT, R) \
  launch_pipe<kMode, NT, R>(q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, \
                            block_rows, k, stages, seed, out_sc, out_id, stream)
  switch (qc) {
    case 8: return rows == 128 ? TR_PIPE(1, 128) : TR_PIPE(1, 64);
    case 16: return TR_PIPE(2, 64);
    case 32: return TR_PIPE(4, 64);
    case 64: return TR_PIPE(8, 64);
  }
#undef TR_PIPE
  return int(cudaErrorInvalidValue);
}

// ---- f32 and bf16 rows: the box ring
// A ring stage is one box of 128 rows x 128 bytes, whatever d: a whole
// 128-row tile is 192 KB of f32 at d 384 and of bf16 at d 768, and a
// 64-row bf16 stage at d 768 left a 64-query chunk no room beside its
// queries (the plan fell back to chunks of 8, eight passes over the rows).
// Its layout: layout.h's box_scan_smem.
constexpr int kBoxConsumers = 32 * kBoxWarps;
constexpr int kBoxThreads = kBoxConsumers + 32;        // and the producer warp

// The consumer warps' own barrier (id 1, `threads` threads): a producer
// warp that only feeds the ring never waits on it.
__device__ inline void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// consumers_sync that also returns whether `p` held in any of its threads.
__device__ inline bool consumers_sync_or(bool p, int threads) {
  int r;
  asm volatile(
      "{\n"
      ".reg .pred pi, po;\n"
      "setp.ne.b32 pi, %1, 0;\n"
      "bar.red.or.pred po, 1, %2, pi;\n"
      "selp.b32 %0, 1, 0, po;\n"
      "}\n"
      : "=r"(r)
      : "r"(int(p)), "r"(threads)
      : "memory");
  return r != 0;
}

// Grid: blockIdx.y the query chunk, blockIdx.x a contiguous range of
// block_rows rows (a multiple of 128), walked in 128-row tiles of
// ceil(d * elt / 128) boxes.  The producer warp's lane 0 keeps `stages`
// boxes in flight (a stage refilled once its 8 consumer warps released
// it); the consumer warps multiply each box as it lands, with partial sums
// in registers over a tile's boxes (f32 on the CUDA cores, bf16 on the
// tensor cores), and select after the tile's last box: the only barrier of
// the walk is the consumers' one at the selection.
template <typename T, int kMode, int QC>
__global__ void __launch_bounds__(kBoxThreads, 1)
box_scan_kernel(const T* __restrict__ q, const __grid_constant__ CUtensorMap x_map,
                const int* __restrict__ ns, const int* __restrict__ canon, int n, int d, int nq,
                int want_ns, int want_canon, int block_rows, int k, int stages,
                const float* __restrict__ seed, float* __restrict__ out_sc,
                int* __restrict__ out_id) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr bool kList = kMode != kBucketed;
  constexpr bool kOneQ = QC == 1;
  constexpr int kMTW = box_mtw(QC);
  constexpr int kWR = box_wr(QC);
  constexpr int kWQ = kBoxWarps / kWR;
  constexpr int kNTW = QC >= 8 ? QC / 8 / kWQ : 1;
  constexpr int kSld = QC + 1;                 // candidate scratch row stride
  constexpr int kWords = kSub / 32;            // candidate bit mask words of a query
  static_assert(kWR * 16 * kMTW == kSub && (kOneQ || kWQ * kNTW * 8 == QC), "warp tiling");
  static_assert(kF32 || !kOneQ, "a tensor-core chunk is whole n8 query tiles");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle unit
  const BoxScanSmem lay = box_scan_smem(int(sizeof(T)), d, QC, k, kMode, stages);
  const int ld = lay.ld, boxes = lay.boxes;
  unsigned char* Qs = smem + lay.q;
  float* Lsc = reinterpret_cast<float*>(smem + lay.list);
  int* Lid = reinterpret_cast<int*>(Lsc + QC * k);
  float* Sc = reinterpret_cast<float*>(smem + lay.scratch);  // exact: [kSub][kSld]
  int* Sr = reinterpret_cast<int*>(Sc + 2 * kWR * QC);        // bucketed: [2][kWR][QC] rows
  unsigned* cmask = reinterpret_cast<unsigned*>(smem + lay.cmask);  // [QC][kWords]
  int* Lfill = reinterpret_cast<int*>(smem + lay.fill);              // [QC] real entries
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);     // a stage's box landed
  uint64_t* empty = full + kMaxStages;                               // its consumers are done

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.y * QC, nql = min(QC, nq - q0);
  const int row_begin = blockIdx.x * block_rows;
  const int row_end = min(n, row_begin + block_rows);
  const int ntiles = (row_end - row_begin + kSub - 1) / kSub;
  const int row_bytes = d * int(sizeof(T));

  // queries (zero past nql and past the row's bytes), lists, masks, barriers
  for (int i = tid; i < QC * (ld / 16); i += kBoxThreads) {
    const int r = i / (ld / 16), c = (i % (ld / 16)) * 16;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < nql && c < row_bytes)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(q) +
                                          size_t(q0 + r) * row_bytes + c);
    *reinterpret_cast<uint4*>(Qs + r * ld + c) = v;
  }
  if constexpr (kList) {
    for (int i = tid; i < QC * k; i += kBoxThreads) {
      Lsc[i] = -INFINITY;
      Lid[i] = INT_MAX;
    }
    for (int i = tid; i < QC * kWords; i += kBoxThreads) cmask[i] = 0u;
    for (int i = tid; i < kBoxWarps * 32; i += kBoxThreads)
      reinterpret_cast<unsigned*>(smem + lay.bmap)[i] = 0u;
    for (int i = tid; i < QC; i += kBoxThreads) Lfill[i] = 0;
  }
  // the producer (warp kBoxWarps, lane 0): box `it` of the walk -> stage
  // it % stages once its consumers released it; a tile's box past the
  // block's rows reads the next block's rows (masked below as row >=
  // row_end), past n zeros.  It sets up the barriers and issues the ring's
  // first fill before the block's barrier, so the loads start while the
  // block stages the queries.
  const int nsteps = ntiles * boxes;
  const bool producer = warp == kBoxWarps && lane == 0;
  auto fill = [&](int it) {
    const int stg = it % stages;
    mbar_arrive_expect_tx(full + stg, tr_box::kBoxBytes);
    fence_proxy_async();  // after the consumers' reads of the stage
    tensor_g2s_2d(smem + size_t(stg) * tr_box::kBoxBytes, &x_map, (it % boxes) * 128,
                  row_begin + (it / boxes) * kSub, full + stg);
  };
  if (producer) {
    prefetch_tensormap(&x_map);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kBoxWarps);
    }
    mbar_fence_init();
    for (int it = 0; it < min(stages, nsteps); ++it) fill(it);
  }
  __syncthreads();

  if (warp == kBoxWarps) {
    if (producer) {
      for (int it = stages; it < nsteps; ++it) {
        mbar_wait(empty + it % stages, (it / stages - 1) & 1);
        fill(it);
      }
    }
  } else {
    const int wr = warp % kWR, qb = (warp / kWR) * 8 * kNTW;
    const int r_lo = wr * 16 * kMTW;            // this warp's first row of a tile
    const bool mma_warp = qb < nql;             // else its query group is empty
    unsigned* bmap = reinterpret_cast<unsigned*>(smem + lay.bmap) + 32 * warp;
    const float* Qf = reinterpret_cast<const float*>(Qs);  // f32 query rows: ld / 4 floats
    // thresholds of this thread's queries (qb + 8 j + 2t + e): the lists'
    // last entries, never below the seed (a lower bound of each query's
    // k-th score over all rows, or -inf), which a row scoring at least it
    // passes
    float thr_s[2 * kNTW], seed_s[2 * kNTW];
    int thr_r[2 * kNTW];
#pragma unroll
    for (int i = 0; i < 2 * kNTW; ++i) {
      const int qi = qb + (i >> 1) * 8 + 2 * t + (i & 1);
      seed_s[i] = seed != nullptr && mma_warp && qi < nql ? seed[q0 + qi] : -INFINITY;
      thr_s[i] = seed_s[i];
      thr_r[i] = INT_MAX;
    }
    int it = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int r0 = row_begin + tile * kSub;
      // this thread's rows' tags, read now and first used after the tile's
      // last box (rows past the block's range are masked as PAD)
      int tg[kMTW][2], cn[kMTW][2];
#pragma unroll
      for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = r0 + r_lo + mi * 16 + g + 8 * h;
          tg[mi][h] = row < row_end ? __ldg(ns + row) : kPadTag;
          cn[mi][h] = row < row_end ? __ldg(canon + row) : 0;
        }
      float acc[kMTW][kNTW][4];
      float acc1[2] = {0.f, 0.f};
#pragma unroll
      for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
        for (int j = 0; j < kNTW; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
      for (int box = 0; box < boxes; ++box, ++it) {
        const int stg = it % stages;
        mbar_wait(full + stg, (it / stages) & 1);
        const unsigned char* st = smem + size_t(stg) * tr_box::kBoxBytes;
        if constexpr (!kF32) {
          if (mma_warp)
            tr_box::box_tile_bf16<kMTW, kNTW>(acc, st, r_lo, Qs + qb * ld + box * 128, ld, lane);
        } else if constexpr (kOneQ) {
          tr_box::box_one_query(acc1, st, r_lo, Qf + box * tr_box::kBoxFloats, g, t);
        } else if (mma_warp) {
          tr_box::box_tile<kMTW, kNTW>(acc, st, r_lo,
                                       Qf + (qb + 2 * t) * (ld / 4) + box * tr_box::kBoxFloats,
                                       ld / 4, g);
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stg);
      }
      if constexpr (kOneQ) {  // every lane t of a g: rows g and g + 8 for query 0
        const float s0 = tr_box::sum_quarters(acc1[0]), s1 = tr_box::sum_quarters(acc1[1]);
        acc[0][0][0] = acc[0][0][1] = s0;
        acc[0][0][2] = acc[0][0][3] = s1;
      }

      // ---- scores: masked, rounded (packed); queries past nql score -inf
      float sc[kMTW][kNTW][4];
#pragma unroll
      for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const bool ok = tg[mi][h] != kPadTag && (want_ns < 0 || tg[mi][h] == want_ns) &&
                          (want_canon < 0 || cn[mi][h] == want_canon);
#pragma unroll
          for (int j = 0; j < kNTW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int qi = qb + j * 8 + 2 * t + e;
              const float s = ok && qi < nql && mma_warp ? acc[mi][j][2 * h + e] : -INFINITY;
              sc[mi][j][2 * h + e] = kMode == kPacked ? round18(s) : s;
            }
        }

      if constexpr (kList) {
        // a candidate beats its query's threshold: its score goes to the
        // scratch and its row to the query's bit mask
        bool mine = false;
#pragma unroll
        for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
          for (int j = 0; j < kNTW; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int i = 2 * j + e, l = r_lo + mi * 16 + g + 8 * h;
                const int qi = qb + j * 8 + 2 * t + e;
                const float s = sc[mi][j][2 * h + e];
                if (s > -INFINITY && (s > thr_s[i] || (s == thr_s[i] && r0 + l < thr_r[i]))) {
                  Sc[l * kSld + qi] = s;
                  atomicOr(cmask + qi * kWords + (l >> 5), 1u << (l & 31));
                  mine = true;
                }
              }
        if (consumers_sync_or(mine, kBoxConsumers)) {
          // list owners: warp w keeps queries w, w + 8, ...; lane l reads
          // the mask word l % kWords of its (l / kWords)-th query, and each
          // word that holds a candidate is one merge, its moves bounded by
          // the list's real entries (a list filling from empty, as a seeded
          // one over a deep k does, moves only what it holds)
          const int nown = (nql - warp + kBoxWarps - 1) / kBoxWarps;
          const int wi = (warp + kBoxWarps * (lane / kWords)) * kWords + lane % kWords;
          const unsigned wb = lane < nown * kWords ? cmask[wi] : 0u;
          for (unsigned todo = __ballot_sync(kFull, wb != 0u); todo; todo &= todo - 1) {
            const int src = __ffs(todo) - 1;
            const unsigned bits = __shfl_sync(kFull, wb, src);
            const int qi = warp + kBoxWarps * (src / kWords), l = (src % kWords) * 32 + lane;
            const int filled = Lfill[qi];
            const int placed =
                warp_merge(Lsc + qi * k, Lid + qi * k, k,
                           (bits >> lane) & 1u ? Sc[l * kSld + qi] : -INFINITY, r0 + l, bmap, filled);
            if (lane == 0) Lfill[qi] = min(k, filled + placed);
            __syncwarp();
          }
          if (wb) cmask[wi] = 0u;
          consumers_sync(kBoxConsumers);
#pragma unroll
          for (int i = 0; i < 2 * kNTW; ++i) {
            const int qi = qb + (i >> 1) * 8 + 2 * t + (i & 1);
            if (mma_warp && qi < nql) {
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
        // per query column: the max of this thread's rows (in row order, so
        // a strictly greater score replaces), then over the 8 lanes of
        // other rows g, lowest row on a tie, into the table of tile & 1
        float* tS = Sc + (tile & 1) * kWR * QC;
        int* tR = Sr + (tile & 1) * kWR * QC;
#pragma unroll
        for (int j = 0; j < kNTW; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float best = -INFINITY;
            int bro = INT_MAX;
#pragma unroll
            for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const float s = sc[mi][j][2 * h + e];
                if (s > best || bro == INT_MAX) {
                  best = s;
                  bro = r0 + r_lo + mi * 16 + g + 8 * h;
                }
              }
#pragma unroll
            for (int off = 4; off < 32; off <<= 1) {
              const float os = __shfl_xor_sync(kFull, best, off);
              const int orow = __shfl_xor_sync(kFull, bro, off);
              if (better(os, orow, best, bro)) {
                best = os;
                bro = orow;
              }
            }
            const int qi = qb + j * 8 + 2 * t + e;
            if (g == 0 && qi < QC) {
              tS[wr * QC + qi] = best;
              tR[wr * QC + qi] = bro;
            }
          }
        consumers_sync(kBoxConsumers);
        if (tid < nql) {  // the bucket (this tile) closes: its row groups in row order
          float bbest = tS[tid];
          int brow = tR[tid];
#pragma unroll
          for (int w = 1; w < kWR; ++w) {
            if (better(tS[w * QC + tid], tR[w * QC + tid], bbest, brow)) {
              bbest = tS[w * QC + tid];
              brow = tR[w * QC + tid];
            }
          }
          const size_t o = size_t(q0 + tid) * ((size_t(n) + kSub - 1) / kSub) + r0 / kSub;
          out_sc[o] = bbest;
          out_id[o] = brow;
        }
      }
    }
  }

  if constexpr (kList) {
    __syncthreads();  // every list complete
    for (int i = tid; i < nql * k; i += kBoxThreads) {
      const int qi = i / k, j = i % k;
      const float s = Lsc[qi * k + j];
      const size_t o = (size_t(q0 + qi) * gridDim.x + blockIdx.x) * k + j;
      out_sc[o] = s;
      out_id[o] = s > -INFINITY ? Lid[qi * k + j] : -1;
    }
  }
}

template <typename T, int kMode, int QC>
int launch_box(const CUtensorMap& map, const void* q, const void* ns, const void* canon, int n,
               int d, int nq, int want_ns, int want_canon, int block_rows, int k, int stages,
               const void* seed, void* out_sc, void* out_id, cudaStream_t stream) {
  const size_t smem = box_scan_smem(int(sizeof(T)), d, QC, k, kMode, stages).total;
  auto kern = box_scan_kernel<T, kMode, QC>;
  if (int e = int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem))))
    return e;
  dim3 grid((n + block_rows - 1) / block_rows, (nq + QC - 1) / QC);
  kern<<<grid, kBoxThreads, smem, stream>>>(
      static_cast<const T*>(q), map, static_cast<const int*>(ns), static_cast<const int*>(canon),
      n, d, nq, want_ns, want_canon, block_rows, k, stages, static_cast<const float*>(seed),
      static_cast<float*>(out_sc), static_cast<int*>(out_id));
  return int(cudaGetLastError());
}

template <typename T, int kMode>
int launch_box_qc(int qc, const CUtensorMap& map, const void* q, const void* ns,
                  const void* canon, int n, int d, int nq, int want_ns, int want_canon,
                  int block_rows, int k, int stages, const void* seed, void* out_sc,
                  void* out_id, cudaStream_t stream) {
#define TR_BOX(QC) \
  launch_box<T, kMode, QC>(map, q, ns, canon, n, d, nq, want_ns, want_canon, block_rows, k, \
                           stages, seed, out_sc, out_id, stream)
  switch (qc) {
    case 1:
      if constexpr (std::is_same<T, float>::value) return TR_BOX(1);
      break;
    case 8: return TR_BOX(8);
    case 16: return TR_BOX(16);
    case 32: return TR_BOX(32);
    case 64: return TR_BOX(64);
  }
#undef TR_BOX
  return int(cudaErrorInvalidValue);
}

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

// mode 1 (exact, #1) or 2 (packed, #2) -> out (nq, ceil(n / tile_rows), k);
// mode 0 (bucketed, #3) -> out (nq, ceil(n / 128)).
// q (nq, d) and x (n, d) share `dtype` and are 16-byte aligned; scale (n,)
// and qscale (nq,) f32 are read for int8 only; ns/canon (n,) int32.  Each
// block scans tile_rows consecutive rows (a multiple of 128) for qc queries
// through a ring of 2 <= stages <= 8 stages; exact/packed take an optional
// seed (nq,) f32: a lower bound of each query's k-th score, below which no
// row is a candidate.  pipe_scan_kernel and bf16 box_scan_kernel take qc in
// {8, 16, 32, 64}, f32 box_scan_kernel qc in {1, 8, 16, 32, 64}.
extern "C" int tr_scan(const void* q, const void* x, const void* scale,
                       const void* ns, const void* canon, const void* qscale,
                       int n, int d, int nq, int want_ns, int want_canon,
                       int tile_rows, int qc, int k, int mode, int dtype, int stages,
                       const void* seed, void* out_sc, void* out_id, void* stream) {
  if (n <= 0 || nq <= 0 || d <= 0 || d % 16 != 0 || tile_rows <= 0 ||
      tile_rows % kSub != 0 || qc <= 0 || qc > kMaxQc ||
      mode < kBucketed || mode > kPacked ||
      (mode != kBucketed && (k <= 0 || k > kMaxDeepK)) || stages < 2 || stages > kMaxStages ||
      !tr_box::aligned16(q) || !tr_box::aligned16(x))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  const int elt = elt_of(dtype);
  if (box_route(dtype)) {
    const bool f32 = dtype == TR_F32;
    if ((qc != 8 && qc != 16 && qc != 32 && qc != 64 && !(f32 && qc == 1)) ||
        box_scan_smem(elt, d, qc, k, mode, stages).total > size_t(kSmemMax))
      return int(cudaErrorInvalidValue);
    CUtensorMap map;
    if (!tr_box::rows_tensor_map(&map, x, n, d * elt, tr_box::kBoxRows))
      return int(cudaErrorInvalidValue);
#define TR_BOX(T, M) \
  launch_box_qc<T, M>(qc, map, q, ns, canon, n, d, nq, want_ns, want_canon, tile_rows, k, stages, seed, out_sc, out_id, s)
#define TR_MODES(T) \
  (mode == kExact ? TR_BOX(T, kExact) : mode == kPacked ? TR_BOX(T, kPacked) : TR_BOX(T, kBucketed))
    return f32 ? TR_MODES(float) : TR_MODES(__nv_bfloat16);
#undef TR_MODES
#undef TR_BOX
  }
  const int rows = pipe_rows(d, qc, k, mode);
  if (dtype != TR_I8 || pipe_smem(d, qc, k, mode, stages, rows).total > size_t(kSmemMax))
    return int(cudaErrorInvalidValue);
#define TR_PIPE(M) \
  launch_pipe_qc<M>(qc, rows, q, x, scale, ns, canon, qscale, n, d, nq, want_ns, want_canon, tile_rows, k, stages, seed, out_sc, out_id, s)
  return mode == kExact ? TR_PIPE(kExact) : mode == kPacked ? TR_PIPE(kPacked) : TR_PIPE(kBucketed);
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
