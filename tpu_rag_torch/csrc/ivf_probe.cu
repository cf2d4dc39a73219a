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
//      a byte.  bf16 and int8 lists (probe_split_kernel):
//      - each (query, probe) list split into `split` contiguous 128-aligned
//        slot ranges, one block each, the blocks of a list one thread-block
//        cluster (ops/ivf_probe.py::_list_plan picks split, ring depth and
//        stage rows so the grid fills the SMs: at one query and nprobe 64,
//        one block a list would leave half of 132 SMs idle);
//      - a ring of 2-8 stages of 128 rows (64 where two 128-row stages do
//        not fit the block's share of the SM), filled by a producer warp:
//        the TMA unit loads the rows from the tensor map over all the
//        lists' rows (a box at a list's tail reads the next list's rows,
//        masked as slot >= cap) and one bulk copy each brings ns, canon and
//        scale, all on the stage's `full` mbarrier; each consumer warp
//        releases a stage on its `empty` mbarrier once its product is done,
//        and the producer refills it then;
//      - mma.sync with the rows on M (16 a warp) and the query in every
//        column of an n8 tile (7 of 8 columns repeat it: bytes set the pace);
//      - #1's selection: every warp keeps its own sorted top-k list of its
//        rows; a lane's score, masked and scaled in registers, is a
//        candidate only if it beats the list's k-th entry, and a warp merges
//        only when some lane has one (warp_merge, select.cuh); a score
//        below the least of the warps' published ceil(k / warps)-th scores,
//        a lower bound of the block's k-th, is no candidate, so the warps
//        insert about the block's candidates, not eight times as many.  No
//        block barrier stands in the walk, so a warp's merge overlaps the
//        other warps' products and the refills;
//      - an exact merge (merge_cluster): each entry of a warp's list goes
//        to its place among the block's (its index plus the better entries
//        of the other lists, by binary search), then, after a cluster
//        barrier, among the cluster's the same way, over copies of the
//        peers' lists taken through distributed shared memory, each block
//        writing its own winners.  Slots are unique and the ranges in slot
//        order, so this is the top k of the whole list, ties included.
//      f32 lists (probe_f32_kernel): the same grid, ranges, selection and
//      merges (merge_cluster), with the product on the CUDA cores (no
//      TF32); at one query ~0.5 operations a byte, so bytes bound it:
//      - a 128-slot tile of f32 rows is 192 KB at d 384, so the ring's 2-8
//        stages each hold one box of it (128 slots x 32 floats, 16 KB),
//        kept in flight by the producer warp's lane 0 and released per
//        stage by the 8 consumer warps, whose partial sums stay in
//        registers over a tile's boxes;
//      - box_one_query (box_ring.cuh): every slot's float4 of a box read
//        once by one lane (an n8 tile of mma.sync would multiply one query
//        eight times), the query's float4 broadcast from shared memory;
//      - a lane reads its slots' tags when the tile starts, so no tag
//        copy waits in the ring.
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
//      f32 lists (batched_bucket_kernel), the same structure with the
//      product on the CUDA cores (the reference is f32: no TF32), where the
//      FMA pipes (67 TFLOP/s) and not the bytes bound it from ~16 queries:
//      - the same grid over query chunks (16, 32 or 64 queries, staged
//        once in shared memory), but one block per SM for each chunk: the
//        FMA pipes, not the bytes, bound a chunk, so the chunks run one
//        wave after another rather than share the card; the warps of a
//        chunk's empty query half skip the product;
//      - a bucket at d floats is 4 d / 128 tensor-map boxes of 128 rows x
//        128 bytes (16 KB; a whole f32 bucket, 192 KB at d 384, would leave
//        no room for a second stage), so the ring's 2-8 stages each hold
//        one box, the bucket's ns and canon riding with its first box, and
//        the accumulators stay in registers over the bucket's boxes;
//      - the product in register micro-tiles laid out as mma.sync's
//        accumulators (at 64 queries a warp owns 32 rows x 32 queries, a
//        thread 4 rows x 8 queries), each row and query read as float4
//        along d: the swizzled box rows fall in distinct bank groups, the
//        query rows are padded by 16 bytes; 12 float4 loads feed 128 FMAs;
//      - at a bucket's last box the selection, the table and the fold are
//        the bf16/int8 kernel's (warp_select, fold_rows); a warp whose rows
//        of a bucket are all masked skips its boxes' products.

#include <cooperative_groups.h>
#include <cuda.h>
#include <dlfcn.h>
#include <limits.h>
#include <math.h>

#include <type_traits>

#include "box_ring.cuh"
#include "mma_sm90.cuh"
#include "select.cuh"

namespace cg = cooperative_groups;
using namespace tr_box;
using namespace tr_layout;
using namespace tr_mma;
using namespace tr_tile;

namespace {

constexpr int kPadTag = INT_MIN;

// ---- #7 on bf16 and int8 lists: the pipelined bucket probe (its layout:
// layout.h's bucket_smem, its stages' rows bucket_rows)
constexpr int kBucketWarps = 8;
constexpr int kBucketThreads = 32 * kBucketWarps;

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

// The top M of one query's winners over kWR row tiles (tS/tR at its entry
// of row tile 0, the row tiles `stride` apart): a merge tree.
template <int kWR, int M>
__device__ inline void fold_rows(const float* tS, const int* tR, int stride, float (&ls)[M],
                                 int (&lr)[M]) {
  float ws[kWR][M];
  int wrr[kWR][M];
#pragma unroll
  for (int w = 0; w < kWR; ++w)
#pragma unroll
    for (int p = 0; p < M; ++p) {
      ws[w][p] = tS[w * stride + p];
      wrr[w][p] = tR[w * stride + p];
    }
#pragma unroll
  for (int step = 1; step < kWR; step *= 2)
#pragma unroll
    for (int w = 0; w + step < kWR; w += 2 * step) list_merge(ws[w], wrr[w], ws[w + step], wrr[w + step]);
#pragma unroll
  for (int p = 0; p < M; ++p) {
    ls[p] = ws[0][p];
    lr[p] = wrr[0][p];
  }
}

// A warp's top M of its rows for each of its query columns, into its part
// of the winners' table (tS/tR: [query][kMaxM]).  sc holds the warp's
// masked scores in mma.sync's m16n8 accumulator layout: [mi][j][2 h + e] is
// row 16 mi + g + 8 h of the warp's rows (slot sbase + that row) and query
// qb + 8 j + 2 t + e.
template <int kMTW, int kNTW, int M>
__device__ inline void warp_select(const float (&sc)[kMTW][kNTW][4], int sbase, int g, int t,
                                   int qb, float* tS, int* tR) {
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
          for (int h = 0; h < 2; ++h) v[2 * j + e][h + 2 * mi] = sc[mi][j][2 * h + e];
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
      tS[qi * kMaxM + p] = ls[0][p];
      tR[qi * kMaxM + p] = lsr[0][p];
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
            cs[2 * mi + h] = sc[mi][j][2 * h + e];
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
            tS[qi * kMaxM + p] = ls[p];
            tR[qi * kMaxM + p] = lsr[p];
          }
        }
      }
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
    float ws[M];
    int wrr[M];
    const int base = ((tile & 1) * kWR * qc + mqc) * kMaxM;
    fold_rows<kWR, M>(tabS + base, tabR + base, qc * kMaxM, ws, wrr);
    if constexpr (kSPB == 1) {
      if (merger) {  // the bucket closes: slots in the list
        const long long item = ib + tile;
        const int b = int(item % nb);
        const size_t o = (size_t(item / nb) * nq + q0 + mq) * cols + b;
#pragma unroll
        for (int p = 0; p < M; ++p) {
          out_sc[o + size_t(p) * nb] = ws[p];
          out_id[o + size_t(p) * nb] = ws[p] > -INFINITY ? b * kSub + wrr[p] : -1;
        }
      }
    } else if (tile % kSPB == 0) {  // the bucket's first half
#pragma unroll
      for (int p = 0; p < M; ++p) {
        run_s[p] = ws[p];
        run_r[p] = wrr[p];
      }
    } else {
      list_merge(run_s, run_r, ws, wrr);
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
    float sc[kMTW][kNTW][4];
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sc[mi][j][2 * h + e] = !ok[mi][h] ? -INFINITY
                                   : kInt8   ? float(acc[mi][j][2 * h + e]) * rs[mi][h]
                                             : float(acc[mi][j][2 * h + e]);
    warp_select<kMTW, kNTW, M>(sc, sbase, g, t, qb, tabS + tb, tabR + tb);
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

// ---- #7 on f32 lists: the pipelined bucket probe on the CUDA cores (its
// layout: layout.h's f32_bucket_smem)

template <int NT, int M>
__global__ void __launch_bounds__(kBucketThreads, 1)
batched_bucket_kernel(const float* __restrict__ q, const int* __restrict__ uniq,
                      const int* __restrict__ n_uniq, const int* __restrict__ ns,
                      const int* __restrict__ canon, const __grid_constant__ CUtensorMap rows_map,
                      int nq, int u_max, int cap, int d, int want_ns, int want_canon, int stages,
                      float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr int qc = 8 * NT;
  constexpr int kMTW = bucket_mtw(NT, kSub);
  constexpr int kWR = bucket_wr(NT, kSub);
  constexpr int kWQ = kBucketWarps / kWR < NT ? kBucketWarps / kWR : NT;
  constexpr int kNTW = NT / kWQ;
  static_assert(kWQ == 2 && kWR * kWQ == kBucketWarps, "two query groups of qc / 2");
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle unit
  const F32BucketSmem lay = f32_bucket_smem(d, qc, stages);
  const int ld = lay.ld, boxes = lay.boxes;
  float* Qs = reinterpret_cast<float*>(smem);
  float* tabS = reinterpret_cast<float*>(smem + lay.tab);  // [2][kWR][qc][kMaxM]
  int* tabR = reinterpret_cast<int*>(tabS + 2 * kWR * qc * kMaxM);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // a stage landed

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wr = warp % kWR, qb = (warp / kWR) * 8 * kNTW;

  const int q0 = blockIdx.y * qc, nql = min(qc, nq - q0);
  const bool mma_warp = qb < nql;
  const int nb = cap / kSub, cols = M * nb;
  const int nu = min(*n_uniq, u_max);            // live union slots
  const long long n_items = (long long)nu * nb;  // (slot, bucket) items
  const long long ib = n_items * blockIdx.x / gridDim.x;
  const long long ie = n_items * (blockIdx.x + 1) / gridDim.x;
  const int ntiles = int(ie - ib) * boxes;       // a tile: one box of one bucket

  // queries (zero past nql and past d)
  for (int i = tid; i < qc * (ld / 4); i += kBucketThreads) {
    const int r = i / (ld / 4), c = (i % (ld / 4)) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nql && c < d) v = *reinterpret_cast<const float4*>(q + size_t(q0 + r) * d + c);
    *reinterpret_cast<float4*>(Qs + r * ld + c) = v;
  }
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(full + s, 1);
    mbar_fence_init();
  }
  __syncthreads();

  // tile -> stage tile % stages: the box of the bucket's rows by the tensor
  // map, and with a bucket's first box its ns and canon by one bulk copy
  // each; thread 0 announces the bytes on the stage's barrier
  auto fetch = [&](int tile) {
    if (tile >= ntiles) return;
    const int stg = tile % stages, box = tile % boxes;
    unsigned char* st = smem + lay.ring + size_t(stg) * lay.stage;
    const long long item = ib + tile / boxes;
    const size_t slot0 = size_t(__ldg(uniq + item / nb)) * cap + size_t(item % nb) * kSub;
    if (tid == 0) {
      mbar_arrive_expect_tx(full + stg, uint32_t(kSub * 128 + (box == 0 ? 2 * kSub * 4 : 0)));
      fence_proxy_async();  // the stage's last readers passed the loop's barrier
      tensor_g2s_2d(st, &rows_map, box * 128, int(slot0), full + stg);
    } else if (box == 0 && tid < 3) {
      fence_proxy_async();
      bulk_g2s(st + lay.meta + (tid - 1) * kSub * 4, tid == 1 ? ns + slot0 : canon + slot0,
               kSub * 4, full + stg);
    }
  };
  for (int s = 0; s < stages - 1; ++s) fetch(s);

  // union slots past the live ones: -inf/-1 over this chunk's rows, spread
  // over the chunk's blocks (for a slot u they are one contiguous run)
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
  // winners of local bucket `bk` and writes them
  const int mq = lane * kBucketWarps + warp;
  const bool merger = lane < NT && mq < nql;
  const int mqc = mq < qc ? mq : qc - 1;
  auto fold = [&](int bk) {
    float ws[M];
    int wrr[M];
    const int base = ((bk & 1) * kWR * qc + mqc) * kMaxM;
    fold_rows<kWR, M>(tabS + base, tabR + base, qc * kMaxM, ws, wrr);
    if (merger) {
      const long long item = ib + bk;
      const int b = int(item % nb);
      const size_t o = (size_t(item / nb) * nq + q0 + mq) * cols + b;
#pragma unroll
      for (int p = 0; p < M; ++p) {
        out_sc[o + size_t(p) * nb] = ws[p];
        out_id[o + size_t(p) * nb] = ws[p] > -INFINITY ? b * kSub + wrr[p] : -1;
      }
    }
  };

  const int r_lo = wr * 16 * kMTW;  // this warp's first row of a bucket
  bool ok[kMTW][2];
  bool any = false;
  float acc[kMTW][kNTW][4];
  for (int it = 0; it < ntiles; ++it) {
    __syncthreads();  // stage (it - 1) % stages is free; the last bucket's table is full
    fetch(it + stages - 1);
    mbar_wait(full + it % stages, (it / stages) & 1);
    const int box = it % boxes;
    if (it > 0 && box == 0) fold(it / boxes - 1);
    if (!mma_warp) continue;
    const unsigned char* st = smem + lay.ring + size_t(it % stages) * lay.stage;
    if (box == 0) {  // a new bucket: its masks, zero accumulators
      const int* meta = reinterpret_cast<const int*>(st + lay.meta);
      any = false;
#pragma unroll
      for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int lr = r_lo + mi * 16 + g + 8 * h;
          const int tg = meta[lr], c = meta[kSub + lr];
          ok[mi][h] = tg != kPadTag && (want_ns < 0 || tg == want_ns) &&
                      (want_canon < 0 || c == want_canon);
          any |= ok[mi][h];
        }
      any = __any_sync(kFull, any);
#pragma unroll
      for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
        for (int j = 0; j < kNTW; ++j) acc[mi][j][0] = acc[mi][j][1] = acc[mi][j][2] = acc[mi][j][3] = 0.f;
    }
    if (any) {
      // ---- the box's 32 floats of rows [r_lo, r_lo + 16 kMTW) x queries
      // [qb, qb + 8 kNTW) in mma.sync's accumulator layout (box_ring.cuh),
      // so the selection is the bf16/int8 kernel's
      box_tile<kMTW, kNTW>(acc, st, r_lo, Qs + (qb + 2 * t) * ld + box * kBoxFloats, ld, g);
    }
    if (box != boxes - 1) continue;
    // ---- the bucket's last box: selection into the table
    const int tb = (((it / boxes) & 1) * kWR + wr) * qc * kMaxM;
    if (!any) {  // every row of this warp masked: -inf winners
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
    float sc[kMTW][kNTW][4];
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            sc[mi][j][2 * h + e] = ok[mi][h] ? acc[mi][j][2 * h + e] : -INFINITY;
    warp_select<kMTW, kNTW, M>(sc, r_lo, g, t, qb, tabS + tb, tabR + tb);
  }
  if (ntiles > 0) {
    __syncthreads();
    fold(ntiles / boxes - 1);
  }
}

template <int NT, int M>
int launch_f32_bucket(const BucketArgs& a) {
  const size_t smem = f32_bucket_smem(a.d, 8 * NT, a.stages).total;
  auto kern = batched_bucket_kernel<NT, M>;
  if (int e = int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem))))
    return e;
  dim3 grid(a.blocks, (a.nq + 8 * NT - 1) / (8 * NT));
  kern<<<grid, kBucketThreads, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const int*>(a.uniq),
      static_cast<const int*>(a.n_uniq), static_cast<const int*>(a.ns),
      static_cast<const int*>(a.canon), a.rows_map, a.nq, a.u_max, a.cap, a.d, a.want_ns,
      a.want_canon, a.stages, static_cast<float*>(a.out_sc), static_cast<int*>(a.out_id));
  return int(cudaGetLastError());
}

int launch_f32_bucket_qc(int qc, int m, const BucketArgs& a) {
#define TR_F32_BUCKET(NT)                                 \
  switch (m) {                                            \
    case 1: return launch_f32_bucket<NT, 1>(a);           \
    case 2: return launch_f32_bucket<NT, 2>(a);           \
    case 3: return launch_f32_bucket<NT, 3>(a);           \
    case 4: return launch_f32_bucket<NT, 4>(a);           \
  }                                                       \
  break;
  switch (qc) {
    case 16: TR_F32_BUCKET(2)
    case 32: TR_F32_BUCKET(4)
    case 64: TR_F32_BUCKET(8)
  }
#undef TR_F32_BUCKET
  return int(cudaErrorInvalidValue);
}

// ---- #6 on bf16 and int8 lists: the split list probe (its layout:
// layout.h's list_smem)
constexpr int kListThreads = 32 * (kListWarps + 1);  // the consumer warps and a producer
constexpr int kMaxSplit = 8;                      // blocks of one list: a cluster


// The list's top k from the `nlists` sorted warp lists of each block of
// its cluster (wls: [warp][2 k], scores then slots), written to
// out_sc/out_id at o: each entry of a warp's list goes to its place among
// all the block's entries (its index plus the entries of the other lists
// that are better, by binary search; slots are unique, so the places of the
// real entries are distinct); after a cluster barrier each block copies
// its peers' lists through distributed shared memory into its ring (free
// once the walk is done: `scratch`, at least split * k * 8 bytes) in one
// pass of independent loads, and places its own entries among them the
// same way, writing its own winners; the ranges are in slot order, so ties
// across them resolve as in one list.  (A binary search straight over a
// peer's list is a chain of dependent remote loads: at split 8 each entry
// waited on ~50 of them.)  Every thread of the block calls it.
__device__ inline void merge_cluster(int split, int nlists, const float* wls, float* cta_s,
                                     int* cta_r, int k, unsigned char* scratch, size_t o,
                                     float* __restrict__ out_sc, int* __restrict__ out_id) {
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const int tid = threadIdx.x, nthreads = blockDim.x;
  __syncthreads();
  for (int i = tid; i < k; i += nthreads) {
    cta_s[i] = -INFINITY;
    cta_r[i] = INT_MAX;
  }
  __syncthreads();
  for (int e = tid; e < nlists * k; e += nthreads) {
    const int w = e / k, i = e % k;
    const float* wl = wls + size_t(w) * 2 * k;
    const float s = wl[i];
    if (!(s > -INFINITY)) continue;
    const int r = reinterpret_cast<const int*>(wl + k)[i];
    int pos = i;
    for (int w2 = 0; w2 < nlists && pos < k; ++w2) {
      const float* ol = wls + size_t(w2) * 2 * k;
      if (w2 != w) pos += count_better(ol, reinterpret_cast<const int*>(ol + k), k, s, r);
    }
    if (pos < k) {
      cta_s[pos] = s;
      cta_r[pos] = r;
    }
  }
  cluster.sync();  // every block's list is complete and visible
  float* peer_s = reinterpret_cast<float*>(scratch);  // [split][k] scores, then slots
  int* peer_r = reinterpret_cast<int*>(peer_s + split * k);
  for (int i = tid; i < split * k; i += nthreads) {
    peer_s[i] = cluster.map_shared_rank(cta_s, i / k)[i % k];
    peer_r[i] = cluster.map_shared_rank(cta_r, i / k)[i % k];
  }
  cluster.sync();  // the copies are whole, and no peer reads this block's list again
  for (int i = tid; i < k; i += nthreads) {
    const float s = cta_s[i];
    if (!(s > -INFINITY)) break;
    const int r = cta_r[i];
    int pos = i;
    for (int p = 0; p < split && pos < k; ++p)
      if (p != rank) pos += count_better(peer_s + p * k, peer_r + p * k, k, s, r);
    if (pos < k) {
      out_sc[o + pos] = s;
      out_id[o + pos] = r;
    }
  }
  if (rank == 0) {  // places past the cluster's real entries: -inf / -1
    int real = 0;
    for (int p = 0; p < split; ++p)
      real += count_better(peer_s + p * k, peer_r + p * k, k, -INFINITY, INT_MAX);
    for (int i = min(real, k) + tid; i < k; i += nthreads) {
      out_sc[o + i] = -INFINITY;
      out_id[o + i] = -1;
    }
  }
}

// Grid: `split` blocks for each (query, probe) list, a cluster of `split`,
// block rank r walking the list's slots from 128 * (nb r / split) to 128 *
// (nb (r + 1) / split) (nb = ceil(cap / 128); the last range ends at cap).
template <typename T, int kRows>
__global__ void __launch_bounds__(kListThreads)
probe_split_kernel(const T* __restrict__ q, const int* __restrict__ lists,
                   const float* __restrict__ scale, const int* __restrict__ ns,
                   const int* __restrict__ canon, const __grid_constant__ CUtensorMap rows_map,
                   int nprobe, int cap, int d, int want_ns, int want_canon, int k, int stages,
                   int split, float* __restrict__ out_sc, int* __restrict__ out_id) {
  constexpr bool kInt8 = std::is_same<T, int8_t>::value;
  constexpr int kTags = kInt8 ? 3 : 2;                // ns, canon (, scale) a stage
  constexpr int kMmaWarps = kRows / 16;               // a warp's m16 tile of a stage
  using Acc = typename std::conditional<kInt8, int, float>::type;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle unit
  const ListSmem lay = list_smem(sizeof(T), d, k, stages, kRows);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  const unsigned char* Qs = smem + lay.q;
  float* wls = reinterpret_cast<float*>(smem + lay.lists);  // [warp][2 k]: scores, slots
  float* cta_s = reinterpret_cast<float*>(smem + lay.cta);
  int* cta_r = reinterpret_cast<int*>(cta_s + k);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // a stage landed
  uint64_t* empty = full + kMaxStages;                            // its consumers are done
  volatile float* pub = reinterpret_cast<volatile float*>(smem + lay.pub);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qp = blockIdx.x / split;                  // query * nprobe + probe
  float* Ls = wls + size_t(warp) * 2 * k;             // this warp's list
  int* Li = reinterpret_cast<int*>(Ls + k);
  unsigned* bm = reinterpret_cast<unsigned*>(smem + lay.bmap) + warp * kListMapWords;
  const int nb = (cap + kSub - 1) / kSub;
  const int s_begin = kSub * (nb * rank / split);
  const int s_end = min(cap, kSub * (nb * (rank + 1) / split));
  const int ntiles = (s_end - s_begin + kRows - 1) / kRows;
  const long long base = (long long)__ldg(lists + qp) * cap;  // the list's first row
  const int row_bytes = d * int(sizeof(T));

  // the query (zero past d), empty lists, clear bit maps, the barriers
  for (int c = tid * 16; c < lay.kbytes; c += kListThreads * 16) {
    uint4 v = make_uint4(0, 0, 0, 0);
    if (c < row_bytes)
      v = *reinterpret_cast<const uint4*>(reinterpret_cast<const unsigned char*>(q) +
                                          size_t(qp / nprobe) * row_bytes + c);
    *reinterpret_cast<uint4*>(smem + lay.q + c) = v;
  }
  for (int i = tid; i < kListWarps * k; i += kListThreads) {
    float* l = wls + size_t(i / k) * 2 * k;
    l[i % k] = -INFINITY;
    reinterpret_cast<int*>(l + k)[i % k] = INT_MAX;
  }
  for (int i = tid; i < kListWarps * kListMapWords; i += kListThreads)
    reinterpret_cast<unsigned*>(smem + lay.bmap)[i] = 0u;
  if (tid < kListWarps) pub[tid] = -INFINITY;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kMmaWarps);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == kListWarps) {
    // the producer warp: tile -> stage tile % stages once the stage's
    // consumers released it; the rows' 128-byte column blocks by one
    // tensor-map box each from lanes 0, 1, ... (a box past the list's tail
    // reads the next list's rows, masked below as slot >= cap; past the
    // last list the TMA fills zeros), the ns, canon and scale of the tile's
    // slots below cap by one bulk copy each from the next lanes; lane 0
    // announces all the bytes on the stage's barrier
    for (int tile = 0; tile < ntiles; ++tile) {
      const int stg = tile % stages;
      if (tile >= stages) mbar_wait(empty + stg, (tile / stages - 1) & 1);
      unsigned char* st = smem + size_t(stg) * lay.stage;
      const int slot0 = s_begin + tile * kRows;
      const int nvalid = min(kRows, cap - slot0);     // cap % 4 == 0: whole 16 bytes
      const long long row0 = base + slot0;
      if (lane == 0)
        mbar_arrive_expect_tx(full + stg,
                              uint32_t(lay.boxes * kRows * 128 + kTags * nvalid * 4));
      if (lane < lay.boxes) {
        fence_proxy_async();  // after the consumers' reads of the stage
        tensor_g2s_2d(st + lane * kRows * 128, &rows_map, lane * 128, int(row0), full + stg);
      } else if (lane < lay.boxes + kTags) {
        const int a = lane - lay.boxes;
        const void* src = a == 0 ? static_cast<const void*>(ns + row0)
                        : a == 1 ? static_cast<const void*>(canon + row0)
                                 : static_cast<const void*>(scale + row0);
        fence_proxy_async();
        bulk_g2s(st + lay.meta + a * kRows * 4, src, uint32_t(nvalid * 4), full + stg);
      }
    }
  } else if (warp < kMmaWarps) {
    // consumer warp w multiplies rows [16 w, 16 w + 16) of each stage by the
    // query, which fills every column of the n8 tile, so each lane's c0 and
    // c2 are the scores of rows g and g + 8; lanes t = 0 and 1 take one
    // each.  It releases the stage once its product is done, so its merge
    // overlaps the refill and the other warps' work.
    const int lr = warp * 16 + g + ((t & 1) << 3);
    const unsigned char* arow = smem + size_t(warp * 16 + (lane & 15)) * 128;
    const int kq = (k + kMmaWarps - 1) / kMmaWarps;
    for (int it = 0; it < ntiles; ++it) {
      const int stg = it % stages;
      mbar_wait(full + stg, (it / stages) & 1);
      const size_t st = size_t(stg) * lay.stage;
      const int* meta = reinterpret_cast<const int*>(smem + st + lay.meta);
      const int slot = s_begin + it * kRows + lr;
      bool ok = t < 2 && slot < cap;
      float rs = 1.f;
      if (ok) {
        const int tg = meta[lr], c = meta[kRows + lr];
        ok = tg != kPadTag && (want_ns < 0 || tg == want_ns) &&
             (want_canon < 0 || c == want_canon);
        if constexpr (kInt8) rs = __int_as_float(meta[2 * kRows + lr]);
      }
      // row r of a stage at r * 128 in each 128-byte block; its 16-byte
      // chunk j at (j ^ (r & 7)) * 16, and r & 7 is lane & 7 for every row
      // this lane addresses.  The query's fragment is the same for every
      // column.  A warp whose rows are all masked skips the product.
      const bool any = __any_sync(kFull, ok);
      Acc acc[4] = {Acc(0), Acc(0), Acc(0), Acc(0)};
#pragma unroll 4
      for (int kb = 0; any && kb < lay.kbytes; kb += 32) {
        uint32_t a[4];
        ldsm_x4(a, arow + st + (kb >> 7) * (kRows * 128) +
                       (((((kb & 127) >> 4) + (lane >> 4)) ^ (lane & 7)) << 4));
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(Qs + kb + 4 * t);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(Qs + kb + 16 + 4 * t);
        if constexpr (kInt8) mma_s8(acc, a, b0, b1);
        else mma_bf16(acc, a, b0, b1);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + stg);
      // int8: float(acc) * row scale, the plain version's f32 product
      // (|acc| < 2^24, exact in f32).  A candidate must beat the warp
      // list's k-th entry, and only a warp that has one merges
      // (warp_merge).  Each warp publishes its list's kq-th score (kq =
      // ceil(k / warps)); the least published score T is a lower bound of
      // the block's k-th, since every warp holds kq entries at or above
      // its own (a published score only rises, so a stale one is lower
      // still).  A score below T is beaten by k entries of the block and
      // is no candidate: the warps' lists then hold the block's top k
      // without each warp inserting its own top k.
      const Acc v = (t & 1) ? acc[2] : acc[0];
      float s = !ok ? -INFINITY : kInt8 ? float(v) * rs : float(v);
      float T = pub[0];
#pragma unroll
      for (int w = 1; w < kMmaWarps; ++w) T = fminf(T, pub[w]);
      if (s < T) s = -INFINITY;
      if (any) {
        warp_merge(Ls, Li, k, s, slot, bm);
        if (lane == 0) pub[warp] = Ls[kq - 1];
      }
    }
  }

  merge_cluster(split, kMmaWarps, wls, cta_s, cta_r, k, smem, size_t(qp) * k, out_sc, out_id);
}

struct ListArgs {
  const void *q, *lists, *scale, *ns, *canon;
  CUtensorMap rows_map;
  int nprobe, cap, d, want_ns, want_canon, k, stages, split, blocks;
  void *out_sc, *out_id;
  cudaStream_t stream;
};

// A cluster launch (cudaLaunchKernelEx) of `kern` over a.blocks blocks in
// clusters of a.split: a refused one returns its error.
int launch_cluster(const void* kern, size_t smem, const ListArgs& a, void** args) {
  if (int e = int(cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       int(smem))))
    return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.blocks);
  cfg.blockDim = dim3(kListThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(a.split);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (int e = int(cudaLaunchKernelExC(&cfg, kern, args))) return e;
  return int(cudaGetLastError());
}

template <typename T, int R>
int launch_split(const ListArgs& a) {
  const T* q = static_cast<const T*>(a.q);
  const int* lists = static_cast<const int*>(a.lists);
  const float* scale = static_cast<const float*>(a.scale);
  const int* ns = static_cast<const int*>(a.ns);
  const int* canon = static_cast<const int*>(a.canon);
  CUtensorMap map = a.rows_map;
  int nprobe = a.nprobe, cap = a.cap, d = a.d, want_ns = a.want_ns, want_canon = a.want_canon;
  int k = a.k, stages = a.stages, split = a.split;
  float* out_sc = static_cast<float*>(a.out_sc);
  int* out_id = static_cast<int*>(a.out_id);
  void* args[] = {&q, &lists, &scale, &ns, &canon, &map, &nprobe, &cap, &d, &want_ns,
                  &want_canon, &k, &stages, &split, &out_sc, &out_id};
  return launch_cluster(reinterpret_cast<const void*>(probe_split_kernel<T, R>),
                        list_smem(sizeof(T), a.d, a.k, a.stages, R).total, a, args);
}

// ---- #6 on f32 lists: the split list probe on the CUDA cores (its
// layout: layout.h's f32_list_smem)

// probe_split_kernel's grid, ranges, selection and merges on f32 lists: a
// block's 128-slot tiles are ceil(d / 32) boxes each, which the producer
// warp's lane 0 keeps `stages` deep in the ring; consumer warp w sums
// slots [16 w, 16 w + 16) of each tile against the query (box_one_query,
// partial sums in registers over the tile's boxes), releasing each stage
// once it has read it, and after the tile's last box selects as
// probe_split_kernel's warps do.  A lane reads its slots' tags when the
// tile starts (slots past cap are masked).
__global__ void __launch_bounds__(kListThreads)
probe_f32_kernel(const float* __restrict__ q, const int* __restrict__ lists,
                 const int* __restrict__ ns, const int* __restrict__ canon,
                 const __grid_constant__ CUtensorMap rows_map, int nprobe, int cap, int d,
                 int want_ns, int want_canon, int k, int stages, int split,
                 float* __restrict__ out_sc, int* __restrict__ out_id) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - smem_u32(smem_raw) % 1024) % 1024);  // swizzle unit
  const F32ListSmem lay = f32_list_smem(d, k, stages);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = int(cluster.block_rank());
  float* Qs = reinterpret_cast<float*>(smem + lay.q);
  float* wls = reinterpret_cast<float*>(smem + lay.lists);  // [warp][2 k]: scores, slots
  float* cta_s = reinterpret_cast<float*>(smem + lay.cta);
  int* cta_r = reinterpret_cast<int*>(cta_s + k);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // a stage's box landed
  uint64_t* empty = full + kMaxStages;                            // its consumers are done
  volatile float* pub = reinterpret_cast<volatile float*>(smem + lay.pub);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int qp = blockIdx.x / split;                  // query * nprobe + probe
  const int boxes = f32_boxes(d);
  const int nb = (cap + kSub - 1) / kSub;
  const int s_begin = kSub * (nb * rank / split);
  const int s_end = min(cap, kSub * (nb * (rank + 1) / split));
  const int ntiles = (s_end - s_begin + kSub - 1) / kSub;
  const long long base = (long long)__ldg(lists + qp) * cap;  // the list's first row

  // the query (zero past d), empty lists, clear bit maps, the barriers
  for (int c = tid * 4; c < boxes * kBoxFloats; c += kListThreads * 4) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c < d) v = *reinterpret_cast<const float4*>(q + size_t(qp / nprobe) * d + c);
    *reinterpret_cast<float4*>(Qs + c) = v;
  }
  for (int i = tid; i < kListWarps * k; i += kListThreads) {
    float* l = wls + size_t(i / k) * 2 * k;
    l[i % k] = -INFINITY;
    reinterpret_cast<int*>(l + k)[i % k] = INT_MAX;
  }
  for (int i = tid; i < kListWarps * kListMapWords; i += kListThreads)
    reinterpret_cast<unsigned*>(smem + lay.bmap)[i] = 0u;
  if (tid < kListWarps) pub[tid] = -INFINITY;
  // the producer (warp kListWarps, lane 0): box `it` of the walk -> stage
  // it % stages once its consumers released it (a box past the list's tail
  // reads the next list's rows, masked below as slot >= cap; past the last
  // list zeros).  It sets up the barriers and issues the ring's first fill
  // before the block's barrier, so the loads start while the block stages
  // the query.
  const int nsteps = ntiles * boxes;
  const bool producer = warp == kListWarps && lane == 0;
  auto fill = [&](int it) {
    const int stg = it % stages;
    mbar_arrive_expect_tx(full + stg, kBoxBytes);
    fence_proxy_async();  // after the consumers' reads of the stage
    tensor_g2s_2d(smem + size_t(stg) * kBoxBytes, &rows_map, (it % boxes) * 128,
                  int(base + s_begin + (it / boxes) * kSub), full + stg);
  };
  if (producer) {
    prefetch_tensormap(&rows_map);
    for (int s = 0; s < stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kListWarps);
    }
    mbar_fence_init();
    for (int it = 0; it < min(stages, nsteps); ++it) fill(it);
  }
  __syncthreads();

  if (warp == kListWarps) {
    if (producer) {
      for (int it = stages; it < nsteps; ++it) {
        mbar_wait(empty + it % stages, (it / stages - 1) & 1);
        fill(it);
      }
    }
  } else {
    // consumer warp w: slots 16 w + g + 8 h of each tile; after a tile's
    // last box every lane t of a g holds both sums, and lanes t = 0 and 1
    // take one each.  probe_split_kernel's selection: a candidate must
    // beat the warp list's k-th entry and the least of the warps'
    // published kq-th scores (kq = ceil(k / warps)), a lower bound of the
    // block's k-th
    float* Ls = wls + size_t(warp) * 2 * k;             // this warp's list
    int* Li = reinterpret_cast<int*>(Ls + k);
    unsigned* bm = reinterpret_cast<unsigned*>(smem + lay.bmap) + warp * kListMapWords;
    const int kq = (k + kListWarps - 1) / kListWarps;
    const int lr = warp * 16 + g + ((t & 1) << 3);      // this lane's slot of a tile
    int it = 0;
    for (int tile = 0; tile < ntiles; ++tile) {
      const int slot = s_begin + tile * kSub + lr;
      bool ok = t < 2 && slot < cap;
      int tg = kPadTag, cn = 0;
      if (ok) {
        tg = __ldg(ns + base + slot);
        cn = __ldg(canon + base + slot);
      }
      float acc[2] = {0.f, 0.f};
      for (int box = 0; box < boxes; ++box, ++it) {
        const int stg = it % stages;
        mbar_wait(full + stg, (it / stages) & 1);
        box_one_query(acc, smem + size_t(stg) * kBoxBytes, warp * 16, Qs + box * kBoxFloats, g, t);
        __syncwarp();
        if (lane == 0) mbar_arrive(empty + stg);
      }
      const float s0 = sum_quarters(acc[0]), s1 = sum_quarters(acc[1]);
      ok = ok && tg != kPadTag && (want_ns < 0 || tg == want_ns) &&
           (want_canon < 0 || cn == want_canon);
      float s = !ok ? -INFINITY : (t & 1) ? s1 : s0;
      float T = pub[0];
#pragma unroll
      for (int w = 1; w < kListWarps; ++w) T = fminf(T, pub[w]);
      if (s < T) s = -INFINITY;
      warp_merge(Ls, Li, k, s, slot, bm);
      if (lane == 0) pub[warp] = Ls[kq - 1];
    }
  }
  merge_cluster(split, kListWarps, wls, cta_s, cta_r, k, smem, size_t(qp) * k, out_sc, out_id);
}

int launch_f32_list(const ListArgs& a) {
  const float* q = static_cast<const float*>(a.q);
  const int* lists = static_cast<const int*>(a.lists);
  const int* ns = static_cast<const int*>(a.ns);
  const int* canon = static_cast<const int*>(a.canon);
  CUtensorMap map = a.rows_map;
  int nprobe = a.nprobe, cap = a.cap, d = a.d, want_ns = a.want_ns, want_canon = a.want_canon;
  int k = a.k, stages = a.stages, split = a.split;
  float* out_sc = static_cast<float*>(a.out_sc);
  int* out_id = static_cast<int*>(a.out_id);
  void* args[] = {&q, &lists, &ns, &canon, &map, &nprobe, &cap, &d, &want_ns, &want_canon,
                  &k, &stages, &split, &out_sc, &out_id};
  return launch_cluster(reinterpret_cast<const void*>(probe_f32_kernel),
                        f32_list_smem(a.d, a.k, a.stages).total, a, args);
}

}  // namespace

// #6: q (nq, d) and vec (nlist, cap, d) share `dtype`; lists (nq * nprobe)
// int32; scale (nlist, cap) f32 is read for int8 only; ns/canon (nlist, cap)
// int32.  Out (nq * nprobe, k): each list's top k, sorted, slot -1 for -inf.
// Each list is split over `split` (1-8) blocks, a cluster, with `stages`
// (2-8) ring stages; cap % 4 == 0 and split <= ceil(cap / 128); q and vec
// 16-byte aligned (TMA).
//   bf16/int8 (probe_split_kernel): stages of `rows` (64 or 128) rows; ns,
//     canon (and scale for int8) 16-byte aligned (bulk copies).
//   f32 (probe_f32_kernel): one-box stages (128 slots x 32 floats); `rows`
//     is 128.
extern "C" int tr_probe_list(const void* q, const void* lists, const void* vec,
                             const void* scale, const void* ns, const void* canon, int nlist,
                             int nq, int nprobe, int cap, int d, int want_ns, int want_canon,
                             int k, int dtype, int split, int rows, int stages, void* out_sc,
                             void* out_id, void* stream) {
  const int nb = (cap + kSub - 1) / kSub;
  if (nlist <= 0 || nq <= 0 || nprobe <= 0 || cap <= 0 || d <= 0 || d % 16 != 0 || k <= 0 ||
      k > kMaxK || k > cap || cap % 4 != 0 || split < 1 || split > kMaxSplit || split > nb ||
      stages < 2 || stages > kMaxStages || (long long)nq * nprobe * split > INT_MAX ||
      !aligned16(q) || !aligned16(vec))
    return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  ListArgs a{q, lists, scale, ns, canon, {}, nprobe, cap, d, want_ns, want_canon, k,
             stages, split, nq * nprobe * split, out_sc, out_id, s};
  if (dtype == TR_F32) {
    if (rows != kBoxRows || f32_list_smem(d, k, stages).total > kSmemMax ||
        !rows_tensor_map(&a.rows_map, vec, (long long)nlist * cap, d * 4, kBoxRows))
      return int(cudaErrorInvalidValue);
    return launch_f32_list(a);
  }
  const int elt = elt_of(dtype);
  if ((dtype != TR_BF16 && dtype != TR_I8) || (rows != 64 && rows != 128) ||
      (d * elt + 127) / 128 + 3 > 32 ||      // the producer warp's lanes issue the copies
      !aligned16(ns) || !aligned16(canon) || (dtype == TR_I8 && !aligned16(scale)) ||
      list_smem(elt, d, k, stages, rows).total > kSmemMax ||
      !rows_tensor_map(&a.rows_map, vec, (long long)nlist * cap, d * elt, rows))
    return int(cudaErrorInvalidValue);
  if (dtype == TR_BF16)
    return rows == 128 ? launch_split<__nv_bfloat16, 128>(a) : launch_split<__nv_bfloat16, 64>(a);
  return rows == 128 ? launch_split<int8_t, 128>(a) : launch_split<int8_t, 64>(a);
}

// #7: q (nq, d) and vec (nlist, cap, d) share `dtype`; uniq (u_max) int32
// list ids, of which the first *n_uniq (a device int) are live; scale / ns /
// canon as for #6.  cap % 128 == 0, 1 <= m <= 4.  Out (u_max, nq, m * cap /
// 128): pass-major, then bucket.  Query chunks of qc on the last grid axis.
//   bf16/int8 (pipe_bucket_kernel): qc in {8, 16, 32, 64}, 2 <= stages <= 8,
//     `blocks` blocks a chunk; q, vec, ns, canon (and scale for int8)
//     16-byte aligned (bulk copies).
//   f32 (batched_bucket_kernel): qc in {16, 32, 64}, 2 <= stages <= 8,
//     `blocks` blocks a chunk; q, vec, ns, canon 16-byte aligned.
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
  if (dtype != TR_F32 || (qc != 16 && qc != 32 && qc != 64) || stages < 2 ||
      stages > kMaxStages || !aligned16(q) ||
      !aligned16(vec) || !aligned16(ns) || !aligned16(canon) ||
      f32_bucket_smem(d, qc, stages).total > kSmemMax)
    return int(cudaErrorInvalidValue);
  BucketArgs a{q, uniq, n_uniq, vec, scale, ns, canon, {}, nq, u_max, cap, d,
               want_ns, want_canon, stages, blocks, out_sc, out_id, s};
  if (!rows_tensor_map(&a.rows_map, vec, (long long)nlist * cap, d * 4, kSub))
    return int(cudaErrorInvalidValue);
  return launch_f32_bucket_qc(qc, m, a);
}
