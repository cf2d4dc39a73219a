// Shared-memory layouts of the hand-written kernels, written once.
//
// The scans of topk.cu (#1-#3), the probes of ivf_probe.cu (#6, #7) and
// #5 of attention.cu size their dynamic shared memory from the functions
// below, and their launches pass the same totals to the runtime.  The
// header includes no CUDA header: nvcc compiles it into the kernels (TR_HD
// is __host__ __device__ there) and g++ into native/layout.cc, whose C
// interface the Python wrappers' launch plans (ops/topk.py,
// ops/ivf_probe.py) and the tests call.  So each byte count, and each
// choice made from one (a stage's rows, a ring's depth, the scan's
// kernel), has one copy, and the CPU tests hold the code the card runs.
#pragma once

#include <stddef.h>

#ifdef __CUDACC__
#define TR_HD __host__ __device__
#else
#define TR_HD
#endif

// dtype codes shared with the Python wrappers
enum TrDtype { TR_F32 = 0, TR_BF16 = 1, TR_I8 = 2 };

TR_HD inline size_t tr_align128(size_t x) { return (x + 127) & ~size_t(127); }

namespace tr_tile {
constexpr int kSub = 128;   // rows of a bucket (#3, #7) and of a scan's row tile
constexpr int kMaxK = 128;  // longest per-list (#6) selection
}  // namespace tr_tile

namespace tr_box {
constexpr int kBoxFloats = 32;            // f32 floats of a row in one box
constexpr int kBoxRows = 128;             // rows of a box: one bucket
constexpr int kBoxBytes = kBoxRows * 128; // 16 KB, a multiple of the 1024-byte swizzle unit

TR_HD inline int f32_boxes(int d) { return (d + kBoxFloats - 1) / kBoxFloats; }

// Row stride (floats) of f32 queries staged in shared memory: d rounded up
// to whole boxes, plus 4, so rows sit 16 bytes past a multiple of 128 and
// the four queries a quarter warp reads (2t + e) fall in distinct bank
// groups.
TR_HD inline int f32_query_ld(int d) { return f32_boxes(d) * kBoxFloats + 4; }

TR_HD inline size_t align1024(size_t x) { return (x + 1023) & ~size_t(1023); }
}  // namespace tr_box

namespace tr_layout {

constexpr int kSmSmem = 233472;              // shared memory of one H100 SM
constexpr size_t kSmemMax = kSmSmem - 1024;  // of one block (each reserves 1,024 more)
constexpr int kMaxStages = 8;                // ring stages of a scan or probe block

// The bytes one block may use while `per_sm` blocks share an SM.
TR_HD constexpr size_t sm_share(int per_sm) {
  return size_t(kSmSmem / per_sm - 1024) < kSmemMax ? size_t(kSmSmem / per_sm - 1024)
                                                     : kSmemMax;
}

// Ring stages of `stage` bytes that fit a budget beside `fixed` bytes.
TR_HD inline size_t ring_fit(size_t fixed, size_t stage, size_t budget) {
  const size_t fit = fixed < budget ? (budget - fixed) / stage : 0;
  return fit < size_t(kMaxStages) ? fit : size_t(kMaxStages);
}

TR_HD inline int elt_of(int dtype) { return dtype == TR_F32 ? 4 : dtype == TR_BF16 ? 2 : 1; }

// ---- the scans of topk.cu

// selection of the scan kernels
enum ScanMode { kBucketed = 0, kExact = 1, kPacked = 2 };

constexpr int kPipeWarps = 8;

// Shared-memory layout of pipe_scan_kernel (int8 rows).  A staged row is
// its d bytes rounded up to the 32-byte MMA step, plus 16 bytes: an odd
// number of 16-byte units, so the eight rows an ldmatrix reads fall in
// distinct banks.
struct PipeSmem { int kbytes, ld; size_t qs, ring, meta, stage, list, scratch, cmask, bmap, bar, total; };

TR_HD inline PipeSmem pipe_smem(int d, int qc, int k, int mode, int stages, int rows) {
  PipeSmem o;
  o.kbytes = (d + 31) / 32 * 32;
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
TR_HD inline size_t pipe_fit(int d, int qc, int k, int mode, int rows) {
  const size_t fixed = pipe_smem(d, qc, k, mode, 0, rows).total;
  return ring_fit(fixed, pipe_smem(d, qc, k, mode, 1, rows).total - fixed, kSmemMax);
}

// Rows of one ring stage: 128 (one m16 tile a warp) for a chunk of 8
// queries where the stages that fit beside the lists keep 64 KB of rows in
// flight, else 64, the 8 warps then splitting the queries in two halves (a
// chunk of 8: 4 warps multiply).
TR_HD inline int pipe_rows(int d, int qc, int k, int mode) {
  if (qc != 8) return 64;
  const size_t stages = pipe_fit(d, qc, k, mode, 128);
  return stages >= 2 && (stages - 1) * 128 * d >= 65536 ? 128 : 64;
}

constexpr int kBoxWarps = 8;  // consumer warps of box_scan_kernel

// The scan's kernel: f32 and bf16 rows take box_scan_kernel, int8 rows
// pipe_scan_kernel.
TR_HD inline bool box_route(int dtype) { return dtype != TR_I8; }

// Warp tiling of a 128-row tile for a chunk of QC queries: a warp
// multiplies kMTW m16 row tiles by kNTW n8 query tiles (QC 1, f32 only:
// the one query, box_one_query); the 8 warps are kWR row groups x kWQ
// query groups.
TR_HD constexpr int box_mtw(int qc) { return qc >= 16 ? 2 : 1; }
TR_HD constexpr int box_wr(int qc) { return tr_tile::kSub / (16 * box_mtw(qc)); }

// Shared-memory layout of box_scan_kernel, from a 1024-byte aligned base
// (1024 bytes of slack): `stages` ring stages of one box (128 rows x 128
// bytes, the tensor map's swizzle); the queries (qc rows of whole boxes
// plus 16 bytes, so the rows a quarter warp reads fall in distinct bank
// groups); exact/packed: the sorted lists (qc x k scores, then slots), the
// candidates' scores ([128 rows][qc + 1]), their rows' bit masks ([qc][4
// words]), a 1024-bit merge map a warp and each list's count of real
// entries ([qc]); bucketed: two tables of the row groups' maxima ([2][kWR]
// [qc] scores, then rows); two mbarriers per possible stage (its box
// landed; its consumers are done with it).
struct BoxScanSmem { int boxes, ld; size_t q, list, scratch, cmask, bmap, fill, bar, total; };

TR_HD inline BoxScanSmem box_scan_smem(int elt, int d, int qc, int k, int mode, int stages) {
  BoxScanSmem o;
  const bool list = mode != kBucketed;
  o.boxes = (d * elt + 127) / 128;
  o.ld = o.boxes * 128 + 16;                                         // bytes of a query row
  o.q = size_t(stages) * tr_box::kBoxBytes;                         // the ring at 0
  o.list = o.q + tr_align128(size_t(qc) * o.ld);
  o.scratch = o.list + (list ? tr_align128(size_t(qc) * k * 8) : 0);
  o.cmask = o.scratch + tr_align128(list ? size_t(tr_tile::kSub) * (qc + 1) * 4
                                         : 2 * size_t(box_wr(qc)) * qc * 8);
  o.bmap = o.cmask + (list ? tr_align128(size_t(qc) * (tr_tile::kSub / 32) * 4) : 0);
  o.fill = o.bmap + (list ? size_t(kBoxWarps) * 32 * 4 : 0);
  o.bar = o.fill + (list ? tr_align128(size_t(qc) * 4) : 0);
  o.total = 1024 + o.bar + 2 * size_t(kMaxStages) * 8;
  return o;
}

// ---- the probes of ivf_probe.cu

constexpr int kMaxM = 4;  // bucket winners a query keeps (#7)

// Warp tiling of one stage of `rows` rows for qc = 8 nt queries (#7): a
// warp multiplies kMTW m16 row tiles by kNTW n8 query tiles; the 8 warps
// are kWR row tiles x kWQ query groups (at rows 64 and 8 queries, 4 warps
// idle in the product).  At 64 queries and 128 rows a warp multiplies 32
// rows x 32 queries: ~197 KB of ldmatrix a bucket, where 16 x 64 reads
// ~246 KB (every query fragment again every 16 rows), and a thread selects
// for 8 query columns, not 16.
TR_HD constexpr int bucket_mtw(int nt, int rows) {
  return rows == 128 ? (nt >= 2 ? 2 : 1) : (nt >= 4 ? 2 : 1);
}
TR_HD constexpr int bucket_wr(int nt, int rows) { return rows / (16 * bucket_mtw(nt, rows)); }

// int8 query rows of at most kQRegBytes: each warp keeps its query
// fragments in registers for the whole block
constexpr int kQRegBytes = 384;

// Shared-memory layout of pipe_bucket_kernel, from a 1024-byte aligned base
// (1024 bytes of slack): the queries (qc rows of d * elt bytes rounded up to
// the 32-byte MMA step, plus 16: an odd number of 16-byte units, so the
// eight rows an ldmatrix reads fall in distinct banks), then `stages`
// stages, each `boxes` blocks of `rows` rows x 128 bytes (the tensor map's
// swizzled boxes) and the rows' ns, canon and scale, rounded up to 1024
// bytes; the two tables of the warps' winners ([2][row tile][query][kMaxM]
// scores, then slots); one mbarrier per possible stage.  Where the queries
// live in registers (qreg) they are staged in the last ring stage, which
// the ring first fills after the warps have read them.
struct BucketSmem {
  int kbytes, ld, boxes;
  bool qreg;
  size_t q, ring, meta, stage, tab, bar, total;
};

TR_HD inline BucketSmem bucket_smem(int elt, int d, int qc, int stages, int rows) {
  BucketSmem o;
  o.kbytes = (d * elt + 31) / 32 * 32;
  o.ld = o.kbytes + 16;
  o.boxes = (d * elt + 127) / 128;
  o.qreg = elt == 1 && o.kbytes <= kQRegBytes;
  o.ring = o.qreg ? 0 : tr_box::align1024(size_t(qc) * o.ld);
  o.meta = size_t(o.boxes) * rows * 128;                   // within a stage
  o.stage = tr_box::align1024(o.meta + 3 * size_t(rows) * 4);
  o.q = o.qreg ? size_t(stages > 0 ? stages - 1 : 0) * o.stage : 0;
  o.tab = o.ring + size_t(stages) * o.stage;
  o.bar = o.tab + 2 * size_t(bucket_wr(qc / 8, rows)) * qc * kMaxM * 8;
  o.total = 1024 + o.bar + size_t(kMaxStages) * 8;
  return o;
}

// Rows of a stage: 128 (one bucket) where three such stages fit, else 64.
TR_HD inline int bucket_rows(int elt, int d, int qc) {
  const size_t fixed = bucket_smem(elt, d, qc, 0, 128).total;
  const size_t stage = bucket_smem(elt, d, qc, 1, 128).total - fixed;
  return fixed < kSmemMax && (kSmemMax - fixed) / stage >= 3 ? 128 : 64;
}

// Shared-memory layout of batched_bucket_kernel (#7 on f32 lists), from a
// 1024-byte aligned base (1024 bytes of slack): the queries (qc rows of d
// floats rounded up to whole boxes, plus 4: rows 16 bytes past a multiple
// of 128, so the four queries a quarter warp reads fall in distinct bank
// groups), then `stages` stages, each one box (128 rows x 128 bytes, the
// tensor map's swizzle) and the bucket's ns and canon (fetched with its
// first box), rounded up to 1024 bytes; the two tables of the warps'
// winners; one mbarrier per possible stage.
struct F32BucketSmem {
  int boxes, ld;
  size_t ring, meta, stage, tab, bar, total;
};

TR_HD inline F32BucketSmem f32_bucket_smem(int d, int qc, int stages) {
  F32BucketSmem o;
  o.boxes = tr_box::f32_boxes(d);
  o.ld = tr_box::f32_query_ld(d);
  o.ring = tr_box::align1024(size_t(qc) * o.ld * 4);
  o.meta = size_t(tr_tile::kSub) * 128;  // within a stage
  o.stage = tr_box::align1024(o.meta + 2 * size_t(tr_tile::kSub) * 4);
  o.tab = o.ring + size_t(stages) * o.stage;
  o.bar = o.tab + 2 * size_t(bucket_wr(qc / 8, tr_tile::kSub)) * qc * kMaxM * 8;
  o.total = 1024 + o.bar + size_t(kMaxStages) * 8;
  return o;
}

constexpr int kListWarps = 8;                        // consumer warps (#6)
constexpr int kListMapWords = tr_tile::kMaxK / 32;   // warp_merge's bit map (k <= 128)

// Shared-memory layout of probe_split_kernel (#6 on bf16/int8 lists), from
// a 1024-byte aligned base (1024 bytes of slack): `stages` ring stages,
// each `boxes` blocks of `rows` rows x 128 bytes (the tensor map's swizzled
// boxes) and the rows' ns, canon and scale, rounded up to 1024 bytes; the
// query (d * elt bytes rounded up to the 32-byte MMA step); the 8 warps'
// sorted lists (k scores, then k slots, a warp); the block's merged list;
// the warps' bit maps of warp_merge; the warps' published scores; two
// mbarriers per possible stage (its rows landed; its consumers are done
// with it).
struct ListSmem {
  int kbytes, boxes;
  size_t meta, stage, q, lists, cta, bmap, pub, bar, total;
};

TR_HD inline ListSmem list_smem(int elt, int d, int k, int stages, int rows) {
  ListSmem o;
  o.kbytes = (d * elt + 31) / 32 * 32;
  o.boxes = (d * elt + 127) / 128;
  o.meta = size_t(o.boxes) * rows * 128;                   // within a stage
  o.stage = tr_box::align1024(o.meta + 3 * size_t(rows) * 4);
  o.q = size_t(stages) * o.stage;
  o.lists = o.q + tr_align128(o.kbytes);
  o.cta = o.lists + tr_align128(size_t(kListWarps) * k * 8);
  o.bmap = o.cta + tr_align128(size_t(k) * 8);
  o.pub = o.bmap + size_t(kListWarps) * kListMapWords * 4;
  o.bar = o.pub + 64;
  o.total = 1024 + o.bar + 2 * size_t(kMaxStages) * 8;
  return o;
}

// Shared-memory layout of probe_f32_kernel (#6 on f32 lists), from a
// 1024-byte aligned base (1024 bytes of slack): `stages` one-box stages
// (128 slots x 32 floats, the tensor map's swizzle); the query (d floats
// rounded up to whole boxes); the 8 warps' sorted lists; the block's merged
// list; the warps' bit maps of warp_merge; the warps' published scores; two
// mbarriers per possible stage (its box landed; its consumers are done with
// it).
struct F32ListSmem { size_t q, lists, cta, bmap, pub, bar, total; };

TR_HD inline F32ListSmem f32_list_smem(int d, int k, int stages) {
  F32ListSmem o;
  o.q = size_t(stages) * tr_box::kBoxBytes;
  o.lists = o.q + tr_align128(size_t(tr_box::f32_boxes(d)) * 128);
  o.cta = o.lists + tr_align128(size_t(kListWarps) * k * 8);
  o.bmap = o.cta + tr_align128(size_t(k) * 8);
  o.pub = o.bmap + size_t(kListWarps) * kListMapWords * 4;
  o.bar = o.pub + 64;
  o.total = 1024 + o.bar + 2 * size_t(kMaxStages) * 8;
  return o;
}

// ---- #5 of attention.cu
namespace mha {

constexpr int kWarps = 8;
constexpr int kQTile = 16 * kWarps;  // query rows per block (128)
constexpr int kChunk = 64;           // keys per softmax step and ring stage
constexpr int kTMax = 512;
constexpr int kSmemTwo = int(sm_share(2));  // a block's share when two share an SM

TR_HD constexpr int row_ld(int D) { return D + 8; }  // + 16 bytes
TR_HD constexpr int tc_imin(int a, int b) { return a < b ? a : b; }

// Ring stages of mha_tc_kernel<D>: one a 64-key chunk of T, at most as many
// as leave room for two blocks an SM (the kernel's registers allow two): 8
// at D 32, so T <= 512 is held whole; 5 at D 64 (a block holding T 512's
// whole K and V took 167,936 bytes, one block an SM).
TR_HD constexpr int tc_stages(int D, int T) {
  return tc_imin((T + kChunk - 1) / kChunk,
                 tc_imin(8, (kSmemTwo - 128 * row_ld(D) * 2 - kTMax * 4) /
                                (2 * kChunk * row_ld(D) * 2)));
}

// Shared-memory layout of mha_tc_kernel<D>: the Q tile, then the ring's
// chunks of K and of V (rows of D + 8 bf16), then every key's flag over T's
// chunks.
TR_HD constexpr size_t tc_smem_bytes(int D, int T) {
  return size_t(kQTile + 2 * tc_stages(D, T) * kChunk) * row_ld(D) * 2 +
         size_t((T + kChunk - 1) / kChunk) * kChunk * 4;
}

constexpr int kF32Rows = 128;  // query rows of an f32 block
constexpr int kF32Keys = 64;   // keys of a ring chunk
constexpr int kF32Stages = 3;  // ring chunks

// Shared-memory layout of mha_f32_kernel<D> in floats: the Q tile, the K
// and V rings (rows of D + 4 floats), P^T (rows of kF32Rows + 4), the
// ring's key flags.
struct F32Smem { int ld, lp, q, k, v, p, flags, total; };

TR_HD inline F32Smem f32_smem(int D) {
  F32Smem o;
  o.ld = D + 4;
  o.lp = kF32Rows + 4;
  o.q = 0;
  o.k = o.q + kF32Rows * o.ld;
  o.v = o.k + kF32Stages * kF32Keys * o.ld;
  o.p = o.v + kF32Stages * kF32Keys * o.ld;
  o.flags = o.p + kF32Keys * o.lp;
  o.total = o.flags + kF32Stages * kF32Keys;
  return o;
}

}  // namespace mha
}  // namespace tr_layout
