// Attention over rows padded at the end, in a window or over every key:
// ModernBERT's local and global layers, forward and backward.
//
// Replaces no TPU kernel: tpu_rag's ModernBERT-free encoders have none for
// this, and #5 (csrc/attention.cu, tpu_rag/ops/attention.py's _mha_kernel)
// runs forward only, at T <= 512, with no window.  It was added because a
// fused library attention under an additive mask scores every slot of
// every row (T x T on a global layer, every band block past a row's end),
// while rows of a long-document batch are mostly shorter than T.
//
// Per (row b, head h): o_i = softmax_j(q_i . k_j / sqrt(D)) . v_j over the
// keys j < L_b with |i - j| <= w (w < 0: every key below L_b), where L_b
// is lengths[b]: the row's real tokens are its first L_b.  Query rows
// i >= L_b come out as zeros and take no gradient; keys j >= L_b take
// none either.  q, k, v, o and the gradients are (B, T, H, D) bf16, D 64;
// lse (B, H, T) f32 holds each row's log2-sum-exp2 of its scaled scores.
//
// What bounds it on the H100: the products.  A 128-query tile against
// one 64-key chunk is 2 x 128 x 64 x 64 x 2 = 2.1 MFLOP forward from 16 KB
// of K and V, ~128 operations a byte read from L2 and far more from device
// memory (K and V of a head are read once a query tile); so the ideal
// kernel runs at the tensor cores' rate over the tiles it visits, and the
// design is about visiting few tiles, and about the rate on those:
//   - one block of 8 warps a (b, h, 128-row tile); a block whose tile
//     starts at or past L_b writes its zeros and exits; rows past L_b in
//     a live tile compute nothing where a whole work unit lies past it
//     (a forward warpgroup's 64 rows, a backward warp's 16);
//   - the other side's loop runs over [max(0, i0 - w), min(L_b, i1 + w))
//     in 64-row chunks (the start floored to a chunk), through a cp.async
//     ring, and a unit skips a chunk that none of its rows reaches; only
//     chunks that cross L_b or the band's edge are masked pair by pair (a
//     uniform branch);
//   - forward on wgmma: each warpgroup issues Q . K^T from the ring's
//     128-byte-swizzled stages (both operands by descriptor), an online
//     softmax in f32 in the log2 domain (one fused multiply-add and one
//     exp2 a score), P rounded to bf16 in registers as the A operand of
//     P . V (V by descriptor, MN-major), O in f32 divided once at the
//     end; the row's log2-sum-exp2 saved.  Two blocks an SM (four
//     warpgroups) keep the tensor cores fed while each does its softmax;
//   - backward on mma.sync m16n8k16 with ldmatrix, rows padded by 16 bytes
//     so the eight rows of a matrix fall in distinct banks; an
//     accumulator's two 8-column tiles are the A operand of one 16-deep
//     step of the next product (dS . K, P^T . dO, dS^T . Q) without a
//     trip through shared memory.  No atomics, so two runs agree bit for
//     bit: one kernel a query tile computes delta_i = dO_i . O_i (saved
//     for the next kernel) and dQ over its key chunks; a second kernel a
//     key tile computes dK and dV over the query chunks that reach it;
//     each recomputes P = exp2(s log2(e) / sqrt(D) - lse) and dP.
// One instantiation (bf16, D 64), the window a run-time argument.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma_sm90.cuh"

using namespace tr_mma;

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;
constexpr int kLD = kD + 8;            // a backward shared row: 64 bf16 + 16 bytes
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 16 * kWarps;     // rows of a block (128)
constexpr int kChunk = 64;             // rows of a ring stage
constexpr int kStages = 4;
constexpr int kPieces = kD / 8;        // 16-byte pieces of a head row
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTileBytes = kTile * kLD * 2;
constexpr int kChunkBytes = kChunk * kLD * 2;
// the Q and dO tiles, the ring's K and V chunks, delta of the tile's rows
constexpr int kDqSmem = 2 * kTileBytes + 2 * kStages * kChunkBytes + kTile * 4;
// the K and V tiles, the ring's Q and dO chunks and their lse and delta
constexpr int kDkvSmem = 2 * kTileBytes + kStages * (2 * kChunkBytes + 2 * kChunk * 4);

enum { kRunForward = 0, kRunBackward = 1, kRunBanded = 2 };

// Columns [lo, hi) that rows [r0, r1) reach: within w of a row (w < 0:
// every column) and below L; lo floored to a chunk.  Symmetric, so it is
// the keys of a query tile and the queries of a key tile alike.
__device__ __forceinline__ int2 reach(int r0, int r1, int L, int w) {
  const int lo = w < 0 ? 0 : max(0, r0 - w);
  const int hi = w < 0 ? L : min(L, r1 + w);
  return make_int2(lo / kChunk * kChunk, hi);
}

// Whether rows [r0, r0 + n) reach any column of chunk [c, c + 64).
__device__ __forceinline__ bool reaches(int r0, int n, int c, int w) {
  return w < 0 || (c <= r0 + n - 1 + w && c + kChunk - 1 >= r0 - w);
}

// Whether some pair of rows [r0, r0 + n) x columns [c, c + 64) is masked:
// a row or a column at or past L, or a pair farther apart than w.
__device__ __forceinline__ bool partial(int r0, int n, int c, int L, int w) {
  return r0 + n > L || c + kChunk > L ||
         (w >= 0 && (c + kChunk - 1 > r0 + w || c < r0 + n - 1 - w));
}

__device__ __forceinline__ bool kept(int row, int col, int L, int w) {
  return row < L && col < L && (w < 0 || abs(row - col) <= w);
}

// 2^x on the special-function unit, subnormal results flushed to zero
// (exp2f without fast math wraps the same instruction in three more for
// subnormals); 2^-inf = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Counts a run of the kernel on the device (replays of a CUDA graph too).
__device__ __forceinline__ void count_run(unsigned long long* runs, int slot, bool banded) {
  if (runs != nullptr && threadIdx.x == 0 && blockIdx.x == 0 && blockIdx.y == 0 &&
      blockIdx.z == 0) {
    atomicAdd(runs + slot, 1ull);
    if (banded) atomicAdd(runs + kRunBanded, 1ull);
  }
}

// Zeros rows [r0, r1) of one head of x; the block's threads from `first`
// with stride `stride`.
__device__ __forceinline__ void zero_rows(bf16* x, size_t base, size_t rs, int r0, int r1,
                                          int first, int stride) {
  for (int i = first; i < (r1 - r0) * kPieces; i += stride)
    *reinterpret_cast<uint4*>(x + base + size_t(r0 + i / kPieces) * rs + (i % kPieces) * 8) =
        make_uint4(0u, 0u, 0u, 0u);
}

// rows [r0, r0 + n) of one head -> shared rows of kLD (zero past T)
__device__ __forceinline__ void copy_rows(bf16* s, const bf16* x, size_t base, size_t rs, int r0,
                                          int n, int T, int tid) {
  for (int i = tid; i < n * kPieces; i += kThreads) {
    const int r = i / kPieces, cc = (i % kPieces) * 8;
    const bool ok = r0 + r < T;
    cp_async16(s + r * kLD + cc, x + base + size_t(ok ? r0 + r : 0) * rs + cc, ok);
  }
}

// acc (16 rows x 8 columns, f32) += A (16 x 64, its four 16-deep steps in
// `a`) . B^T, B's 8 rows of 64 at `rows` (shared, kLD apart): rows as N.
// kf: A fragments [4][4]; s: [8][4] accumulators over 64 columns.
__device__ __forceinline__ void product_nt(float (&s)[8][4], const uint32_t (&a)[4][4],
                                           const bf16* rows, int lane) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const bf16* r8 = rows + (nt * 8 + (lane & 7)) * kLD + (lane >> 3) * 8;
#pragma unroll
    for (int kp = 0; kp < kD / 32; ++kp) {
      uint32_t r[4];
      ldsm_x4(r, r8 + kp * 32);
      mma_bf16(s[nt], a[2 * kp], r[0], r[1]);
      mma_bf16(s[nt], a[2 * kp + 1], r[2], r[3]);
    }
  }
}

// acc (16 x 64, [8][4]) += P (16 x 64 accumulators, rounded to bf16) . X,
// X's 64 rows of 64 at `rows` (shared): rows as the depth.
__device__ __forceinline__ void product_nn(float (&acc)[8][4], const float (&p)[8][4],
                                           const bf16* rows, int lane) {
#pragma unroll
  for (int kj = 0; kj < 4; ++kj) {
    const uint32_t a[4] = {pack_bf16(p[2 * kj][0], p[2 * kj][1]),
                           pack_bf16(p[2 * kj][2], p[2 * kj][3]),
                           pack_bf16(p[2 * kj + 1][0], p[2 * kj + 1][1]),
                           pack_bf16(p[2 * kj + 1][2], p[2 * kj + 1][3])};
    const bf16* xr = rows + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLD + (lane >> 4) * 8;
#pragma unroll
    for (int dn = 0; dn < kD / 16; ++dn) {
      uint32_t r[4];
      ldsm_x4_trans(r, xr + dn * 16);
      mma_bf16(acc[2 * dn], a, r[0], r[1]);
      mma_bf16(acc[2 * dn + 1], a, r[2], r[3]);
    }
  }
}

// A fragments of a warp's 16 shared rows (kLD apart) at `rows`.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* rows, int lane) {
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    ldsm_x4(a[kk], rows + (lane & 15) * kLD + kk * 16 + (lane >> 4) * 8);
}

__device__ __forceinline__ void zero_acc(float (&acc)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
}

// A warp's accumulator rows g and g + 8 (r0 + g, r0 + g + 8) to x, times
// `scale`; rows at or past L as zeros, rows past T not at all.
__device__ __forceinline__ void store_rows(bf16* x, size_t base, size_t rs, int r0, int L, int T,
                                           const float (&acc)[8][4], float scale0, float scale1,
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
  const int ra = r0 + g, rb = ra + 8;
  const float sa = ra < L ? scale0 : 0.f, sb = rb < L ? scale1 : 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = j * 8 + 2 * t;
    if (ra < T)
      *reinterpret_cast<__nv_bfloat162*>(x + base + size_t(ra) * rs + c) =
          __floats2bfloat162_rn(acc[j][0] * sa, acc[j][1] * sa);
    if (rb < T)
      *reinterpret_cast<__nv_bfloat162*>(x + base + size_t(rb) * rs + c) =
          __floats2bfloat162_rn(acc[j][2] * sb, acc[j][3] * sb);
  }
}

// ---------------------------------------------------------------- forward
constexpr int kWgRows = 64;                      // query rows of a warpgroup
constexpr int kSwChunk = kChunk * 128;           // a ring stage: 64 rows of 128 bytes, swizzled
// 1,024 bytes of slack for the swizzle's alignment, the Q tile, the
// ring's K and V chunks
constexpr int kFwdSmem = 1024 + kTile * 128 + 2 * kStages * kSwChunk;

// Byte offset of the 16-byte piece c of row r in a tile of 128-byte rows
// under the 128-byte swizzle (the layout wgmma's descriptors name).
__device__ __forceinline__ int sw_off(int r, int c) { return r * 128 + ((c ^ (r & 7)) << 4); }

// rows [r0, r0 + n) of one head -> a swizzled tile at s (zero past T)
__device__ __forceinline__ void copy_rows_sw(unsigned char* s, const bf16* x, size_t base,
                                             size_t rs, int r0, int n, int T, int tid) {
  for (int i = tid; i < n * kPieces; i += kThreads) {
    const int r = i / kPieces, c = i % kPieces;
    const bool ok = r0 + r < T;
    cp_async16(s + sw_off(r, c), x + base + size_t(ok ? r0 + r : 0) * rs + c * 8, ok);
  }
}

// wgmma's descriptor of an operand in 128-byte-swizzled rows at shared
// address `addr`: 8-row groups 1,024 bytes apart (SBO); LBO unused (one
// swizzle atom spans the operand's 64 columns).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return uint64_t((addr & 0x3FFFF) >> 4) | (uint64_t(1) << 16) | (uint64_t(1024 >> 4) << 32) |
         (uint64_t(1) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// d (64 x 64 f32 of the warpgroup; this thread's 32 in mma.sync's m16n8
// layout over its warp's 16 rows) += a (64 x 16 bf16 in registers, A
// fragments as mma.sync's) . B (16 x 64 at desc, MN-major: V's rows).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

// d (as wgmma_rs's) = (accumulate ? d : 0) + A (64 x 16 at desc_a) . B (16 x
// 64 at desc_b), both K-major: Q's and K's rows.
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t desc_a, uint64_t desc_b,
                                         int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate)
      : "memory");
}

// Pins registers at this point of the program: wgmma reads its A
// fragments and accumulators and writes the accumulators asynchronously,
// so no write of them may move below the fence before it, no read of an
// accumulator above the wait that ends it, and no register of either may
// be given to another value before that wait.
__device__ __forceinline__ void pin(float (&d)[8][4]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

__device__ __forceinline__ void pin(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

// One block a (b, h, 128-query tile), two warpgroups of 64 rows: each
// scores a 64-key chunk with Q and K from the ring's swizzled stages (Q .
// K^T) and P from registers (P . V).
__global__ void __launch_bounds__(kThreads, 2)
ragged_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const int* __restrict__ lengths,
                  bf16* __restrict__ o, float* __restrict__ lse, int T, int H, int w,
                  float scale_log2, unsigned long long* runs) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + kTile * 128;           // [kStages][kChunk rows]
  unsigned char* Vs = Ks + kStages * kSwChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTile;
  const size_t rs = size_t(H) * kD;
  const size_t base = size_t(b) * T * rs + size_t(h) * kD;
  float* lrow = lse + (size_t(b) * H + h) * T;
  const int L = min(max(lengths[b], 0), T);
  const int i1 = min(T, i0 + kTile);
  count_run(runs, kRunForward, w >= 0);
  if (i0 >= L) {  // a tile of padding
    zero_rows(o, base, rs, i0, i1, tid, kThreads);
    for (int r = i0 + tid; r < i1; r += kThreads) lrow[r] = 0.f;
    return;
  }
  const int2 kr = reach(i0, min(L, i1), L, w);
  const int nch = (kr.y - kr.x + kChunk - 1) / kChunk;
  const int r0 = i0 + (warp >> 2) * kWgRows;      // this warpgroup's first row
  const int rw = r0 + (warp & 3) * 16;            // this warp's
  const bool live = r0 < L;                       // the same for the whole warpgroup

  auto fetch = [&](int c) {
    const int st = c % kStages, key0 = kr.x + c * kChunk;
    copy_rows_sw(Ks + st * kSwChunk, k, base, rs, key0, kChunk, T, tid);
    copy_rows_sw(Vs + st * kSwChunk, v, base, rs, key0, kChunk, T, tid);
    cp_commit();
  };
  copy_rows_sw(Qs, q, base, rs, i0, kTile, T, tid);  // rides in chunk 0's group
  for (int c = 0; c < min(nch, kStages); ++c) fetch(c);

  const uint32_t qaddr = smem_u32(Qs + (r0 - i0) * 128);  // this warpgroup's Q rows
  float acc[8][4];
  zero_acc(acc);
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    cp_wait_dyn(min(nch - 1 - ch, kStages - 1 - (ch > 0)));
    fence_proxy_async();  // this thread's landed copies, visible to wgmma's reads
    __syncthreads();      // chunk ch landed for all; chunk ch - 1's products are done
    if (ch > 0 && ch - 1 + kStages < nch) fetch(ch - 1 + kStages);  // where ch - 1 was
    if (!live) continue;
    const int c0 = kr.x + ch * kChunk;
    if (!reaches(r0, kWgRows, c0, w)) continue;
    const uint32_t kaddr = smem_u32(Ks + (ch % kStages) * kSwChunk);
    const uint32_t vaddr = smem_u32(Vs + (ch % kStages) * kSwChunk);

    float s[8][4];
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < kD / 16; ++kk)
      wgmma_ss(s, sw128_desc(qaddr + kk * 32), sw128_desc(kaddr + kk * 32), kk > 0);
    wg_commit();
    wg_wait0();
    pin(s);
    // the chunk's max over the raw scores (masked ones -inf), then the
    // running max in the log2 domain; p = 2^(s log2(e) / sqrt(D) - max)
    // in one fused multiply-add a score
    const bool mask = partial(r0, kWgRows, c0, L, w);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (mask && !kept(rw + g + (j >> 1) * 8, c0 + nt * 8 + 2 * t + (j & 1), L, w))
          s[nt][j] = -INFINITY;
        if (j < 2) mx0 = fmaxf(mx0, s[nt][j]);
        else mx1 = fmaxf(mx1, s[nt][j]);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    mx0 = fmaxf(m0, mx0 * scale_log2);
    mx1 = fmaxf(m1, mx1 * scale_log2);
    // a row none of whose keys so far is kept keeps max -inf: its
    // probabilities are 2^(-inf - 0) = 0
    const float mu0 = mx0 == -INFINITY ? 0.f : mx0, mu1 = mx1 == -INFINITY ? 0.f : mx1;
    const float a0 = ex2(m0 - mu0), a1 = ex2(m1 - mu1);
    m0 = mx0;
    m1 = mx1;
    l0 *= a0;
    l1 *= a1;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      acc[j][0] *= a0;
      acc[j][1] *= a0;
      acc[j][2] *= a1;
      acc[j][3] *= a1;
    }
    uint32_t pf[4][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = ex2(fmaf(s[nt][0], scale_log2, -mu0));
      s[nt][1] = ex2(fmaf(s[nt][1], scale_log2, -mu0));
      s[nt][2] = ex2(fmaf(s[nt][2], scale_log2, -mu1));
      s[nt][3] = ex2(fmaf(s[nt][3], scale_log2, -mu1));
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      pf[kj][0] = pack_bf16(s[2 * kj][0], s[2 * kj][1]);
      pf[kj][1] = pack_bf16(s[2 * kj][2], s[2 * kj][3]);
      pf[kj][2] = pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]);
      pf[kj][3] = pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3]);
    }
    pin(acc);
    pin(pf);
    wg_fence();
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) wgmma_rs(acc, pf[kj], sw128_desc(vaddr + kj * 2048));
    wg_commit();
    wg_wait0();
    pin(acc);
    pin(pf);  // read until the wait: no other value may take its registers before it
  }
  if (!live) {
    zero_rows(o, base, rs, rw, min(T, rw + 16), lane, 32);
    for (int r = rw + lane; r < min(T, rw + 16); r += 32) lrow[r] = 0.f;
    return;
  }
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  store_rows(o, base, rs, rw, L, T, acc, 1.f / l0, 1.f / l1, lane);
  if (t == 0) {
    const int ra = rw + g, rb = ra + 8;
    if (ra < T) lrow[ra] = ra < L ? m0 + log2f(l0) : 0.f;
    if (rb < T) lrow[rb] = rb < L ? m1 + log2f(l1) : 0.f;
  }
}

// ---------------------------------------------------------------- dQ
// One block a (b, h, 128-query tile): delta of its rows, then dQ over the
// key chunks its rows reach.
__global__ void __launch_bounds__(kThreads, 1)
ragged_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, const bf16* __restrict__ o,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const int* __restrict__ lengths, bf16* __restrict__ dq,
                 float* __restrict__ delta, int T, int H, int w, float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + kTile * kLD;
  bf16* Ks = dOs + kTile * kLD;                 // [kStages][kChunk][kLD]
  bf16* Vs = Ks + kStages * kChunk * kLD;
  float* Ds = reinterpret_cast<float*>(Vs + kStages * kChunk * kLD);  // [kTile]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, i0 = blockIdx.x * kTile;
  const size_t rs = size_t(H) * kD;
  const size_t base = size_t(b) * T * rs + size_t(h) * kD;
  const float* lrow = lse + (size_t(b) * H + h) * T;
  float* drow = delta + (size_t(b) * H + h) * T;
  const int L = min(max(lengths[b], 0), T);
  const int i1 = min(T, i0 + kTile);
  if (i0 >= L) {
    zero_rows(dq, base, rs, i0, i1, tid, kThreads);
    for (int r = i0 + tid; r < i1; r += kThreads) drow[r] = 0.f;
    return;
  }
  const int2 kr = reach(i0, min(L, i1), L, w);
  const int nch = (kr.y - kr.x + kChunk - 1) / kChunk;
  const int r0 = i0 + warp * 16;
  const bool live = r0 < L;

  auto fetch = [&](int c) {
    const int st = c % kStages, key0 = kr.x + c * kChunk;
    copy_rows(Ks + st * kChunk * kLD, k, base, rs, key0, kChunk, T, tid);
    copy_rows(Vs + st * kChunk * kLD, v, base, rs, key0, kChunk, T, tid);
    cp_commit();
  };
  copy_rows(Qs, q, base, rs, i0, kTile, T, tid);
  copy_rows(dOs, dout, base, rs, i0, kTile, T, tid);
  for (int c = 0; c < min(nch, kStages); ++c) fetch(c);

  {  // delta_i = dO_i . O_i in f32, two threads a row; 0 past L
    const int r = tid >> 1, half = tid & 1, row = i0 + r;
    float d = 0.f;
    if (row < L) {
      const uint4* op = reinterpret_cast<const uint4*>(o + base + size_t(row) * rs + half * 32);
      const uint4* gp = reinterpret_cast<const uint4*>(dout + base + size_t(row) * rs + half * 32);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const uint4 a = op[i], c = gp[i];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* c2 = reinterpret_cast<const __nv_bfloat162*>(&c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]), y = __bfloat1622float2(c2[e]);
          d = fmaf(x.x, y.x, d);
          d = fmaf(x.y, y.y, d);
        }
      }
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    if (half == 0) {
      Ds[r] = d;
      if (row < T) drow[row] = d;
    }
  }

  uint32_t qf[4][4], of[4][4];
  float acc[8][4];
  zero_acc(acc);
  const int ra = r0 + g, rb = ra + 8;
  const float la = ra < L ? lrow[ra] : 0.f, lb = rb < L ? lrow[rb] : 0.f;
  float da = 0.f, db = 0.f;

  for (int ch = 0; ch < nch; ++ch) {
    cp_wait_dyn(min(nch - 1 - ch, kStages - 1 - (ch > 0)));
    __syncthreads();  // chunk ch (and, at 0, the tiles and delta) landed for all
    if (ch > 0 && ch - 1 + kStages < nch) fetch(ch - 1 + kStages);
    if (!live) continue;
    if (ch == 0) {
      load_a(qf, Qs + warp * 16 * kLD, lane);
      load_a(of, dOs + warp * 16 * kLD, lane);
      da = Ds[warp * 16 + g];
      db = Ds[warp * 16 + g + 8];
    }
    const int c0 = kr.x + ch * kChunk;
    if (!reaches(r0, 16, c0, w)) continue;
    const bf16* Kc = Ks + (ch % kStages) * kChunk * kLD;
    const bf16* Vc = Vs + (ch % kStages) * kChunk * kLD;

    float s[8][4], dp[8][4];
    product_nt(s, qf, Kc, lane);
    product_nt(dp, of, Vc, lane);
    const bool mask = partial(r0, 16, c0, L, w);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = ex2(fmaf(s[nt][j], scale_log2, -(j < 2 ? la : lb)));
        if (mask && !kept(r0 + g + (j >> 1) * 8, c0 + nt * 8 + 2 * t + (j & 1), L, w)) p = 0.f;
        s[nt][j] = p * (dp[nt][j] - (j < 2 ? da : db));  // dS
      }
    }
    product_nn(acc, s, Kc, lane);
  }
  if (!live) {
    zero_rows(dq, base, rs, r0, min(T, r0 + 16), lane, 32);
    return;
  }
  store_rows(dq, base, rs, r0, L, T, acc, scale, scale, lane);
}

// ---------------------------------------------------------------- dK, dV
// One block a (b, h, 128-key tile): dK and dV over the query chunks that
// reach its keys.
__global__ void __launch_bounds__(kThreads, 1)
ragged_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, const bf16* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  const int* __restrict__ lengths, bf16* __restrict__ dk, bf16* __restrict__ dv,
                  int T, int H, int w, float scale_log2, float scale,
                  unsigned long long* runs) {
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Kt = reinterpret_cast<bf16*>(smem);
  bf16* Vt = Kt + kTile * kLD;
  bf16* Qc = Vt + kTile * kLD;                  // [kStages][kChunk][kLD]
  bf16* Oc = Qc + kStages * kChunk * kLD;       // dO chunks
  float* Lc = reinterpret_cast<float*>(Oc + kStages * kChunk * kLD);  // [kStages][kChunk]
  float* Dc = Lc + kStages * kChunk;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, j0 = blockIdx.x * kTile;
  const size_t rs = size_t(H) * kD;
  const size_t base = size_t(b) * T * rs + size_t(h) * kD;
  const float* lrow = lse + (size_t(b) * H + h) * T;
  const float* drow = delta + (size_t(b) * H + h) * T;
  const int L = min(max(lengths[b], 0), T);
  const int j1 = min(T, j0 + kTile);
  count_run(runs, kRunBackward, false);
  if (j0 >= L) {
    zero_rows(dk, base, rs, j0, j1, tid, kThreads);
    zero_rows(dv, base, rs, j0, j1, tid, kThreads);
    return;
  }
  const int2 qr = reach(j0, min(L, j1), L, w);
  const int nch = (qr.y - qr.x + kChunk - 1) / kChunk;
  const int r0 = j0 + warp * 16;  // this warp's keys
  const bool live = r0 < L;

  auto fetch = [&](int c) {
    const int st = c % kStages, q0 = qr.x + c * kChunk;
    copy_rows(Qc + st * kChunk * kLD, q, base, rs, q0, kChunk, T, tid);
    copy_rows(Oc + st * kChunk * kLD, dout, base, rs, q0, kChunk, T, tid);
    if (tid < 2 * kChunk) {
      const int i = tid % kChunk, row = q0 + i;
      const bool ok = row < T;
      const float* src = (tid < kChunk ? lrow : drow) + (ok ? row : 0);
      cp_async4((tid < kChunk ? Lc : Dc) + st * kChunk + i, src, ok);
    }
    cp_commit();
  };
  copy_rows(Kt, k, base, rs, j0, kTile, T, tid);
  copy_rows(Vt, v, base, rs, j0, kTile, T, tid);
  for (int c = 0; c < min(nch, kStages); ++c) fetch(c);

  uint32_t kf[4][4], vf[4][4];
  float dK[8][4], dV[8][4];
  zero_acc(dK);
  zero_acc(dV);

  for (int ch = 0; ch < nch; ++ch) {
    cp_wait_dyn(min(nch - 1 - ch, kStages - 1 - (ch > 0)));
    __syncthreads();
    if (ch > 0 && ch - 1 + kStages < nch) fetch(ch - 1 + kStages);
    if (!live) continue;
    if (ch == 0) {
      load_a(kf, Kt + warp * 16 * kLD, lane);
      load_a(vf, Vt + warp * 16 * kLD, lane);
    }
    const int c0 = qr.x + ch * kChunk;
    if (!reaches(r0, 16, c0, w)) continue;
    const int st = ch % kStages;
    const bf16* Qs = Qc + st * kChunk * kLD;
    const bf16* Os = Oc + st * kChunk * kLD;
    const float* ls = Lc + st * kChunk;
    const float* ds = Dc + st * kChunk;

    // P^T: this warp's 16 keys (rows) against the chunk's 64 queries
    float s[8][4];
    product_nt(s, kf, Qs, lane);
    const bool mask = partial(r0, 16, c0, L, w);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 l2 = *reinterpret_cast<const float2*>(ls + nt * 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = ex2(fmaf(s[nt][j], scale_log2, -((j & 1) ? l2.y : l2.x)));
        if (mask && !kept(r0 + g + (j >> 1) * 8, c0 + nt * 8 + 2 * t + (j & 1), L, w)) p = 0.f;
        s[nt][j] = p;
      }
    }
    product_nn(dV, s, Os, lane);
    // dP^T = V . dO^T, then dS^T = P^T (dP^T - delta)
    float dp[8][4];
    product_nt(dp, vf, Os, lane);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const float2 d2 = *reinterpret_cast<const float2*>(ds + nt * 8 + 2 * t);
#pragma unroll
      for (int j = 0; j < 4; ++j) s[nt][j] *= dp[nt][j] - ((j & 1) ? d2.y : d2.x);
    }
    product_nn(dK, s, Qs, lane);
  }
  if (!live) {
    zero_rows(dk, base, rs, r0, min(T, r0 + 16), lane, 32);
    zero_rows(dv, base, rs, r0, min(T, r0 + 16), lane, 32);
    return;
  }
  store_rows(dk, base, rs, r0, L, T, dK, scale, scale, lane);
  store_rows(dv, base, rs, r0, L, T, dV, 1.f, 1.f, lane);
}

}  // namespace

// Lets each kernel take its shared memory (above 48 KB only by this
// attribute); once, before the first launch and outside any capture.
extern "C" int tr_ragged_init() {
  cudaError_t e = cudaFuncSetAttribute(ragged_fwd_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, kFwdSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ragged_dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDqSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(ragged_dkv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kDkvSmem);
  return int(e);
}

// q, k, v, o (B, T, H, 64) bf16 contiguous, 16-byte aligned; lengths (B)
// int32; lse (B, H, T) f32; w < 0 for every key; runs: 3 counters or null.
extern "C" int tr_ragged_fwd(const void* q, const void* k, const void* v, const void* lengths,
                             void* o, void* lse, int B, int T, int H, int w, void* runs,
                             void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return int(cudaErrorInvalidValue);
  dim3 grid((T + kTile - 1) / kTile, H, B);
  ragged_fwd_kernel<<<grid, kThreads, kFwdSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const int*>(lengths), static_cast<bf16*>(o), static_cast<float*>(lse), T, H, w,
      kLog2e / sqrtf(float(kD)), static_cast<unsigned long long*>(runs));
  return int(cudaGetLastError());
}

// The gradients of tr_ragged_fwd: dout (the output's gradient), o and lse
// as the forward wrote them; dq, dk, dv like q; delta (B, H, T) f32 scratch.
extern "C" int tr_ragged_bwd(const void* q, const void* k, const void* v, const void* o,
                             const void* dout, const void* lse, const void* lengths, void* dq,
                             void* dk, void* dv, void* delta, int B, int T, int H, int w,
                             void* runs, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  dim3 grid((T + kTile - 1) / kTile, H, B);
  const float scale_log2 = kLog2e / sqrtf(float(kD)), scale = 1.f / sqrtf(float(kD));
  ragged_dq_kernel<<<grid, kThreads, kDqSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(o), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const int*>(lengths), static_cast<bf16*>(dq),
      static_cast<float*>(delta), T, H, w, scale_log2, scale);
  if (cudaError_t e = cudaGetLastError()) return int(e);
  ragged_dkv_kernel<<<grid, kThreads, kDkvSmem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<const int*>(lengths), static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), T, H, w, scale_log2, scale, static_cast<unsigned long long*>(runs));
  return int(cudaGetLastError());
}
