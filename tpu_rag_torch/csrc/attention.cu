// Fused multi-head self-attention for the encoder forward.
//
// Replaces the Pallas kernel #5 of tpu_rag/ops/attention.py (_mha_kernel):
// per (batch, head), softmax(Q . K^T / sqrt(D), keys whose mask is 0 set to
// -1e30) . V, row max and row sum in f32, output in the input dtype.  Only
// the key side is masked; q/k/v and the output are (B, T, H, D).  The -1e30
// fill (not -inf) keeps the TPU kernel's answer for an all-pad row: every
// score equals -1e30, so the output is the plain average of V.
//
// What bounds it on the H100: at MiniLM's shape (B 64, T 256, H 12, D 32)
// the work is 4 B H T^2 D = 6.4 GFLOP (6.5 us at 989 TFLOP/s) against 50 MB
// of q/k/v/o (15 us at 3.35 TB/s), so bytes bound the ideal kernel, and
// with so little work per head the design is about latency: few
// instructions per score, no round trip of a score through memory.
//
// bf16 (the encoder's dtype on the card), D in {32, 64}, T <= 512:
//   - one block of 8 warps per (b, h, 128-query tile), each warp owning 16
//     query rows; K and V stream through a ring of 64-key chunks, copied
//     by 16-byte cp.async (one commit group a chunk; the query tile rides
//     in the first group; one barrier a chunk).  The ring holds T's chunks
//     up to as many as leave room for two blocks an SM (tc_stages): at D 32
//     all of T <= 512, every copy in flight from the start; at D 64 five
//     (113 KB), each refilled above T 320 once its chunk's products are
//     done (mha_tc_kernel<64, true>; holding T 512's whole K and V, 168 KB,
//     would leave one block an SM, its copies and products in turn);
//   - at a ragged T (B 256, T 160: a second tile of 32 real rows), a warp
//     whose 16 rows all lie past T only feeds the ring (a branch around
//     the whole chunk; one inside its unrolled products, to skip the key
//     tiles past T, cost more than it saved);
//   - S = Q . K^T on the tensor cores (mma.sync m16n8k16, operands by
//     ldmatrix; rows padded by 16 bytes so the eight rows of a matrix fall
//     in distinct banks);
//   - an online softmax over each chunk of 64 keys in registers: the scale
//     times log2(e) is folded into the scores so each probability is one
//     exp2f, -1e30 for masked keys and -inf for the keys past T;
//   - P goes to bf16 in registers and is the A operand of P . V directly
//     (the accumulator layout of two 8-key tiles is the A layout of one
//     16-key step); V comes through ldmatrix.trans; O accumulates in f32 and
//     is divided by the row sum once at the end.  P is cast before it is
//     normalised, where the TPU kernel normalises first: the two differ by
//     bf16 rounding of the probabilities.
// f32 (prove_checkpoint's encoder; the reference computes in f32, so no
// TF32): Q.K^T and P.V on the CUDA cores with f32 rounding.  The work is
// 4 B H T^2 D FLOPs against ~4 B T H D x 4 bytes, so the FMA pipes (67
// TFLOP/s), not the bytes, bound it.  mha_f32_kernel<D>:
//   - one block of 256 threads per (b, h, 128-query tile): at T <= 128 one
//     tile a head; the tile's Q rows stay in shared memory;
//   - K and V stream through a ring of three 64-key chunks, copied by
//     16-byte cp.async two chunks ahead of the math, so the copy of the
//     next chunks overlaps this one's products (two barriers a chunk);
//   - S = Q.K^T in register micro-tiles: thread (ty, tx) = (tid / 8,
//     tid % 8) owns rows 4 ty .. 4 ty + 3 and keys tx + 8 j (j < 8); Q and
//     K rows are read as float4 along d from rows padded by 16 bytes, so
//     the eight lanes of a quarter warp read one Q row (a broadcast) and
//     eight consecutive K rows (eight distinct 16-byte bank groups): each
//     float4 feeds 4-8 FMAs;
//   - an online softmax in the log2 domain: each row's 64 scores of a chunk
//     lie on the 8 lanes of one quarter warp, whose max and sum are reduced
//     by three xor shuffles; -1e30 for masked keys, -inf past T;
//   - P goes to a small transposed staging tile (P^T[key][row], rows
//     padded by 16 bytes) and O += P.V in the same micro-tiling: rows 4 ty
//     .. 4 ty + 3 by columns 4 tx + 32 c, a float4 of P^T and D / 32
//     float4s of V a key; keys past T are cut by the chunk's bound.  O is
//     divided by the row sum once at the end.  No T cap: K and V stream.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma_sm90.cuh"

using namespace tr_layout::mha;
using namespace tr_mma;

namespace {

constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16
// (its layout: layout.h's tc_stages and tc_smem_bytes)

// kRing: T's chunks outnumber the ring's stages (D 64 above T 320), so a
// stage is refilled once its chunk's products are done; else every chunk
// has a stage of its own and every copy is issued up front (no refill code
// in the loop: it cost registers and time where it never ran).  D 64 is
// held to 128 registers, two blocks an SM (left free, it took 146: one).
template <int D, bool kRing>
__global__ void __launch_bounds__(kWarps * 32, D == 64 ? 2 : 1)
mha_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
              __nv_bfloat16* __restrict__ o, int T_, int H, float scale_log2) {
  constexpr int LD = row_ld(D);
  constexpr int kPieces = D / 8;  // 16-byte pieces of a head row
  constexpr int kDT = D / 8;      // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int stages = tc_stages(D, T_);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kQTile * LD;                 // [stages][kChunk][LD]
  __nv_bfloat16* Vs = Ks + stages * kChunk * LD;
  int* keep = reinterpret_cast<int*>(Vs + stages * kChunk * LD);  // [T]: 1 real, 0 masked, -1 past T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const size_t rs = size_t(H) * D;  // between consecutive tokens
  const size_t base = size_t(b) * T_ * rs + size_t(h) * D;
  const int nchunks = (T_ + kChunk - 1) / kChunk;
  // a warp whose 16 query rows all lie past T only feeds the ring
  const bool live = q0 + warp * 16 < T_;

  // chunk c -> ring stage c % stages: its K and V (zero past T)
  auto fetch = [&](int c) {
    const int st = c % stages;
    for (int i = tid; i < kChunk * kPieces; i += kWarps * 32) {
      const int r = i / kPieces, cc = (i % kPieces) * 8, key = c * kChunk + r;
      const bool ok = key < T_;
      const size_t off = base + size_t(ok ? key : 0) * rs + cc;
      cp_async16(Ks + (st * kChunk + r) * LD + cc, k + off, ok);
      cp_async16(Vs + (st * kChunk + r) * LD + cc, v + off, ok);
    }
    cp_commit();
  };

  for (int i = tid; i < kQTile * kPieces; i += kWarps * 32) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool ok = q0 + r < T_;
    cp_async16(Qs + r * LD + c, q + base + size_t(ok ? q0 + r : 0) * rs + c, ok);
  }
  for (int c = 0; c < stages; ++c) fetch(c);  // the Q tile rides in chunk 0's group
  // every key's flag, once, while the copies fly (read inside fetch, a
  // flag would stall its warp on the mask load before the warp's next
  // copies)
  for (int i = tid; i < nchunks * kChunk; i += kWarps * 32)
    keep[i] = i < T_ ? (mask[size_t(b) * T_ + i] > 0 ? 1 : 0) : -1;

  uint32_t qf[D / 16][4];
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int ch = 0; ch < nchunks; ++ch) {
    // the chunks issued after ch may stay in flight: all of T's where the
    // ring holds T whole (every copy was issued up front)
    cp_wait_dyn(kRing ? min(nchunks - 1 - ch, stages - 1 - (ch > 0)) : nchunks - 1 - ch);
    __syncthreads();  // chunk ch landed for all; chunk ch - 1's products are done
    if constexpr (kRing) {
      if (ch > 0 && ch - 1 + stages < nchunks) fetch(ch - 1 + stages);  // where ch - 1 was
    }
    if (!live) continue;
    const int st = kRing ? ch % stages : ch;
    const __nv_bfloat16* Kc = Ks + st * kChunk * LD;
    const __nv_bfloat16* Vc = Vs + st * kChunk * LD;
    const int* fl = keep + ch * kChunk;
    if (ch == 0) {  // the Q tile landed with chunk 0
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    // ---- S = Q . K^T for 64 keys: 8 tiles of 8 keys (straight-line: a
    // branch per tile would keep the compiler from interleaving the tiles'
    // loads and products)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Kc + (nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
#pragma unroll
      for (int kp = 0; kp < D / 32; ++kp) {
        uint32_t r[4];
        ldsm_x4(r, kr + kp * 32);
        mma_bf16(s[nt], qf[2 * kp], r[0], r[1]);
        mma_bf16(s[nt], qf[2 * kp + 1], r[2], r[3]);
      }
    }
    // ---- online softmax in the log2 domain
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int2 f2 = *reinterpret_cast<const int2*>(fl + nt * 8 + 2 * t);  // keys 2t, 2t + 1
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = (j & 1) ? f2.y : f2.x;
        const float x = f > 0 ? s[nt][j] * scale_log2 : (f == 0 ? kMaskValue : -INFINITY);
        s[nt][j] = x;
        if (j < 2) mx0 = fmaxf(mx0, x);
        else mx1 = fmaxf(mx1, x);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float c0 = exp2f(m0 - mx0), c1 = exp2f(m1 - mx1);  // 0 on the first chunk
    m0 = mx0;
    m1 = mx1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int j = 0; j < kDT; ++j) {
      acc[j][0] *= c0;
      acc[j][1] *= c0;
      acc[j][2] *= c1;
      acc[j][3] *= c1;
    }
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - m0);
      s[nt][1] = exp2f(s[nt][1] - m0);
      s[nt][2] = exp2f(s[nt][2] - m1);
      s[nt][3] = exp2f(s[nt][3] - m1);
      l0 += s[nt][0] + s[nt][1];
      l1 += s[nt][2] + s[nt][3];
    }
    // ---- O += P . V, 16 keys a step
#pragma unroll
    for (int kj = 0; kj < 4; ++kj) {
      const uint32_t a[4] = {pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                             pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                             pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                             pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
      const __nv_bfloat16* vr =
          Vc + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t r[4];
        ldsm_x4_trans(r, vr + dn * 16);
        mma_bf16(acc[2 * dn], a, r[0], r[1]);
        mma_bf16(acc[2 * dn + 1], a, r[2], r[3]);
      }
    }
  }
  if (!live) return;
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < kDT; ++j) {
    const int c = j * 8 + 2 * t;
    if (r0 < T_)
      *reinterpret_cast<__nv_bfloat162*>(o + base + size_t(r0) * rs + c) =
          __floats2bfloat162_rn(acc[j][0] * inv0, acc[j][1] * inv0);
    if (r1 < T_)
      *reinterpret_cast<__nv_bfloat162*>(o + base + size_t(r1) * rs + c) =
          __floats2bfloat162_rn(acc[j][2] * inv1, acc[j][3] * inv1);
  }
}

template <int D, bool kRing>
int launch_tc_kernel(const void* q, const void* k, const void* v, const void* mask, void* o,
                     int B, int T_, int H, cudaStream_t stream) {
  static const cudaError_t set =  // once, for the largest T: above 48 KB only by this attribute
      cudaFuncSetAttribute(mha_tc_kernel<D, kRing>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           int(tc_smem_bytes(D, kTMax)));
  if (set != cudaSuccess) return int(set);
  dim3 grid((T_ + kQTile - 1) / kQTile, H, B);
  mha_tc_kernel<D, kRing><<<grid, kWarps * 32, tc_smem_bytes(D, T_), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(o), T_, H, kLog2e / sqrtf(float(D)));
  return int(cudaGetLastError());
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
              int T_, int H, cudaStream_t stream) {
  if (T_ > kTMax) return int(cudaErrorInvalidValue);
  if constexpr (tc_stages(D, kTMax) < kTMax / kChunk) {
    if ((T_ + kChunk - 1) / kChunk > tc_stages(D, T_))
      return launch_tc_kernel<D, true>(q, k, v, mask, o, B, T_, H, stream);
  }
  return launch_tc_kernel<D, false>(q, k, v, mask, o, B, T_, H, stream);
}

// ---------------------------------------------------------------- f32
// (its layout: layout.h's f32_smem)
constexpr int kF32Threads = 256;

template <int D>
__global__ void __launch_bounds__(kF32Threads)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ mask,
               float* __restrict__ o, int T_, int H, float scale_log2) {
  constexpr int kPieces = D / 4;  // 16-byte pieces of a head row
  constexpr int kCols = D / 32;   // float4 columns of O a thread owns
  extern __shared__ __align__(16) float fsm[];
  const F32Smem lay = f32_smem(D);
  const int LD = lay.ld, LP = lay.lp;
  float* Qs = fsm + lay.q;
  float* Ps = fsm + lay.p;
  int* flags = reinterpret_cast<int*>(fsm + lay.flags);  // 1 real, 0 masked, -1 past T

  const int tid = threadIdx.x, tx = tid & 7, ty = tid >> 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kF32Rows;
  const size_t rs = size_t(H) * D;  // between consecutive tokens
  const size_t base = size_t(b) * T_ * rs + size_t(h) * D;
  const int nchunks = (T_ + kF32Keys - 1) / kF32Keys;

  // chunk c -> ring stage c % 3: K, V (zero past T) and the key flags
  auto fetch = [&](int c) {
    const int st = c % kF32Stages;
    float* Ks = fsm + lay.k + st * kF32Keys * LD;
    float* Vs = fsm + lay.v + st * kF32Keys * LD;
    for (int i = tid; i < kF32Keys * kPieces; i += kF32Threads) {
      const int r = i / kPieces, cc = (i % kPieces) * 4, key = c * kF32Keys + r;
      const bool ok = key < T_;
      const size_t off = base + size_t(ok ? key : 0) * rs + cc;
      cp_async16(Ks + r * LD + cc, k + off, ok);
      cp_async16(Vs + r * LD + cc, v + off, ok);
    }
    if (tid < kF32Keys) {
      const int key = c * kF32Keys + tid;
      flags[st * kF32Keys + tid] = key < T_ ? (mask[size_t(b) * T_ + key] > 0 ? 1 : 0) : -1;
    }
    cp_commit();
  };

  for (int i = tid; i < kF32Rows * kPieces; i += kF32Threads) {
    const int r = i / kPieces, cc = (i % kPieces) * 4;
    const bool ok = q0 + r < T_;
    cp_async16(Qs + r * LD + cc, q + base + size_t(ok ? q0 + r : 0) * rs + cc, ok);
  }
  fetch(0);  // the Q tile rides in chunk 0's group
  if (nchunks > 1) fetch(1);

  float acc[4][kCols][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  const float* qrow = Qs + (4 * ty) * LD;

  for (int c = 0; c < nchunks; ++c) {
    if (c + 1 < nchunks) cp_wait<1>();  // chunk c + 1 may stay in flight
    else cp_wait<0>();
    __syncthreads();  // chunk c landed for all; P.V of chunk c - 1 is done
    if (c + 2 < nchunks) fetch(c + 2);  // into the stage chunk c - 1 held
    const int st = c % kF32Stages;
    const float* Ks = fsm + lay.k + st * kF32Keys * LD;
    const float* Vs = fsm + lay.v + st * kF32Keys * LD;
    const int* fl = flags + st * kF32Keys;

    // ---- S = Q . K^T: rows 4 ty + i, keys tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    const float* krow = Ks + tx * LD;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qrow + i * LD + d);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 kv = *reinterpret_cast<const float4*>(krow + j * 8 * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(a[i].x, kv.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, kv.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, kv.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, kv.w, s[i][j]);
        }
      }
    }

    // ---- online softmax in the log2 domain over the row's 8 lanes
    float mx[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) mx[i] = m[i];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int f = fl[tx + 8 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float x = f > 0 ? s[i][j] * scale_log2 : (f == 0 ? kMaskValue : -INFINITY);
        s[i][j] = x;
        mx[i] = fmaxf(mx[i], x);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int off = 1; off <= 4; off <<= 1)
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], off));
      const float corr = exp2f(m[i] - mx[i]);  // 0 on the first chunk
      m[i] = mx[i];
      l[i] *= corr;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        acc[i][cc][0] *= corr;
        acc[i][cc][1] *= corr;
        acc[i][cc][2] *= corr;
        acc[i][cc][3] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = exp2f(s[i][j] - m[i]);
        l[i] += p[i];
      }
      *reinterpret_cast<float4*>(Ps + (tx + 8 * j) * LP + 4 * ty) =
          make_float4(p[0], p[1], p[2], p[3]);
    }
    __syncthreads();  // P^T complete

    // ---- O += P . V: rows 4 ty + i, columns 4 tx + 32 cc, the chunk's keys
    const int nk = min(kF32Keys, T_ - c * kF32Keys);
    const float* prow = Ps + 4 * ty;
    const float* vcol = Vs + 4 * tx;
#pragma unroll 4
    for (int j = 0; j < nk; ++j) {
      const float4 pv = *reinterpret_cast<const float4*>(prow + j * LP);
      const float pa[4] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float4 vv = *reinterpret_cast<const float4*>(vcol + j * LD + 32 * cc);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][cc][0] = fmaf(pa[i], vv.x, acc[i][cc][0]);
          acc[i][cc][1] = fmaf(pa[i], vv.y, acc[i][cc][1]);
          acc[i][cc][2] = fmaf(pa[i], vv.z, acc[i][cc][2]);
          acc[i][cc][3] = fmaf(pa[i], vv.w, acc[i][cc][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off <= 4; off <<= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int r = q0 + 4 * ty + i;
    if (r >= T_) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc)
      *reinterpret_cast<float4*>(o + base + size_t(r) * rs + 4 * tx + 32 * cc) =
          make_float4(acc[i][cc][0] * inv, acc[i][cc][1] * inv, acc[i][cc][2] * inv,
                      acc[i][cc][3] * inv);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
               int T_, int H, cudaStream_t stream) {
  const int smem = f32_smem(D).total * 4;
  if (int e = int(cudaFuncSetAttribute(mha_f32_kernel<D>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem)))
    return e;
  dim3 grid((T_ + kF32Rows - 1) / kF32Rows, H, B);
  mha_f32_kernel<D><<<grid, kF32Threads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(mask), static_cast<float*>(o), T_, H, kLog2e / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

// q/k/v/o (B, T, H, D) contiguous and 16-byte aligned, dtype f32 or bf16;
// mask (B, T) int32.  bf16 takes T <= 512; f32 any T.
extern "C" int tr_mha(const void* q, const void* k, const void* v,
                      const void* mask, void* o, int B, int T_, int H, int D,
                      int dtype, void* stream) {
  if (B <= 0 || T_ <= 0 || H <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == TR_BF16 && D == 32) return launch_tc<32>(q, k, v, mask, o, B, T_, H, s);
  if (dtype == TR_BF16 && D == 64) return launch_tc<64>(q, k, v, mask, o, B, T_, H, s);
  if (dtype == TR_F32 && D == 32) return launch_f32<32>(q, k, v, mask, o, B, T_, H, s);
  if (dtype == TR_F32 && D == 64) return launch_f32<64>(q, k, v, mask, o, B, T_, H, s);
  return int(cudaErrorInvalidValue);
}
