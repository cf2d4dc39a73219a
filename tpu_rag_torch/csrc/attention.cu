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
//     query rows (rather than 4 warps and 64 rows: each head's K and V are
//     fetched half as often, which T 512 needs); the head's whole K and V
//     (at most 64 KB each) sit in shared memory, fetched with 16-byte
//     cp.async in chunks of 64 keys, one
//     commit group per chunk, so the first chunk's math starts while the
//     rest is in flight (the query tile rides in the first group);
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
// f32 inputs (never on the card's encoder path) keep the first version:
// one thread per query row, K/V chunks of 32 in shared memory, CUDA-core
// FMAs, no TF32.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"
#include "mma_sm90.cuh"

using namespace tr_mma;

namespace {

constexpr float kMaskValue = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---------------------------------------------------------------- bf16
constexpr int kWarps = 8;
constexpr int kQTile = 16 * kWarps;  // query rows per block
constexpr int kChunk = 64;           // keys per softmax step
constexpr int kTMax = 512;

__host__ __device__ constexpr int row_ld(int D) { return D + 8; }  // + 16 bytes
__host__ __device__ inline size_t tc_smem_bytes(int D, int T) {
  const int tp = (T + kChunk - 1) / kChunk * kChunk;
  return size_t(kQTile + 2 * tp) * row_ld(D) * 2 + size_t(tp) * 4;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
mha_tc_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
              const __nv_bfloat16* __restrict__ v, const int* __restrict__ mask,
              __nv_bfloat16* __restrict__ o, int T_, int H, float scale_log2) {
  constexpr int LD = row_ld(D);
  constexpr int kPieces = D / 8;  // 16-byte pieces of a head row
  constexpr int kDT = D / 8;      // 8-column tiles of the output
  extern __shared__ __align__(16) unsigned char smem[];
  const int tp = (T_ + kChunk - 1) / kChunk * kChunk;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + kQTile * LD;
  __nv_bfloat16* Vs = Ks + tp * LD;
  int* keep = reinterpret_cast<int*>(Vs + tp * LD);  // 1 real, 0 masked, -1 past T

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.z, h = blockIdx.y, q0 = blockIdx.x * kQTile;
  const size_t rs = size_t(H) * D;  // between consecutive tokens
  const size_t base = size_t(b) * T_ * rs + size_t(h) * D;
  const int nchunks = tp / kChunk;

  for (int i = tid; i < kQTile * kPieces; i += kWarps * 32) {
    const int r = i / kPieces, c = (i % kPieces) * 8;
    const bool ok = q0 + r < T_;
    cp_async16(Qs + r * LD + c, q + base + size_t(ok ? q0 + r : 0) * rs + c, ok);
  }
  for (int ch = 0; ch < nchunks; ++ch) {
    for (int i = tid; i < kChunk * kPieces; i += kWarps * 32) {
      const int r = ch * kChunk + i / kPieces, c = (i % kPieces) * 8;
      const bool ok = r < T_;
      const size_t off = base + size_t(ok ? r : 0) * rs + c;
      cp_async16(Ks + r * LD + c, k + off, ok);
      cp_async16(Vs + r * LD + c, v + off, ok);
    }
    cp_commit();
  }
  for (int i = tid; i < tp; i += kWarps * 32)
    keep[i] = i < T_ ? (mask[size_t(b) * T_ + i] > 0 ? 1 : 0) : -1;

  uint32_t qf[D / 16][4];
  float acc[kDT][4];
#pragma unroll
  for (int j = 0; j < kDT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int ch = 0; ch < nchunks; ++ch) {
    cp_wait_dyn(nchunks - 1 - ch);  // this thread's copies of chunk ch landed
    __syncthreads();                // and everyone's
    if (ch == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    // ---- S = Q . K^T for 64 keys: 8 tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const __nv_bfloat16* kr = Ks + (ch * kChunk + nt * 8 + (lane & 7)) * LD + (lane >> 3) * 8;
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int f = keep[ch * kChunk + nt * 8 + 2 * t + (j & 1)];
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
          Vs + (ch * kChunk + kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 8;
#pragma unroll
      for (int dn = 0; dn < D / 16; ++dn) {
        uint32_t r[4];
        ldsm_x4_trans(r, vr + dn * 16);
        mma_bf16(acc[2 * dn], a, r[0], r[1]);
        mma_bf16(acc[2 * dn + 1], a, r[2], r[3]);
      }
    }
  }
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

template <int D>
int launch_tc(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
              int T_, int H, cudaStream_t stream) {
  if (T_ > kTMax) return int(cudaErrorInvalidValue);
  static bool configured = false;  // the largest T's shared memory, once
  if (!configured) {
    cudaFuncSetAttribute(mha_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         int(tc_smem_bytes(D, kTMax)));
    configured = true;
  }
  dim3 grid((T_ + kQTile - 1) / kQTile, H, B);
  mha_tc_kernel<D><<<grid, kWarps * 32, tc_smem_bytes(D, T_), stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const int*>(mask),
      static_cast<__nv_bfloat16*>(o), T_, H, kLog2e / sqrtf(float(D)));
  return int(cudaGetLastError());
}

// ---------------------------------------------------------------- f32
constexpr int kQRows = 128;  // query rows (threads) per block
constexpr int kKeys = 32;    // keys per shared-memory chunk

template <int D>
__global__ void __launch_bounds__(kQRows)
mha_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ mask,
               float* __restrict__ o, int T_, int H, float scale) {
  __shared__ float Ks[kKeys][D];
  __shared__ float Vs[kKeys][D];
  __shared__ int Ms[kKeys];
  const int b = blockIdx.z, h = blockIdx.y;
  const int t = blockIdx.x * kQRows + threadIdx.x;
  const bool active = t < T_;
  const size_t row_stride = size_t(H) * D;  // between consecutive tokens
  const size_t base = (size_t(b) * T_) * row_stride + size_t(h) * D;

  float qr[D], acc[D];
#pragma unroll
  for (int c = 0; c < D; ++c) {
    qr[c] = active ? q[base + t * row_stride + c] : 0.f;
    acc[c] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < T_; k0 += kKeys) {
    const int nk = min(kKeys, T_ - k0);
    __syncthreads();
    for (int i = threadIdx.x; i < kKeys * D; i += kQRows) {
      const int j = i / D, c = i % D;
      const bool in = j < nk;
      const size_t off = base + size_t(k0 + j) * row_stride + c;
      Ks[j][c] = in ? k[off] : 0.f;
      Vs[j][c] = in ? v[off] : 0.f;
    }
    if (threadIdx.x < kKeys)
      Ms[threadIdx.x] = threadIdx.x < nk ? mask[size_t(b) * T_ + k0 + threadIdx.x] : 0;
    __syncthreads();
    if (!active) continue;

    float s[kKeys];
    float cmax = m;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < D; ++c) dot = fmaf(qr[c], Ks[j][c], dot);
      s[j] = Ms[j] > 0 ? dot * scale : kMaskValue;
      if (j < nk) cmax = fmaxf(cmax, s[j]);
    }
    const float corr = expf(m - cmax);  // 0 on the first chunk (m = -inf)
    l *= corr;
#pragma unroll
    for (int c = 0; c < D; ++c) acc[c] *= corr;
#pragma unroll
    for (int j = 0; j < kKeys; ++j) {
      if (j < nk) {
        const float p = expf(s[j] - cmax);
        l += p;
#pragma unroll
        for (int c = 0; c < D; ++c) acc[c] = fmaf(p, Vs[j][c], acc[c]);
      }
    }
    m = cmax;
  }
  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < D; ++c) o[base + t * row_stride + c] = acc[c] * inv;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, const void* mask, void* o, int B,
               int T_, int H, cudaStream_t stream) {
  dim3 grid((T_ + kQRows - 1) / kQRows, H, B);
  mha_f32_kernel<D><<<grid, kQRows, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const int*>(mask), static_cast<float*>(o), T_, H, 1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

// q/k/v/o (B, T, H, D) contiguous, dtype f32 or bf16; mask (B, T) int32.
// bf16 takes T <= 512.
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
