// Fused multi-head self-attention for the encoder forward.
//
// Replaces the Pallas kernel #5 of tpu_rag/ops/attention.py (_mha_kernel):
// per (batch, head), softmax(Q . K^T / sqrt(D), keys whose mask is 0 set to
// -1e30) . V, scores and softmax in f32, output in the input dtype.  Only the
// key side is masked; q/k/v and the output are (B, T, H, D).
//
// The TPU kernel holds a head's whole T x T score tile in VMEM (1 MB of f32
// at T = 512).  An H100 block has at most 227 KB of shared memory, so this
// kernel never materialises the tile: it walks the keys in chunks of 32 with
// an online softmax (a running f32 max and sum per query), the scheme of
// FlashAttention.  The -1e30 fill (not -inf) keeps the TPU kernel's answer
// for an all-pad row: every score equals -1e30, so the output is the plain
// average of V.
//
// What bounds it on the H100: at MiniLM's D = 32 a (T x T x D) head is
// ~2*T*T*D operations over ~4*T*D*2 bytes — about T/2 ops a byte, 128 at
// T = 256, below the bf16 ridge, so bytes bound the ideal kernel.  This
// first version is simple instead: one thread per query row (q row and the
// f32 accumulator in registers), K/V chunks staged through shared memory in
// f32 and read as broadcasts, CUDA-core FMAs, no tensor cores.  It is
// bounded by those FMAs and the exp per score; moving QK^T and PV onto the
// tensor cores is later work.

#include <cuda_bf16.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kQRows = 128;  // query rows (threads) per block
constexpr int kKeys = 32;    // keys per shared-memory chunk
constexpr float kMaskValue = -1e30f;

__device__ inline float to_f32(float v) { return v; }
__device__ inline float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ inline T from_f32(float v);
template <> __device__ inline float from_f32<float>(float v) { return v; }
template <> __device__ inline __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int D>
__global__ void __launch_bounds__(kQRows)
mha_kernel(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const int* __restrict__ mask,
           T* __restrict__ o, int T_, int H, float scale) {
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
    qr[c] = active ? to_f32(q[base + t * row_stride + c]) : 0.f;
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
      Ks[j][c] = in ? to_f32(k[off]) : 0.f;
      Vs[j][c] = in ? to_f32(v[off]) : 0.f;
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
    for (int c = 0; c < D; ++c) o[base + t * row_stride + c] = from_f32<T>(acc[c] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           int B, int T_, int H, cudaStream_t stream) {
  dim3 grid((T_ + kQRows - 1) / kQRows, H, B);
  mha_kernel<T, D><<<grid, kQRows, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(o), T_, H, 1.f / sqrtf(float(D)));
  return int(cudaGetLastError());
}

}  // namespace

// q/k/v/o (B, T, H, D) contiguous, dtype f32 or bf16; mask (B, T) int32.
extern "C" int tr_mha(const void* q, const void* k, const void* v,
                      const void* mask, void* o, int B, int T_, int H, int D,
                      int dtype, void* stream) {
  if (B <= 0 || T_ <= 0 || H <= 0) return int(cudaErrorInvalidValue);
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == TR_BF16 && D == 32) return launch<__nv_bfloat16, 32>(q, k, v, mask, o, B, T_, H, s);
  if (dtype == TR_BF16 && D == 64) return launch<__nv_bfloat16, 64>(q, k, v, mask, o, B, T_, H, s);
  if (dtype == TR_F32 && D == 32) return launch<float, 32>(q, k, v, mask, o, B, T_, H, s);
  if (dtype == TR_F32 && D == 64) return launch<float, 64>(q, k, v, mask, o, B, T_, H, s);
  return int(cudaErrorInvalidValue);
}
