// Warp-level tensor-core and asynchronous-copy helpers (inline PTX, sm_80+,
// built here for sm_90a) shared by the attention (attention.cu) and scan
// (topk.cu) kernels.
//
//   cp.async      16-byte (or 4-byte) global -> shared copies that do not
//                 pass through registers, grouped by commit_group and waited
//                 for with wait_group, with a zero fill for rows past the end;
//   cp.async.bulk one thread's copy of a whole contiguous run of bytes, or of
//                 a box of a tensor map, by the TMA unit, completing on an
//                 mbarrier that counts its bytes;
//   ldmatrix      eight 8 x 16-byte rows of shared memory per matrix into the
//                 fragment layout of mma.sync (.trans transposes b16 pairs);
//   mma.sync      m16n8k16 bf16 x bf16 -> f32 and m16n8k32 s8 x s8 -> s32.
//
// Fragment layout of m16n8 (lane = 4 g + t): the accumulator's c0, c1 are
// (row g, cols 2t, 2t + 1) and c2, c3 are (row g + 8, the same cols).
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tr_mma {

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; with valid false the 16 bytes are zeroed and
// nothing is read (g must still be a mapped address).
__device__ inline void cp_async16(void* s, const void* g, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(s)), "l"(g),
               "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zeroed when valid is false.
__device__ inline void cp_async4(void* s, const void* g, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(s)), "l"(g),
               "r"(valid ? 4 : 0)
               : "memory");
}

__device__ inline void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ inline void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// wait_group with a run-time count (its operand must be an immediate); at
// most `n` of this thread's groups stay in flight.  n >= 7 waits for 7.
__device__ inline void cp_wait_dyn(int n) {
  switch (n) {
    case 0: cp_wait<0>(); break;
    case 1: cp_wait<1>(); break;
    case 2: cp_wait<2>(); break;
    case 3: cp_wait<3>(); break;
    case 4: cp_wait<4>(); break;
    case 5: cp_wait<5>(); break;
    case 6: cp_wait<6>(); break;
    default: cp_wait<7>(); break;
  }
}

// mbarriers in shared memory (8 bytes each) that complete when `count`
// threads have arrived and the bytes they announced have landed.
__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the initialised barriers visible to the asynchronous (bulk-copy) proxy.
__device__ inline void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of bulk copies to come.
__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// One arrival (no bytes): a consumer's release of what it read.
__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Orders this thread's earlier shared-memory accesses before its later
// bulk copies (the asynchronous proxy) into the same bytes.
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A 2-D box of a tensor map (TMA) global -> shared at element coordinates
// (c0 along the contiguous dimension, c1 along rows), completing on `bar`;
// `map` is the address of a CUtensorMap kernel parameter (__grid_constant__).
__device__ inline void tensor_g2s_2d(void* s, const void* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(s)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Brings a tensor map (the address of a __grid_constant__ CUtensorMap
// parameter) into the TMA unit's descriptor cache ahead of its first copy.
__device__ inline void prefetch_tensormap(const void* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A bulk copy (TMA, no tensor map) of `bytes` (a multiple of 16, both
// addresses 16-byte aligned) global -> shared, completing on `bar`.
__device__ inline void bulk_g2s(void* s, const void* g, uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_u32(s)),
      "l"(g), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Four 8x8 b16 matrices; lanes 8i .. 8i + 7 give the row addresses of matrix i.
__device__ inline void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// Two matrices; lanes 0 .. 15 give the row addresses.
__device__ inline void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_u32(p)));
}

__device__ inline void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// c += a . b, m16n8k16, bf16 in, f32 accumulate.
__device__ inline void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a . b, m16n8k32, s8 in, s32 accumulate (exact).
__device__ inline void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as a bf16x2 register, `lo` in the low half (the lower column).
__device__ inline uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace tr_mma
