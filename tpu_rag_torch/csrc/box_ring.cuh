// The ring of 128-byte row boxes that the TMA kernels read, and the
// products over it: f32 ones shared by the three f32 kernels (the scan,
// #1 #2 #3 on f32 rows, topk.cu's box_scan_kernel<float>; the per-list
// probe, #6, ivf_probe.cu's probe_f32_kernel; the batched probe, #7,
// ivf_probe.cu's batched_bucket_kernel), and a bf16 one on the tensor
// cores (the scan of bf16 rows, box_scan_kernel).
//
// A box is 128 rows x 128 bytes of a row-major matrix read through a 2-D
// tensor map (the TMA unit computes the addresses and reports the bytes on
// an mbarrier), stored with the 128-byte swizzle: the 16-byte chunk c of
// box row r sits at r * 128 + (c ^ (r & 7)) * 16, so the eight rows a
// quarter warp (or an ldmatrix matrix) reads at one chunk fall in eight
// distinct bank groups.  A row of d * elt bytes is ceil(d * elt / 128)
// boxes deep; columns past it read as zero.  The kernels keep one box a
// ring stage (16 KB; a whole 128-row f32 tile is 192 KB at d 384, a bf16
// one at d 768) and their partial sums in registers over a row tile's
// boxes.
//
// Three products over one box:
//   box_tile       f32 on the CUDA cores (the reference is f32: no TF32),
//                  register micro-tiles in mma.sync's m16n8 accumulator
//                  layout: a thread's rows 16 mi + g + 8 h and queries
//                  8 j + 2 t + e, each row and query read as a float4 per
//                  chunk (12 float4 loads feed 128 FMAs at 4 x 8);
//   box_one_query  f32, one query, whose slice of the box each lane reads
//                  once: lane (g, t) sums chunks 2t and 2t + 1 of rows g
//                  and g + 8, every row float4 read once by one lane (so
//                  the box is read once, not 8 times as a column of an n8
//                  tile would), and sum_quarters completes a row's sum
//                  over the four lanes t after the tile's last box;
//   box_tile_bf16  bf16 on the tensor cores, mma.sync m16n8k16 in the
//                  same accumulator layout, f32 sums.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include "layout.h"
#include "mma_sm90.cuh"
#include "select.cuh"

namespace tr_box {

using tr_tile::kFull;

// kBoxFloats, kBoxRows, kBoxBytes, f32_boxes, f32_query_ld, align1024:
// layout.h

// acc[mi][j][2 h + e] += the box's 32 floats of row r_lo + 16 mi + g + 8 h
// (of the box at st) times those of query 8 j + 2 t + e, whose row starts
// at qrow + (8 j + e) * ld (qrow: this thread's first query, at the box's
// first float).  r_lo is a multiple of 8, so the row's swizzle is g.
template <int kMTW, int kNTW>
__device__ inline void box_tile(float (&acc)[kMTW][kNTW][4], const unsigned char* st, int r_lo,
                                const float* qrow, int ld, int g) {
  const unsigned char* arow = st + (r_lo + g) * 128;
#pragma unroll
  for (int c = 0; c < 8; ++c) {
    float4 a[kMTW][2], bq[kNTW][2];
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        a[mi][h] =
            *reinterpret_cast<const float4*>(arow + (mi * 16 + 8 * h) * 128 + ((c ^ g) << 4));
#pragma unroll
    for (int j = 0; j < kNTW; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bq[j][e] = *reinterpret_cast<const float4*>(qrow + (8 * j + e) * ld + 4 * c);
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
#pragma unroll
      for (int j = 0; j < kNTW; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            float& s = acc[mi][j][2 * h + e];
            s = fmaf(a[mi][h].x, bq[j][e].x, s);
            s = fmaf(a[mi][h].y, bq[j][e].y, s);
            s = fmaf(a[mi][h].z, bq[j][e].z, s);
            s = fmaf(a[mi][h].w, bq[j][e].w, s);
          }
  }
}

// acc[h] += chunks 2t and 2t + 1 of row r_lo + g + 8 h of the box at st
// times the query's same chunks (qbox: the query at the box's first
// float).  The 32 lanes read 32 distinct row chunks (8 rows x 4 chunk
// pairs), conflict-free under the swizzle.
__device__ inline void box_one_query(float (&acc)[2], const unsigned char* st, int r_lo,
                                     const float* qbox, int g, int t) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int c = 2 * t + u;
    const float4 qv = *reinterpret_cast<const float4*>(qbox + 4 * c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float4 a =
          *reinterpret_cast<const float4*>(st + (r_lo + g + 8 * h) * 128 + ((c ^ g) << 4));
      acc[h] = fmaf(a.x, qv.x, acc[h]);
      acc[h] = fmaf(a.y, qv.y, acc[h]);
      acc[h] = fmaf(a.z, qv.z, acc[h]);
      acc[h] = fmaf(a.w, qv.w, acc[h]);
    }
  }
}

// acc[mi][j][2 h + e] += the box's 64 bf16 columns of row r_lo + 16 mi + g
// + 8 h times those of query 8 j + 2 t + e, by four m16n8k16 steps of 16
// columns.  The rows' A fragments come by ldmatrix from the swizzled box:
// lane l names row r_lo + 16 mi + (l & 15) at chunk 2 ks + (l >> 4), and r_lo
// is a multiple of 16, so the row's swizzle is l & 7 and a matrix's eight
// rows read eight distinct physical chunks.  The queries' B fragments come
// by ldmatrix from rows of ld bytes (an odd number of 16-byte units:
// conflict-free); qbox is the warp's first query row at the box's first
// byte.
template <int kMTW, int kNTW>
__device__ inline void box_tile_bf16(float (&acc)[kMTW][kNTW][4], const unsigned char* st,
                                     int r_lo, const unsigned char* qbox, int ld, int lane) {
  const unsigned char* bq =
      qbox + ((lane & 7) + (kNTW > 1 ? (lane >> 4) << 3 : 0)) * ld + ((lane >> 3) & 1) * 16;
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    uint32_t a[kMTW][4];
    const int chunk = 2 * ks + (lane >> 4);
#pragma unroll
    for (int mi = 0; mi < kMTW; ++mi)
      tr_mma::ldsm_x4(a[mi], st + (r_lo + mi * 16 + (lane & 15)) * 128 + ((chunk ^ (lane & 7)) << 4));
    if constexpr (kNTW == 1) {
      uint32_t b[2];
      tr_mma::ldsm_x2(b, bq + ks * 32);
#pragma unroll
      for (int mi = 0; mi < kMTW; ++mi) tr_mma::mma_bf16(acc[mi][0], a[mi], b[0], b[1]);
    } else {
#pragma unroll
      for (int p = 0; p < kNTW / 2; ++p) {
        uint32_t b[4];
        tr_mma::ldsm_x4(b, bq + p * 16 * ld + ks * 32);
#pragma unroll
        for (int mi = 0; mi < kMTW; ++mi) {
          tr_mma::mma_bf16(acc[mi][2 * p], a[mi], b[0], b[1]);
          tr_mma::mma_bf16(acc[mi][2 * p + 1], a[mi], b[2], b[3]);
        }
      }
    }
  }
}

// A row's sum over the four lanes t of its g (box_one_query's partials).
__device__ inline float sum_quarters(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// The driver's cuTensorMapEncodeTiled, from the libcuda the process has
// loaded (the runtime API has no tensor maps; linking libcuda would tie the
// library to a driver stub).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// `rows` rows of row_bytes bytes as a 2-D tensor of bytes (row_bytes x
// rows), read in boxes of 128 bytes x box_rows with the 128-byte swizzle;
// columns past row_bytes and rows past `rows` read as zero.
inline bool rows_tensor_map(CUtensorMap* map, const void* base, long long rows, int row_bytes,
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

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace tr_box
