// The kernels' shared-memory layouts (csrc/layout.h) for the Python
// wrappers' launch plans (ops/topk.py, ops/ivf_probe.py) and the tests: the
// functions the kernels size their shared memory with, built by g++ on any
// machine.  Every entry takes and returns ints; dtype is a TrDtype code,
// mode a ScanMode.
#include "../csrc/layout.h"

using namespace tr_layout;

namespace {

// A scan block's bytes: box_scan_kernel (f32, bf16) or pipe_scan_kernel
// (int8, stages of pipe_rows rows).
size_t scan_smem(int dtype, int d, int qc, int k, int mode, int stages) {
  if (box_route(dtype)) return box_scan_smem(elt_of(dtype), d, qc, k, mode, stages).total;
  return pipe_smem(d, qc, k, mode, stages, pipe_rows(d, qc, k, mode)).total;
}

// A #7 block's bytes: batched_bucket_kernel (f32) or pipe_bucket_kernel
// (bf16, int8; stages of bucket_rows rows).
size_t bucket_bytes(int dtype, int d, int qc, int stages) {
  if (dtype == TR_F32) return f32_bucket_smem(d, qc, stages).total;
  const int elt = elt_of(dtype);
  return bucket_smem(elt, d, qc, stages, bucket_rows(elt, d, qc)).total;
}

// A #6 block's bytes: probe_f32_kernel (f32) or probe_split_kernel (bf16,
// int8; stages of `rows` rows).
size_t list_bytes(int dtype, int d, int k, int stages, int rows) {
  if (dtype == TR_F32) return f32_list_smem(d, k, stages).total;
  return list_smem(elt_of(dtype), d, k, stages, rows).total;
}

// Ring stages that fit `budget` bytes, from a block's bytes at 0 and 1.
template <typename F>
int fit(F bytes, size_t budget) {
  const size_t fixed = bytes(0);
  return int(ring_fit(fixed, bytes(1) - fixed, budget));
}

}  // namespace

extern "C" {

// The bytes one block may use while `per_sm` blocks share an SM.
int tr_sm_share(int per_sm) { return int(sm_share(per_sm)); }

// #1-#3: the kernel of a dtype (1 box_scan_kernel, 0 pipe_scan_kernel),
// pipe_scan_kernel's stage rows, the ring stages that fit one block and
// its bytes with `stages` of them.
int tr_box_route(int dtype) { return box_route(dtype); }
int tr_pipe_rows(int d, int qc, int k, int mode) { return pipe_rows(d, qc, k, mode); }
int tr_scan_fit(int dtype, int d, int qc, int k, int mode) {
  return fit([=](int s) { return scan_smem(dtype, d, qc, k, mode, s); }, kSmemMax);
}
int tr_scan_smem(int dtype, int d, int qc, int k, int mode, int stages) {
  return int(scan_smem(dtype, d, qc, k, mode, stages));
}

// #7 (qc queries): a stage's rows, its warp tiling (bucket_mtw, bucket_wr of
// qc / 8 n8 tiles), the ring stages that fit one block and its bytes.
int tr_bucket_rows(int dtype, int d, int qc) {
  return dtype == TR_F32 ? tr_tile::kSub : bucket_rows(elt_of(dtype), d, qc);
}
int tr_bucket_mtw(int nt, int rows) { return bucket_mtw(nt, rows); }
int tr_bucket_wr(int nt, int rows) { return bucket_wr(nt, rows); }
int tr_bucket_fit(int dtype, int d, int qc) {
  return fit([=](int s) { return bucket_bytes(dtype, d, qc, s); }, kSmemMax);
}
int tr_bucket_smem(int dtype, int d, int qc, int stages) {
  return int(bucket_bytes(dtype, d, qc, stages));
}

// #6 (a k-long list) in a block of `per_sm` an SM: a stage's rows (f32: one
// 128-row box; else 128 where two such stages fit the block's share, else
// 64), the ring stages that fit the share and the block's bytes.
int tr_list_rows(int dtype, int d, int k, int per_sm) {
  if (dtype == TR_F32) return tr_box::kBoxRows;
  return list_smem(elt_of(dtype), d, k, 2, 128).total <= sm_share(per_sm) ? 128 : 64;
}
int tr_list_fit(int dtype, int d, int k, int rows, int per_sm) {
  return fit([=](int s) { return list_bytes(dtype, d, k, s, rows); }, sm_share(per_sm));
}
int tr_list_smem(int dtype, int d, int k, int stages, int rows) {
  return int(list_bytes(dtype, d, k, stages, rows));
}

// #5: mha_tc_kernel<D>'s ring stages at T; a block's bytes (mha_f32_kernel
// for f32, mha_tc_kernel<D> at T for bf16).
int tr_mha_stages(int d, int t) { return mha::tc_stages(d, t); }
int tr_mha_smem(int dtype, int d, int t) {
  return dtype == TR_F32 ? mha::f32_smem(d).total * 4 : int(mha::tc_smem_bytes(d, t));
}

}  // extern "C"
