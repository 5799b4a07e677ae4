// K1's options for NVIDIA Hopper (sm_90a): JAX's group_r > 1 and acc_bf16.
//
// They replace the option branches of clann_tpu/ops/pallas/scan_topk.py::
// _scan_kernel_packed. With acc_bf16 the shifted f32 scores are rounded to
// bf16 (to nearest even) before they are packed; with group_r = 2^gs > 1
// the max is taken over groups of group_r consecutive rows first, and a
// group's key is
//
//   (bitcast<int32>(max of the group) & ~(pg - 1)) | (row_in_bin >> gs),
//   pg = per_bin / group_r,
//
// so the winner names the group's first row and the caller rescores all
// group_r rows (fused_scan_topk_e2e). The output layout is K1's.
//
// On the TPU group_r never compiled (the Mosaic compiler hung on the
// grouped reduce) and was run in interpret mode only. Here it is the same
// Hopper loop as K1 (scan_hopper.cuh) with PackedKey's GROUPED and BF16
// instances. The shift, the rounding and the bitcast all keep the order of
// positive values, so a group's key is made once, from the float max of
// its rows, after a max that costs one operation per score; a group of 4
// or more rows spans lanes, and its lanes' keys stand for it as long as
// its max is not negative (a warp that sees a negative key takes the max
// over the lanes first). What bounds it is what bounds K1: the tensor
// cores, with the epilogue's integer work behind them.
//
// The instances live in two files of their own, scan_options_biased.cu
// and scan_options_unbiased.cu (one per shift), so that nvcc compiles them
// beside scan_topk.cu, in parallel; clann_scan_topk_packed calls them.

#pragma once

#include "scan_hopper.cuh"

namespace {

// K1 with group_r = 2^group_shift and / or acc_bf16: the operands, output
// and return code of clann_scan_topk_packed.
template <bool BIASED>
int launch_options(const void* base, const void* queries, void* out, long long n_pad, int q_pad,
                   int dpad, int per_bin, int group_shift, int acc_bf16, int device,
                   void* stream) {
  using clann::hopper::PackedKey;
  using clann::hopper::launch_scan;
  clann::hopper::Launch L =
      clann::hopper::whole_base_launch(base, queries, out, n_pad, q_pad, dpad, per_bin);
  L.group_shift = group_shift;
  if (n_pad == 0) return 0;
  if (group_shift == 0) return launch_scan<PackedKey<BIASED, true>>(L, device, stream);
  return acc_bf16 ? launch_scan<PackedKey<BIASED, true, true>>(L, device, stream)
                  : launch_scan<PackedKey<BIASED, false, true>>(L, device, stream);
}

}  // namespace
