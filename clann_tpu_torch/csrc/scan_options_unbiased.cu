// K1's options (scan_options.cuh) for unbiased operands (+3.0 added in the epilogue).

#include "scan_options.cuh"

extern "C" int clann_scan_options_unbiased(const void* base, const void* queries,
                                           void* out, long long n_pad, int q_pad, int dpad,
                                           int per_bin, int group_shift, int acc_bf16,
                                           int device, void* stream) {
  return launch_options<false>(base, queries, out, n_pad, q_pad, dpad, per_bin, group_shift,
                               acc_bf16, device, stream);
}
