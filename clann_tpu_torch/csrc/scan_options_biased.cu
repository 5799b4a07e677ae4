// K1's options (scan_options.cuh) for biased operands (the bias column carries the +3.0).

#include "scan_options.cuh"

extern "C" int clann_scan_options_biased(const void* base, const void* queries,
                                         void* out, long long n_pad, int q_pad, int dpad,
                                         int per_bin, int group_shift, int acc_bf16,
                                         int device, void* stream) {
  return launch_options<true>(base, queries, out, n_pad, q_pad, dpad, per_bin, group_shift,
                              acc_bf16, device, stream);
}
