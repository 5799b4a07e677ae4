// Dense fused-scan candidate kernels K1 (packed) and K2 (value + argmax)
// for NVIDIA Hopper (sm_90a).
//
// K1 replaces clann_tpu/ops/pallas/scan_topk.py::_scan_kernel_packed, the
// TPU kernel behind the scan-pallas query path. For every query q and every
// global bin g (rows [g*per_bin, (g+1)*per_bin) of the padded base) it
// writes
//
//   out[g][q] = max over rows r of the bin of
//               (bitcast<int32>(dot_f32(base[r], query[q]) + shift) & ~(per_bin-1))
//               | (r mod per_bin)
//
// with bf16 operands and f32 accumulation. shift is 0 when the operands
// carry the bias column (base column d == 1.0, query column d == 3.0, so
// the product already holds score + 3.0 and lands in [2, 4), where the f32
// bit pattern orders like the float) and 3.0 otherwise. Output layout is
// the JAX kernel's (n_pad / per_bin, q_pad) int32; the decode and the
// cross-bin top-k stay in PyTorch (clann_tpu_torch/ops/scan_topk.py).
//
// K2 replaces clann_tpu/ops/pallas/scan_topk.py::_scan_kernel, the unpacked
// kernel behind pallas_scan_topk. Per (query, bin) it writes the f32 max of
// the unshifted dot and the lowest row reaching it, in the JAX layout:
// vals (q_pad, n_pad / per_bin) f32 and ids (q_pad, n_pad / per_bin) int32,
// ids = bin * per_bin + row_in_bin (JAX's blk*block_n + bin*per_bin + arg).
//
// Both run on the Hopper main loop of scan_hopper.cuh (persistent,
// warp-specialised, TMA + wgmma), shared with K3; they differ in its
// epilogue policy only (PackedKey, ArgmaxKey).
//
// What bounds them on the card: at the glove-100 bench shape (n_pad =
// 1,212,416 rows, dpad = 128, 2,048 queries per launch) the product is
// 6.4e11 FLOP (0.64 ms at the 989 TFLOP/s bf16 dense peak) plus 2.5e9
// scores reduced in the epilogue, while the base is 310 MB of bf16 (0.09 ms
// at 3.35 TB/s). The work is tensor-core bound as long as a base tile is
// read from DRAM once and then served from L2 to every query group and the
// epilogue's integer work hides behind the product: two operations per
// score for K1, about six for K2, whose winner is a value and a row.

#include "scan_hopper.cuh"

namespace {

// One tile over the whole base: K1 and K2.
clann::hopper::Launch scan_launch(const void* base, const void* queries, void* out,
                                  long long n_pad, int q_pad, int dpad, int per_bin) {
  clann::hopper::Launch L;
  L.base = base;
  L.queries = queries;
  L.tile_block = nullptr;
  L.tile_live = nullptr;
  L.out = static_cast<int32_t*>(out);
  L.vals = nullptr;
  L.n_pad = n_pad;
  L.tile_rows = n_pad;
  L.n_tiles = 1;
  L.tile_q = q_pad;
  L.dpad = dpad;
  L.per_bin = per_bin;
  L.min_item_rows = 512;  // the grid keeps its query groups: fine items balance best
  return L;
}

}  // namespace

extern "C" {

// Launches K1 on `stream` of CUDA device `device`. base: (n_pad, dpad) bf16,
// queries: (q_pad, dpad) bf16, out: (n_pad / per_bin, q_pad) int32, all
// contiguous, 16-byte aligned and on `device`. Returns a cudaError_t code
// (0 = launched).
int clann_scan_topk_packed(const void* base, const void* queries, void* out, long long n_pad,
                           int q_pad, int dpad, int per_bin, int biased, int device,
                           void* stream) {
  const clann::hopper::Launch L = scan_launch(base, queries, out, n_pad, q_pad, dpad, per_bin);
  if (n_pad == 0) return 0;
  return biased ? clann::hopper::launch_scan<clann::hopper::PackedKey<true>>(L, device, stream)
                : clann::hopper::launch_scan<clann::hopper::PackedKey<false>>(L, device, stream);
}

// Launches K2 on `stream` of CUDA device `device`. base: (n_pad, dpad) bf16,
// queries: (q_pad, dpad) bf16, vals: (q_pad, n_pad / per_bin) f32, ids:
// (q_pad, n_pad / per_bin) int32, all contiguous, 16-byte aligned and on
// `device`. Returns a cudaError_t code (0 = launched).
int clann_scan_candidates(const void* base, const void* queries, void* vals, void* ids,
                          long long n_pad, int q_pad, int dpad, int per_bin, int device,
                          void* stream) {
  if (n_pad > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);  // ids are int32 rows
  clann::hopper::Launch L = scan_launch(base, queries, ids, n_pad, q_pad, dpad, per_bin);
  L.vals = static_cast<int32_t*>(vals);
  if (n_pad == 0) return 0;
  return clann::hopper::launch_scan<clann::hopper::ArgmaxKey>(L, device, stream);
}

const char* clann_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
