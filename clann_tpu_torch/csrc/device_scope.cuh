// The calling thread's current CUDA device, kept across a launch on another
// card.

#pragma once

#include <cuda_runtime.h>

namespace clann {
// Internal linkage: each .cu is compiled on its own and keeps its own copy.
namespace {

// Makes `device` the calling thread's current device for its scope and
// gives the caller's device back when the scope ends, on every return path.
// A launch on card 3 must not leave the thread on card 3: torch, and every
// runtime call that names no device, would use card 3 from then on.
// error() is what switching returned; launch nothing unless it is
// cudaSuccess.
class DeviceScope {
 public:
  explicit DeviceScope(int device) {
    err_ = cudaGetDevice(&prev_);
    if (err_ == cudaSuccess && prev_ != device) {
      err_ = cudaSetDevice(device);
      switched_ = err_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;

  cudaError_t error() const { return err_; }

 private:
  int prev_ = 0;
  bool switched_ = false;
  cudaError_t err_ = cudaSuccess;
};

}  // namespace
}  // namespace clann
