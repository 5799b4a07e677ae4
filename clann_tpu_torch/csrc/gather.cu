// Row-gather kernels K4, K5, K6 and K7 for NVIDIA Hopper (sm_90a).
//
// All four compute one function on 32-bit words:
//
//   dst[i * span + w] = src[idx[i] * stride + w],  w < span, i < n_rows
//
// with dst[i * span + w] = 0 where idx[i] lies outside [0, n_src) (the
// wrapper's plain version masks the same way). They differ in how the
// source is viewed, which the C entry points below fix:
//
//   K4 clann_gather_pages   replaces scripts/exp_pallas_gather.py::
//      make_page_dma (pallas_call at :87): one 4 KB page (8 x 128 words)
//      per index, span = stride = 1024.
//   K5 clann_gather_group8  replaces exp_pallas_gather.py::make_group8_dma
//      (:146): the aligned 8-row group holding row 8 * gidx[i] of a (T, W)
//      table, span = stride = 8 * W.
//   K6 clann_gather_flat1d  replaces exp_pallas_gather.py::make_flat1d_dma
//      (:200): W-word slices of the flat (T * W,) view, span = stride = W.
//   K7 clann_gather_rows    replaces scripts/exp_gather_rate.py::dma_gather
//      (:154): rows of a (T, W) table, span = stride = W. It is the global
//      LSH engine's record gather (clann_tpu/ops/global_query.py:284): W =
//      G * R words, 128 words = 512 B at G = 32, R = 4, and 131,072 rows per
//      loop iteration of a 256-query batch.
//
// What bounds them on the card: random reads of 512 B or 4 KB rows from
// device memory (3.35 TB/s on an H100 SXM). 131,072 rows of 512 B are 67 MB,
// ~20 us at full bandwidth, but every row is an independent random access
// whose index must be read first, so the rate is set by how many reads are
// in flight and by whether every 32-byte sector fetched is used, not by
// the bandwidth.
//
// What the design does about it: a warp copies a row in pieces of 32 lanes
// x 16 bytes (one 512-byte piece per warp step; a 4 KB row is 8 pieces),
// neighbouring lanes on neighbouring addresses, so every sector fetched is
// used. Rows narrower than 512 B use fewer lanes per piece and the warp
// copies several rows per step. Each warp issues the loads of INFLIGHT
// pieces (their indices first, then the data) before it stores any of
// them, so INFLIGHT independent reads per lane are in flight: the
// counterpart of the TPU kernels' NSEM / `inflight` DMA semaphores, and a
// launch parameter here (1, 2, 4, 8, 16 or 32). A grid-stride loop walks the
// pieces. Rows whose byte width, stride or base address is not a multiple
// of 16 take the instance with 4-byte lanes (e.g. 12-byte records at
// G = 1, R = 3); every other row takes the 16-byte one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace clann {
namespace {

constexpr int GATHER_THREADS = 256;

struct GatherArgs {
  const void* src;
  void* dst;
  const int32_t* idx;
  long long n_src;     // rows of the source view
  long long n_items;   // n_rows * cpr
  long long su;        // span in vector units
  long long stride_u;  // stride in vector units
  int lpr;             // lanes per piece (power of two <= 32)
  int lpr_log;
  long long cpr;       // pieces per row
};

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ uint4 zero_vec<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ uint32_t zero_vec<uint32_t>() { return 0u; }

// Row and element (in vector units) of piece `item` for this lane; false
// where the lane lies past the row's span or the item past the end.
__device__ __forceinline__ bool locate(const GatherArgs& a, long long item, int sub,
                                       long long& row, long long& e) {
  if (item >= a.n_items) return false;
  if (a.cpr == 1) {
    row = item;
    e = sub;
  } else {
    row = item / a.cpr;
    e = (item - row * a.cpr) * a.lpr + sub;
  }
  return e < a.su;
}

template <typename V, int INFLIGHT>
__global__ void __launch_bounds__(GATHER_THREADS) gather_kernel(GatherArgs a) {
  const V* __restrict__ src = static_cast<const V*>(a.src);
  V* __restrict__ dst = static_cast<V*>(a.dst);
  const int lane = threadIdx.x & 31;
  const int group = lane >> a.lpr_log;  // which piece of the warp step
  const int sub = lane & (a.lpr - 1);   // lane within the piece
  const int per_step = 32 >> a.lpr_log;
  const long long per_unit = static_cast<long long>(INFLIGHT) * per_step;
  const long long n_warps = (static_cast<long long>(gridDim.x) * GATHER_THREADS) >> 5;
  long long unit = (static_cast<long long>(blockIdx.x) * GATHER_THREADS + threadIdx.x) >> 5;
  for (; unit * per_unit < a.n_items; unit += n_warps) {
    const long long item0 = unit * per_unit + group;
    int32_t s[INFLIGHT];  // row indices (-1 where the lane has no piece)
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      long long row, e;
      s[k] = -1;
      if (locate(a, item0 + static_cast<long long>(k) * per_step, sub, row, e))
        s[k] = __ldg(a.idx + row);
    }
    V v[INFLIGHT];
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      long long row, e;
      v[k] = zero_vec<V>();
      if (locate(a, item0 + static_cast<long long>(k) * per_step, sub, row, e) &&
          s[k] >= 0 && s[k] < a.n_src)
        v[k] = __ldg(src + s[k] * a.stride_u + e);
    }
#pragma unroll
    for (int k = 0; k < INFLIGHT; ++k) {
      long long row, e;
      if (locate(a, item0 + static_cast<long long>(k) * per_step, sub, row, e))
        dst[row * a.su + e] = v[k];
    }
  }
}

template <typename V>
int launch_vec(const GatherArgs& a, int inflight, unsigned grid, cudaStream_t stream) {
  switch (inflight) {
    case 1: gather_kernel<V, 1><<<grid, GATHER_THREADS, 0, stream>>>(a); break;
    case 2: gather_kernel<V, 2><<<grid, GATHER_THREADS, 0, stream>>>(a); break;
    case 4: gather_kernel<V, 4><<<grid, GATHER_THREADS, 0, stream>>>(a); break;
    case 8: gather_kernel<V, 8><<<grid, GATHER_THREADS, 0, stream>>>(a); break;
    case 16: gather_kernel<V, 16><<<grid, GATHER_THREADS, 0, stream>>>(a); break;
    case 32: gather_kernel<V, 32><<<grid, GATHER_THREADS, 0, stream>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The shared launcher: `span_w` / `stride_w` in 32-bit words; returns a
// cudaError_t code (0 = launched).
int launch_gather(const void* src, long long n_src, long long span_w, long long stride_w,
                  const void* idx, long long n_rows, void* dst, int inflight, int device,
                  void* stream) {
  if (span_w < 1 || stride_w < span_w || n_src < 0 || n_rows < 0 || !src || !dst || !idx)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec16 = span_w % 4 == 0 && stride_w % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  GatherArgs a;
  a.src = src;
  a.dst = dst;
  a.idx = static_cast<const int32_t*>(idx);
  a.n_src = n_src;
  a.su = vec16 ? span_w / 4 : span_w;
  a.stride_u = vec16 ? stride_w / 4 : stride_w;
  a.lpr = 1;
  a.lpr_log = 0;
  while (a.lpr < 32 && a.lpr < a.su) {
    a.lpr <<= 1;
    ++a.lpr_log;
  }
  a.cpr = (a.su + a.lpr - 1) / a.lpr;
  a.n_items = n_rows * a.cpr;
  const long long per_block =
      static_cast<long long>(inflight) * (32 >> a.lpr_log) * (GATHER_THREADS / 32);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long grid = (a.n_items + per_block - 1) / per_block;
  if (grid > 8LL * sms) grid = 8LL * sms;  // the grid-stride loop covers the rest
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec16 ? launch_vec<uint4>(a, inflight, static_cast<unsigned>(grid), s)
               : launch_vec<uint32_t>(a, inflight, static_cast<unsigned>(grid), s);
}

}  // namespace
}  // namespace clann

extern "C" {

// K4. pages: (n_pages, 8, 128) 32-bit words; idx: (n,) int32 page ids;
// out: (n, 8, 128). All contiguous and on `device`; launches on `stream`.
int clann_gather_pages(const void* pages, long long n_pages, const void* idx, long long n,
                       void* out, int inflight, int device, void* stream) {
  return clann::launch_gather(pages, n_pages, 1024, 1024, idx, n, out, inflight, device, stream);
}

// K5. table: (n_table_rows, width) words; gidx: (n,) int32 group ids (the
// group of rows [8 * gidx, 8 * gidx + 8)); out: (8 * n, width). A group
// that does not lie wholly inside the table reads as zeros.
int clann_gather_group8(const void* table, long long n_table_rows, int width, const void* gidx,
                        long long n, void* out, int inflight, int device, void* stream) {
  return clann::launch_gather(table, n_table_rows / 8, 8LL * width, 8LL * width, gidx, n, out,
                              inflight, device, stream);
}

// K6. flat: (n_words,) words; idx: (n,) int32 slice ids (words
// [idx * width, (idx + 1) * width)); out: (n * width,).
int clann_gather_flat1d(const void* flat, long long n_words, int width, const void* idx,
                        long long n, void* out, int inflight, int device, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  return clann::launch_gather(flat, n_words / width, width, width, idx, n, out, inflight, device,
                              stream);
}

// K7. src: (n_src_rows, width) words; idx: (n,) int32 row ids; out:
// (n, width).
int clann_gather_rows(const void* src, long long n_src_rows, int width, const void* idx,
                      long long n, void* out, int inflight, int device, void* stream) {
  return clann::launch_gather(src, n_src_rows, width, width, idx, n, out, inflight, device,
                              stream);
}

}  // extern "C"
