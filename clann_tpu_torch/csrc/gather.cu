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
// What bounds them on the card: random reads of whole rows from device
// memory (3.35 TB/s on an H100 SXM) and the sequential write of the output.
// Every row is an independent random access whose index must be read
// first, so the rate is set by how many bytes are in flight and by whether
// every 32-byte sector fetched is used.
//
// Two kernels:
//
// - bulk_gather_kernel (K4, K5: rows of 4 KB at the probe's shape, 32 * W
//   bytes for K5) copies each row as the TPU kernels do, with one DMA per
//   row and no per-word work: a bulk copy (cp.async.bulk, the TMA's
//   non-tensor form) from device memory into a stage of a shared-memory
//   ring, completed on the stage's mbarrier, then a bulk store of the stage
//   to the output row. Each CTA takes a contiguous run of BULK_RUN output
//   rows (the last CTA the rest), whose indices it stages in shared memory
//   first; one thread then issues every
//   copy. The hardware hands the runs to the SMs as CTAs finish, which
//   balances the random reads' uneven latencies: on an H100 this measured
//   faster than a persistent grid of one run per resident CTA (PERF.md).
//   The ring has `inflight` stages (1, 2, 4, 8, 16 or 32), the
//   counterpart of the TPU kernels' NSEM semaphores: a stage holds one row,
//   or one chunk of BULK_STAGE_MAX bytes of a wider row.
//   A stage is reloaded once its store has read it (bulk groups complete in
//   order, so `cp.async.bulk.wait_group.read LAG` after the store of item k
//   frees the stage of item k - LAG, while the LAG newer stores go on).
//   Rows outside the source are stored from a stage of zeros. Bulk copies
//   need 16-byte aligned addresses and sizes: a row is a multiple of 16
//   bytes, and a source or output that is not 16-byte aligned is refused.
// - gather_kernel (K6, K7: rows of 512 B and less, e.g. the walk's 192 B
//   records) copies a row with a warp in pieces of 32 lanes x 16 bytes (one
//   512-byte piece per warp step), neighbouring lanes on neighbouring
//   addresses, so every sector fetched is used. Rows narrower than 512 B use
//   fewer lanes per piece and the warp copies several rows per step. Each
//   warp issues the loads of INFLIGHT pieces (their indices first, then the
//   data) before it stores any of them, so INFLIGHT independent reads per
//   lane are in flight. A grid-stride loop walks the pieces. Rows whose byte
//   width, stride or base address is not a multiple of 16 take the instance
//   with 4-byte lanes (e.g. 12-byte records at G = 1, R = 3); every other
//   row takes the 16-byte one.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_async.cuh"

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


// ---- bulk_gather_kernel (K4, K5) -------------------------------------------

constexpr int BULK_THREADS = 128;     // stage the indices and zeros; thread 0 copies
constexpr int BULK_STAGE_MAX = 4096;  // bytes of a ring stage
constexpr int BULK_RUN = 64;          // rows per CTA at most (their indices in shared memory)

struct BulkArgs {
  const uint8_t* src;
  uint8_t* dst;
  const int32_t* idx;
  long long n_src;      // rows of the source
  long long n_rows;     // rows gathered
  long long row_bytes;  // a multiple of 16
  int stage_bytes;      // min(row_bytes, BULK_STAGE_MAX), a multiple of 16
  int chunks;           // stages per row
  int stages;           // inflight
  int run;              // rows per CTA (BULK_RUN; the last CTA may have fewer)
};

// Shared memory: the ring, a stage of zeros, one mbarrier per stage, the
// run's indices.
inline size_t bulk_smem_bytes(int stages, int stage_bytes, int run) {
  return static_cast<size_t>(stages + 1) * stage_bytes + 8 * static_cast<size_t>(stages) +
         4 * static_cast<size_t>(run);
}

// Position (row of the run, chunk of the row) of a ring item.
struct BulkCursor {
  int row = 0;
  int chunk = 0;
  __device__ __forceinline__ void next(int chunks) {
    if (++chunk == chunks) {
      chunk = 0;
      ++row;
    }
  }
};

template <int LAG>
__global__ void __launch_bounds__(BULK_THREADS) bulk_gather_kernel(BulkArgs a) {
  extern __shared__ __align__(128) uint8_t bulk_smem[];
  uint8_t* ring = bulk_smem;
  uint8_t* zero = ring + static_cast<size_t>(a.stages) * a.stage_bytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(zero + a.stage_bytes);
  int32_t* sidx = reinterpret_cast<int32_t*>(full + a.stages);

  const long long r0 = static_cast<long long>(blockIdx.x) * a.run;
  const int rows = static_cast<int>(min(static_cast<long long>(a.run), a.n_rows - r0));
  for (int i = threadIdx.x; i < rows; i += BULK_THREADS) {
    const int32_t s = __ldg(a.idx + r0 + i);
    sidx[i] = s >= 0 && s < a.n_src ? s : -1;  // -1: a row of zeros
  }
  for (int i = threadIdx.x; i < a.stage_bytes / 16; i += BULK_THREADS)
    reinterpret_cast<uint4*>(zero)[i] = make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async_smem();  // the zeros are read by bulk stores
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) mbar_init(full + s, 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x != 0) return;

  const int n = rows * a.chunks;  // ring items of this CTA
  const int last = static_cast<int>(a.row_bytes - static_cast<long long>(a.chunks - 1) *
                                                      a.stage_bytes);  // bytes of a last chunk
  auto load = [&](const BulkCursor& c, int s) {
    const int32_t g = sidx[c.row];
    if (g < 0) {
      mbar_arrive(full + s);  // completes the phase; the store reads the zeros
      return;
    }
    const uint32_t bytes = c.chunk == a.chunks - 1 ? last : a.stage_bytes;
    mbar_expect_tx(full + s, bytes);
    bulk_load(ring + static_cast<size_t>(s) * a.stage_bytes,
              a.src + g * a.row_bytes + static_cast<long long>(c.chunk) * a.stage_bytes, bytes,
              full + s);
  };

  BulkCursor ld, st;
  const int pre = min(a.stages, n);
  for (int s = 0; s < pre; ++s, ld.next(a.chunks)) load(ld, s);
  int loaded = pre;
  int s = 0, freed = 0;  // the stage of item k, and of item k - LAG
  uint32_t phase = 0;
  uint8_t* out = a.dst + r0 * a.row_bytes;
  for (int k = 0; k < n; ++k, st.next(a.chunks)) {
    mbar_wait(full + s, phase);
    const uint32_t bytes = st.chunk == a.chunks - 1 ? last : a.stage_bytes;
    const uint8_t* from = sidx[st.row] >= 0 ? ring + static_cast<size_t>(s) * a.stage_bytes : zero;
    bulk_store(out + st.row * a.row_bytes + static_cast<long long>(st.chunk) * a.stage_bytes,
               from, bytes);
    bulk_commit();
    if (++s == a.stages) {
      s = 0;
      phase ^= 1u;
    }
    if (k >= LAG && loaded < n) {
      bulk_wait_read<LAG>();  // the store of item k - LAG has read its stage
      load(ld, freed);
      ld.next(a.chunks);
      ++loaded;
      if (++freed == a.stages) freed = 0;
    }
  }
  bulk_wait<0>();
}

template <int LAG>
int launch_bulk_lag(const BulkArgs& a, cudaStream_t stream) {
  const size_t smem = bulk_smem_bytes(a.stages, a.stage_bytes, a.run);
  cudaError_t err = cudaFuncSetAttribute(
      bulk_gather_kernel<LAG>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long grid = (a.n_rows + a.run - 1) / a.run;
  bulk_gather_kernel<LAG><<<static_cast<unsigned>(grid), BULK_THREADS, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Rows of `row_bytes` (a multiple of 16): dst row i = src row idx[i], or
// zeros. Returns a cudaError_t code (0 = launched).
int launch_bulk(const void* src, long long n_src, long long row_bytes, const void* idx,
                long long n_rows, void* dst, int inflight, int device, void* stream) {
  if (row_bytes < 16 || row_bytes % 16 != 0 || n_src < 0 || n_rows < 0 || !src || !dst || !idx)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(src) % 16 != 0 || reinterpret_cast<uintptr_t>(dst) % 16 != 0)
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_rows == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  BulkArgs a;
  a.src = static_cast<const uint8_t*>(src);
  a.dst = static_cast<uint8_t*>(dst);
  a.idx = static_cast<const int32_t*>(idx);
  a.n_src = n_src;
  a.n_rows = n_rows;
  a.row_bytes = row_bytes;
  a.stage_bytes = static_cast<int>(row_bytes < BULK_STAGE_MAX ? row_bytes : BULK_STAGE_MAX);
  a.chunks = static_cast<int>((row_bytes + a.stage_bytes - 1) / a.stage_bytes);
  a.stages = inflight;
  a.run = BULK_RUN;
  // LAG, the stores left reading while the ring reloads: enough that the
  // issuing thread rarely waits for a store, and below the stage count
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (inflight) {
    case 1: return launch_bulk_lag<0>(a, s);
    case 2:
    case 4: return launch_bulk_lag<1>(a, s);
    case 8: return launch_bulk_lag<2>(a, s);
    case 16:
    case 32: return launch_bulk_lag<4>(a, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace
}  // namespace clann

extern "C" {

// K4. pages: (n_pages, 8, 128) 32-bit words; idx: (n,) int32 page ids;
// out: (n, 8, 128). All contiguous and on `device`, `pages` and `out`
// 16-byte aligned; launches on `stream`.
int clann_gather_pages(const void* pages, long long n_pages, const void* idx, long long n,
                       void* out, int inflight, int device, void* stream) {
  return clann::launch_bulk(pages, n_pages, 4096, idx, n, out, inflight, device, stream);
}

// K5. table: (n_table_rows, width) words; gidx: (n,) int32 group ids (the
// group of rows [8 * gidx, 8 * gidx + 8)); out: (8 * n, width). A group
// that does not lie wholly inside the table reads as zeros. `table` and
// `out` 16-byte aligned.
int clann_gather_group8(const void* table, long long n_table_rows, int width, const void* gidx,
                        long long n, void* out, int inflight, int device, void* stream) {
  if (width < 1) return static_cast<int>(cudaErrorInvalidValue);
  return clann::launch_bulk(table, n_table_rows / 8, 32LL * width, gidx, n, out, inflight, device,
                            stream);
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
