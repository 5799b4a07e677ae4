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
//   K6 clann_gather_warp    replaces exp_pallas_gather.py::make_flat1d_dma
//      (:200): W-word slices of the flat (T * W,) view, span = stride = W.
//   K7 clann_gather_warp    replaces scripts/exp_gather_rate.py::dma_gather
//      (:154): rows of a (T, W) table, span = stride = W. It is the record
//      gather of both LSH engines: the global engine's (ops/global_query.py,
//      512 B rows at G = 32, R = 4, 131,072 per loop iteration of a
//      256-query batch) and the clustered walk's (ops/query.py, 192 B rows
//      at G = 16, R = 3, 65,536 per iteration).
//
// What bounds them on the card: bytes. Random reads of whole rows from
// device memory (3.35 TB/s on an H100 SXM) and the sequential write of the
// output. Every row is an independent random access whose index must be
// read first, so the rate is set by how many bytes are in flight, by
// whether every 32-byte sector fetched is used and, for the small calls of
// the walk (12.6 MB read, a 7.6 us bound), by how much of the index and
// data round trips overlap.
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
// - warp_gather_kernel (K6, K7: rows of 512 B and less) copies with the
//   lanes of a warp, through registers. A warp takes a run of `run`
//   consecutive output rows (at most 32) and copies it as one flat stream
//   of units: 16 bytes, or 4 where a row's width or a base address is not
//   a multiple of 16 bytes (e.g. 12-byte records at G = 1, R = 3). Unit
//   p of the run is unit p % su of the run's row p / su (su: units per row),
//   and lane l copies units l, l + 32, l + 64, ... The launch plan
//   (ops/gather.py::warp_plan) picks `run` so that run * su is a multiple
//   of 32: the fewest rows that fill whole warp steps, 32 / gcd(su, 32),
//   doubled while each lane's units stay within `inflight` and the call's
//   runs still give every warp of a full grid one. So every lane
//   is busy at every width, and the run's output, which is contiguous, is
//   written by stores of 32 neighbouring units (512 B at 16-byte units).
//   The kernel this one replaced gave a row the next power of two of lanes
//   at or above its width: at the walk's 192 B rows (12 units) 4 of every 16
//   lanes idled, at 12-byte rows 1 of 4.
//   The run's indices come in one coalesced load, lane r holding row r's,
//   checked against [0, n_src) once (-1: a row of zeros); the lane that
//   copies a unit takes its row's index by __shfl_sync, and moves its
//   (row, unit) pair on by 32 units with an add and a compare, never a
//   division. A lane issues every load of its run before its first store
//   (at most INFLIGHT at once, in waves where a run's units per lane exceed
//   it; the plan launches the instance with the fewest loads in flight
//   that hold a lane's units, and 16 16-byte loads at most, so registers,
//   and the warps an SM keeps, follow the rows: 32 take 128 registers and
//   leave one CTA per SM), and loads the next run's indices before it
//   stores, so a warp that takes several runs (a grid-stride loop) overlaps
//   one run's index trip with the other's data trip. The kernel it replaced
//   loaded each unit's index per lane and issued the unit's data load only
//   once the index was back, and stored nothing until every load of its
//   unit of work was back.

#include <cuda_runtime.h>
#include <stdint.h>

#include "device_scope.cuh"
#include "sm90_async.cuh"

namespace clann {
namespace {

// ---- warp_gather_kernel (K6, K7) -------------------------------------------

constexpr int WARP_THREADS = 256;  // ops/gather.py::WARP_THREADS

struct WarpArgs {
  const void* src;
  void* dst;
  const int32_t* idx;
  long long n_src;     // rows of the source view
  long long n_rows;    // rows gathered
  long long n_runs;    // ceil(n_rows / run)
  int su;              // units per row
  int run;             // rows per run (<= 32)
  int per_lane;        // units per lane in a whole run: run * su / 32
  int dr, de;          // 32 units on: dr rows and de units (32 = dr * su + de)
};

template <typename V>
__device__ __forceinline__ V zero_vec();
template <>
__device__ __forceinline__ uint4 zero_vec<uint4>() { return make_uint4(0u, 0u, 0u, 0u); }
template <>
__device__ __forceinline__ uint32_t zero_vec<uint32_t>() { return 0u; }

// The source row of row `lane` of run `run` (one coalesced load across the
// warp), or -1 where it lies outside the source, past the run or past the
// end.
__device__ __forceinline__ int32_t run_index(const WarpArgs& a, long long run, int lane) {
  if (run >= a.n_runs || lane >= a.run) return -1;
  const long long row = run * a.run + lane;
  if (row >= a.n_rows) return -1;
  const int32_t s = __ldg(a.idx + row);
  return s >= 0 && s < a.n_src ? s : -1;
}

template <typename V, int INFLIGHT>
__global__ void __launch_bounds__(WARP_THREADS) warp_gather_kernel(WarpArgs a) {
  const V* __restrict__ src = static_cast<const V*>(a.src);
  V* __restrict__ dst = static_cast<V*>(a.dst);
  const int lane = threadIdx.x & 31;
  const long long n_warps = static_cast<long long>(gridDim.x) * (WARP_THREADS / 32);
  long long run = (static_cast<long long>(blockIdx.x) * WARP_THREADS + threadIdx.x) >> 5;
  const int r_lane = lane / a.su, e_lane = lane % a.su;  // the lane's first unit of a run
  int32_t next = run_index(a, run, lane);
  for (; run < a.n_runs; run += n_warps) {
    const int32_t mine = next;  // the source row of the run's row `lane`
    const long long row0 = run * a.run;
    const int units = static_cast<int>(min(static_cast<long long>(a.run), a.n_rows - row0)) * a.su;
    V* out = dst + row0 * a.su;  // the run's output: `units` contiguous units
    int r = r_lane, e = e_lane, u = lane;
    for (int w = 0; w < a.per_lane; w += INFLIGHT, u += 32 * INFLIGHT) {
      V v[INFLIGHT];
#pragma unroll
      for (int k = 0; k < INFLIGHT; ++k) {
        const int32_t s = __shfl_sync(0xffffffffu, mine, r & 31);  // every lane takes part
        v[k] = zero_vec<V>();
        if (w + k < a.per_lane && u + 32 * k < units && s >= 0)
          v[k] = __ldg(src + static_cast<long long>(s) * a.su + e);
        e += a.de;
        r += a.dr;
        if (e >= a.su) {
          e -= a.su;
          ++r;
        }
      }
      if (w == 0) next = run_index(a, run + n_warps, lane);  // ahead of this run's stores
#pragma unroll
      for (int k = 0; k < INFLIGHT; ++k)
        if (w + k < a.per_lane && u + 32 * k < units) out[u + 32 * k] = v[k];
    }
  }
}

template <typename V>
int launch_warp_vec(const WarpArgs& a, int inflight, unsigned grid, cudaStream_t stream) {
  switch (inflight) {
    case 1: warp_gather_kernel<V, 1><<<grid, WARP_THREADS, 0, stream>>>(a); break;
    case 2: warp_gather_kernel<V, 2><<<grid, WARP_THREADS, 0, stream>>>(a); break;
    case 4: warp_gather_kernel<V, 4><<<grid, WARP_THREADS, 0, stream>>>(a); break;
    case 8: warp_gather_kernel<V, 8><<<grid, WARP_THREADS, 0, stream>>>(a); break;
    case 16: warp_gather_kernel<V, 16><<<grid, WARP_THREADS, 0, stream>>>(a); break;
    case 32:  // 4-byte units only: ops/gather.py::warp_plan holds 16-byte ones 16 at most
      if constexpr (sizeof(V) == 4) {
        warp_gather_kernel<V, 32><<<grid, WARP_THREADS, 0, stream>>>(a);
        break;
      }
      return static_cast<int>(cudaErrorInvalidValue);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
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
  const DeviceScope scope(device);  // the caller's device again on every return
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
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

// K6 and K7 with the plan of ops/gather.py::warp_plan, packed with the
// device into one word by ops/gather.py::pack_warp_plan: su (units per
// row) in bits 0-30, log2 of `run` (rows per run, 1 to 32) in 32-34, log2
// of the instance's `inflight` (loads in flight per lane: 1 to 16, or 32
// with 4-byte units) in 35-37, vec16 (16-byte units, else 4) in 38, the
// grid (CTAs of WARP_THREADS) in 39-55, the device in 56-62. src: (n_src,
// su) units; idx: (n_rows,) int32 row ids; dst: (n_rows, su) units. With
// vec16, src and dst must be 16-byte aligned.
int clann_gather_warp(const void* src, long long n_src, const void* idx, long long n_rows,
                      void* dst, long long word, void* stream) {
  const unsigned long long w = static_cast<unsigned long long>(word);
  const int su = static_cast<int>(w & 0x7fffffffu);
  const int run = 1 << ((w >> 32) & 7);
  const int inflight = 1 << ((w >> 35) & 7);
  const bool vec16 = (w >> 38) & 1;
  const int grid = static_cast<int>((w >> 39) & 0x1ffff);
  const int device = static_cast<int>((w >> 56) & 0x7f);
  if (su < 1 || run > 32 || (static_cast<long long>(run) * su) % 32 != 0 || grid < 1 ||
      n_src < 0 || n_rows < 0 || !src || !dst || !idx)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vec16 && (reinterpret_cast<uintptr_t>(src) % 16 != 0 ||
                reinterpret_cast<uintptr_t>(dst) % 16 != 0))
    return static_cast<int>(cudaErrorMisalignedAddress);
  if (n_rows == 0) return 0;
  const clann::DeviceScope scope(device);  // the caller's device again on every return
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  clann::WarpArgs a;
  a.src = src;
  a.dst = dst;
  a.idx = static_cast<const int32_t*>(idx);
  a.n_src = n_src;
  a.n_rows = n_rows;
  a.n_runs = (n_rows + run - 1) / run;
  a.su = su;
  a.run = run;
  a.per_lane = static_cast<int>(static_cast<long long>(run) * su / 32);
  a.dr = 32 / su;
  a.de = 32 % su;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec16 ? clann::launch_warp_vec<uint4>(a, inflight, static_cast<unsigned>(grid), s)
               : clann::launch_warp_vec<uint32_t>(a, inflight, static_cast<unsigned>(grid), s);
}

}  // extern "C"
