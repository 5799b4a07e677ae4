// mma.sync main loop of the unpacked scan kernel K2 (sm_90a).
//
// K2 scores bf16 base rows against bf16 queries with f32 accumulation and
// reduces the scores of each bin (per_bin consecutive base rows) to one
// winner per query, the f32 max and the lowest row reaching it, without
// writing a score to device memory. (K1 and K3, the packed kernels, run on
// the Hopper loop of scan_hopper.cuh; K2 moves there next.)
//
// Design (simple and right, no wgmma or TMA):
// - One CTA owns max(per_bin, 128) consecutive rows (whole bins) and 128
//   queries, and loops over its rows in 128-row chunks. The bin winners
//   stay in shared memory for the CTA's life: no global atomics, no output
//   initialisation, no second pass.
// - CTAs are numbered query group fastest, then row group, so the CTAs
//   resident at one time stream the same base rows and the base is read
//   from DRAM about once and then served from L2.
// - Operands move global -> shared with 16-byte cp.async in a two-stage
//   pipeline (K slices of 64); the product runs on mma.sync m16n8k16 (bf16
//   in, f32 accumulate). Shared rows are padded by 8 bf16 so that the
//   32-bit fragment loads hit 32 distinct banks.
// - The scores never leave registers: each thread turns its accumulators
//   into keys, reduces the rows it holds that share a bin, then a warp
//   shuffle over the row lanes, and one shared-memory atomicMax per (warp,
//   bin, query).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

// Internal linkage: each .cu is compiled on its own (no relocatable device
// code), so each keeps its own instances of the kernel templates below
// instead of sharing one host stub between two device modules.
namespace clann {
namespace {

constexpr int BM = 128;          // base rows per chunk
constexpr int BN = 128;          // queries per CTA
constexpr int BK = 64;           // K slice per pipeline stage
constexpr int LDS = BK + 8;      // shared row stride in bf16 (144 bytes)
constexpr int WARPS_M = 2;
constexpr int WARPS_N = 4;
constexpr int WM = BM / WARPS_M; // 64 rows per warp
constexpr int WN = BN / WARPS_N; // 32 queries per warp
constexpr int MT = WM / 16;      // m16 tiles per warp
constexpr int NT = WN / 8;       // n8 tiles per warp
constexpr int THREADS = 32 * WARPS_M * WARPS_N;
constexpr int STAGES = 2;
constexpr int STAGE_ELEMS = (BM + BN) * LDS;
constexpr size_t OPERAND_SMEM = size_t(STAGES) * STAGE_ELEMS * sizeof(__nv_bfloat16);
constexpr int MAX_PER_BIN = 16384;

// What one launch scans.
struct ScanShape {
  const __nv_bfloat16* base;     // (n_pad, dpad)
  const __nv_bfloat16* queries;  // (q_pad, dpad)
  long long n_pad;
  int q_pad;
  int dpad;
  int per_bin;
  int rows_per_cta;              // max(per_bin, BM): whole bins, whole chunks
  int q_groups;                  // CTAs along the queries
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = pred ? 16 : 0;  // 0 source bytes: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_one() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One pipeline stage: a 128 x 64 slice of the CTA's base rows and of its
// queries. Base rows at or past rows_left and queries at or past q_left read
// as 0; `fallback` is a valid address for the skipped copies.
__device__ __forceinline__ void load_stage(__nv_bfloat16* s_a, __nv_bfloat16* s_b,
                                           const __nv_bfloat16* __restrict__ base_c,
                                           const __nv_bfloat16* __restrict__ queries_c,
                                           const __nv_bfloat16* fallback, int chunk_row,
                                           long long rows_left, int q_left, int k0, int dpad) {
  constexpr int VEC = 8;  // bf16 per 16-byte copy
  constexpr int PER_ROW = BK / VEC;
#pragma unroll
  for (int c = threadIdx.x; c < BM * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int kc = (c % PER_ROW) * VEC;
    const bool ok = chunk_row + r < rows_left;
    const __nv_bfloat16* src = ok ? base_c + (long long)(chunk_row + r) * dpad + k0 + kc : fallback;
    cp_async16(s_a + r * LDS + kc, src, ok);
  }
#pragma unroll
  for (int c = threadIdx.x; c < BN * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int kc = (c % PER_ROW) * VEC;
    const bool ok = r < q_left;
    const __nv_bfloat16* src = ok ? queries_c + (long long)r * dpad + k0 + kc : fallback;
    cp_async16(s_b + r * LDS + kc, src, ok);
  }
}

// K2 epilogue: per bin the f32 max of the unshifted score and the lowest
// row reaching it. key = order-preserving image of the float bits (high
// word) | per_bin - 1 - row_in_bin (low word), so one unsigned max picks the
// largest score and, among equal scores, the lowest row. -0.0 is folded into
// +0.0 first (they compare equal as floats). vals / ids are
// (q_pad, n_pad / per_bin) with ids = bin * per_bin + row_in_bin.
struct ArgmaxEpi {
  using Key = unsigned long long;
  float* vals;
  int32_t* ids;
  int per_bin;

  __device__ __forceinline__ Key empty() const { return 0ull; }
  __device__ __forceinline__ Key make(float acc, int sub) const {
    uint32_t b = __float_as_uint(acc == 0.f ? 0.f : acc);
    b = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
    return (static_cast<Key>(b) << 32) | static_cast<uint32_t>(per_bin - 1 - sub);
  }
  __device__ __forceinline__ static Key kmax(Key a, Key b) { return a > b ? a : b; }
  __device__ __forceinline__ static void atomic_max(Key* p, Key v) { atomicMax(p, v); }
  __device__ __forceinline__ void store(long long bin, int q, long long n_bins, Key k) const {
    uint32_t b = static_cast<uint32_t>(k >> 32);
    b = (b & 0x80000000u) ? (b & 0x7FFFFFFFu) : ~b;
    const long long at = static_cast<long long>(q) * n_bins + bin;
    vals[at] = __uint_as_float(b);
    ids[at] = static_cast<int32_t>(bin * per_bin + (per_bin - 1 - static_cast<int>(k & 0xFFFFFFFFull)));
  }
};

template <class Epi>
__global__ void __launch_bounds__(THREADS, 2)
scan_kernel(const ScanShape sh, const Epi epi) {
  using Key = typename Epi::Key;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  Key* s_best = reinterpret_cast<Key*>(smem_raw + OPERAND_SMEM);  // [bins_local][BN]

  const long long cta = blockIdx.x;
  const int q0 = static_cast<int>(cta % sh.q_groups) * BN;
  const long long row0 = (cta / sh.q_groups) * sh.rows_per_cta;
  const int per_bin = sh.per_bin;
  const int bins_local = sh.rows_per_cta / per_bin;
  const long long n_bins = sh.n_pad / per_bin;

  // base rows past n_pad and queries past q_pad read as 0
  const long long rows_left = sh.n_pad - row0;
  const __nv_bfloat16* base_c = sh.base + row0 * static_cast<long long>(sh.dpad);
  const __nv_bfloat16* queries_c = sh.queries + static_cast<long long>(q0) * sh.dpad;
  const int q_left = sh.q_pad - q0;

  for (int i = threadIdx.x; i < bins_local * BN; i += THREADS) s_best[i] = epi.empty();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;  // row (A, C) / column (B) within the mma tile
  const int t = lane & 3;

  const int n_ks = sh.dpad / BK;
  const int n_iter = (sh.rows_per_cta / BM) * n_ks;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load_stage(stages, stages + BM * LDS, base_c, queries_c, sh.base, 0, rows_left, q_left, 0,
             sh.dpad);
  cp_async_commit();

  for (int it = 0; it < n_iter; ++it) {
    const int chunk = it / n_ks;
    const int ks = it % n_ks;
    if (it + 1 < n_iter) {
      __nv_bfloat16* nxt = stages + ((it + 1) & 1) * STAGE_ELEMS;
      const int nchunk = (it + 1) / n_ks;
      const int nks = (it + 1) % n_ks;
      load_stage(nxt, nxt + BM * LDS, base_c, queries_c, sh.base, nchunk * BM, rows_left, q_left,
                 nks * BK, sh.dpad);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const __nv_bfloat16* s_a = stages + (it & 1) * STAGE_ELEMS;
    const __nv_bfloat16* s_b = s_a + BM * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      uint32_t a[MT][4];
      uint32_t b[NT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const __nv_bfloat16* p = s_a + (wm * WM + mt * 16 + g) * LDS + kk + t * 2;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 8);
      }
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const __nv_bfloat16* p = s_b + (wn * WN + nt * 8 + g) * LDS + kk + t * 2;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 8);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16_16816(acc[mt][nt], a[mt], b[nt]);
    }

    if (ks == n_ks - 1) {
      // Epilogue of one 128-row chunk. Accumulator (mt, nt, e) of this
      // thread is row wm*64 + mt*16 + g + (e >= 2 ? 8 : 0) of the chunk and
      // query wn*32 + nt*8 + 2t + (e & 1) of the CTA.
      const int chunk_off = chunk * BM;  // chunk's first row, relative to row0
      if (per_bin >= 16) {
        // rows g and g+8 of an m16 tile, and the 8 row lanes, share a bin;
        // gm consecutive m16 tiles form one bin inside the warp
        const int gm = per_bin / 16 < MT ? per_bin / 16 : MT;
        Key run[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int lr = chunk_off + wm * WM + mt * 16 + g;
          const int sub0 = lr & (per_bin - 1);
          const int sub1 = (lr + 8) & (per_bin - 1);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const Key x = Epi::kmax(epi.make(acc[mt][nt][e], sub0),
                                      epi.make(acc[mt][nt][e + 2], sub1));
              run[nt][e] = (mt % gm == 0) ? x : Epi::kmax(run[nt][e], x);
            }
          if ((mt + 1) % gm == 0) {  // warp-uniform
            const int bin = (chunk_off + wm * WM + (mt + 1 - gm) * 16) / per_bin;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                Key x = run[nt][e];
                x = Epi::kmax(x, __shfl_xor_sync(0xffffffffu, x, 4));
                x = Epi::kmax(x, __shfl_xor_sync(0xffffffffu, x, 8));
                x = Epi::kmax(x, __shfl_xor_sync(0xffffffffu, x, 16));
                if (g == 0) Epi::atomic_max(&s_best[bin * BN + wn * WN + nt * 8 + t * 2 + e], x);
              }
          }
        }
      } else {
        // per_bin in {1, 2, 4, 8}: a bin is per_bin consecutive row lanes
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int lr = chunk_off + wm * WM + mt * 16 + h * 8 + g;
            const int sub = lr & (per_bin - 1);
            const int bin = lr / per_bin;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                Key x = epi.make(acc[mt][nt][h * 2 + e], sub);
#pragma unroll
                for (int s = 1; s < 8; s *= 2)
                  if (s < per_bin) x = Epi::kmax(x, __shfl_xor_sync(0xffffffffu, x, 4 * s));
                if ((g & (per_bin - 1)) == 0)
                  Epi::atomic_max(&s_best[bin * BN + wn * WN + nt * 8 + t * 2 + e], x);
              }
          }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    }
    __syncthreads();  // the stage just read is refilled two iterations on
  }

  const long long bin0 = row0 / per_bin;
  for (int i = threadIdx.x; i < bins_local * BN; i += THREADS) {
    // (q, bin) output: walk bins fastest so neighbouring threads write
    // neighbouring addresses
    const int lb = i % bins_local;
    const int lq = i / bins_local;
    const long long bin = bin0 + lb;
    const int q = q0 + lq;
    if (bin < n_bins && q < sh.q_pad) epi.store(bin, q, n_bins, s_best[lb * BN + lq]);
  }
}

// Shape of a launch; false if the arguments are not ones the kernel takes
// (dpad a multiple of BK, per_bin a power of two dividing n_pad, non-negative
// sizes, a grid that fits).
inline bool make_shape(ScanShape& sh, long long& grid, const void* base, const void* queries,
                       long long n_pad, int q_pad, int dpad, int per_bin) {
  if (dpad <= 0 || dpad % BK != 0 || per_bin < 1 || per_bin > MAX_PER_BIN ||
      (per_bin & (per_bin - 1)) != 0 || n_pad < 0 || q_pad < 0 || n_pad % per_bin != 0)
    return false;
  sh.base = static_cast<const __nv_bfloat16*>(base);
  sh.queries = static_cast<const __nv_bfloat16*>(queries);
  sh.n_pad = n_pad;
  sh.q_pad = q_pad;
  sh.dpad = dpad;
  sh.per_bin = per_bin;
  sh.rows_per_cta = per_bin > BM ? per_bin : BM;
  const long long row_groups = (n_pad + sh.rows_per_cta - 1) / sh.rows_per_cta;
  const long long q_groups = (q_pad + BN - 1) / BN;
  if (row_groups > INT_MAX || q_groups > INT_MAX) return false;
  sh.q_groups = static_cast<int>(q_groups);
  grid = row_groups * q_groups;
  return grid <= INT_MAX;
}

// Launches scan_kernel<Epi> on `stream` of CUDA device `device` and returns
// the cudaError_t code (0 = launched). The device is set here because the
// library carries its own copy of the CUDA runtime, whose current device is
// not PyTorch's.
template <class Epi>
int launch_scan(const ScanShape& sh, long long grid, const Epi& epi, int device, void* stream) {
  if (grid == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = OPERAND_SMEM + size_t(sh.rows_per_cta / sh.per_bin) * BN *
                                         sizeof(typename Epi::Key);
  err = cudaFuncSetAttribute(scan_kernel<Epi>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_kernel<Epi><<<static_cast<unsigned>(grid), THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(sh, epi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace clann
