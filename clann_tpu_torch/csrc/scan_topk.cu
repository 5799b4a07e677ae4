// Packed fused-scan candidate kernel (K1) for NVIDIA Hopper (sm_90a).
//
// Replaces clann_tpu/ops/pallas/scan_topk.py::_scan_kernel_packed, the TPU
// kernel behind the scan-pallas query path. For every query q and every
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
// What bounds it on the card: at the glove-100 bench shape (n_pad =
// 1,212,416 rows, dpad = 128, 10,240 queries) the product is
// 2 * 1,212,416 * 128 * 10,240 ~= 3.2 TFLOP (~3.2 ms at the 989 TFLOP/s
// bf16 dense peak) plus 1.24e10 packed scores in the epilogue (an add, an
// and, an or and a max each), while the base is 310 MB of bf16. The work
// is tensor-core and epilogue-ALU bound, not bound by device memory, as
// long as a base tile is read from DRAM once and then served from L2 to
// every query tile.
//
// What the design does about it (first version: simple and right, no
// wgmma or TMA yet):
// - One CTA owns max(per_bin, 128) consecutive rows (whole bins) and 128
//   queries, and loops over its rows in 128-row chunks. The bin maxima stay
//   in shared memory for the CTA's life, so there are no global atomics,
//   no output initialisation and no second pass; each (bin, query) is
//   written once.
// - CTAs are numbered query tile fastest, so the CTAs resident at one time
//   share the same base rows and the base streams from DRAM about once.
// - Operands move global -> shared with 16-byte cp.async in a two-stage
//   pipeline (K slices of 64); the product runs on mma.sync m16n8k16 (bf16
//   in, f32 accumulate). Shared rows are padded by 8 bf16 so that the
//   32-bit fragment loads hit 32 distinct banks.
// - The scores never leave registers: each thread packs its accumulators,
//   reduces the rows it holds that share a bin, then a warp shuffle over
//   the row lanes, and one shared-memory atomicMax per (warp, bin, query).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <limits.h>

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

// One pipeline stage: the chunk's 128 x 64 base slice and the CTA's
// 128 x 64 query slice. Rows past n_pad and queries past q_pad read as 0.
__device__ __forceinline__ void load_stage(__nv_bfloat16* s_a, __nv_bfloat16* s_b,
                                           const __nv_bfloat16* __restrict__ base,
                                           const __nv_bfloat16* __restrict__ queries,
                                           long long row_start, int q0, int k0, long long n_pad,
                                           int q_pad, int dpad) {
  constexpr int VEC = 8;  // bf16 per 16-byte copy
  constexpr int PER_ROW = BK / VEC;
#pragma unroll
  for (int c = threadIdx.x; c < BM * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int kc = (c % PER_ROW) * VEC;
    const long long gr = row_start + r;
    const bool ok = gr < n_pad;
    const __nv_bfloat16* src = ok ? base + gr * dpad + k0 + kc : base;
    cp_async16(s_a + r * LDS + kc, src, ok);
  }
#pragma unroll
  for (int c = threadIdx.x; c < BN * PER_ROW; c += THREADS) {
    const int r = c / PER_ROW;
    const int kc = (c % PER_ROW) * VEC;
    const int gq = q0 + r;
    const bool ok = gq < q_pad;
    const __nv_bfloat16* src = ok ? queries + (long long)gq * dpad + k0 + kc : queries;
    cp_async16(s_b + r * LDS + kc, src, ok);
  }
}

__device__ __forceinline__ int pack_score(float acc, float shift, int keep, int sub) {
  return (__float_as_int(acc + shift) & keep) | sub;
}

__global__ void __launch_bounds__(THREADS, 2)
scan_topk_packed_kernel(const __nv_bfloat16* __restrict__ base,
                        const __nv_bfloat16* __restrict__ queries, int32_t* __restrict__ out,
                        long long n_pad, int q_pad, int dpad, int per_bin, float shift,
                        int rows_per_cta, int n_qtiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* stages = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  int* s_best = reinterpret_cast<int*>(smem_raw + OPERAND_SMEM);  // [bins_local][BN]

  const long long cta = blockIdx.x;
  const int q0 = static_cast<int>(cta % n_qtiles) * BN;
  const long long row0 = (cta / n_qtiles) * rows_per_cta;
  const int bins_local = rows_per_cta / per_bin;
  const long long n_bins_total = n_pad / per_bin;
  const int keep = ~(per_bin - 1);

  for (int i = threadIdx.x; i < bins_local * BN; i += THREADS) s_best[i] = INT_MIN;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp / WARPS_N;
  const int wn = warp % WARPS_N;
  const int g = lane >> 2;  // row (A, C) / column (B) within the mma tile
  const int t = lane & 3;

  const int n_ks = dpad / BK;
  const int n_iter = (rows_per_cta / BM) * n_ks;

  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  load_stage(stages, stages + BM * LDS, base, queries, row0, q0, 0, n_pad, q_pad, dpad);
  cp_async_commit();

  for (int it = 0; it < n_iter; ++it) {
    const int chunk = it / n_ks;
    const int ks = it % n_ks;
    if (it + 1 < n_iter) {
      __nv_bfloat16* nxt = stages + ((it + 1) & 1) * STAGE_ELEMS;
      const int nchunk = (it + 1) / n_ks;
      const int nks = (it + 1) % n_ks;
      load_stage(nxt, nxt + BM * LDS, base, queries, row0 + (long long)nchunk * BM, q0, nks * BK,
                 n_pad, q_pad, dpad);
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
        int run[NT][2];
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int lr = chunk_off + wm * WM + mt * 16 + g;
          const int sub0 = lr & (per_bin - 1);
          const int sub1 = (lr + 8) & (per_bin - 1);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int x = max(pack_score(acc[mt][nt][e], shift, keep, sub0),
                                pack_score(acc[mt][nt][e + 2], shift, keep, sub1));
              run[nt][e] = (mt % gm == 0) ? x : max(run[nt][e], x);
            }
          if ((mt + 1) % gm == 0) {  // warp-uniform
            const int bin = (chunk_off + wm * WM + (mt + 1 - gm) * 16) / per_bin;
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                int x = run[nt][e];
                x = max(x, __shfl_xor_sync(0xffffffffu, x, 4));
                x = max(x, __shfl_xor_sync(0xffffffffu, x, 8));
                x = max(x, __shfl_xor_sync(0xffffffffu, x, 16));
                if (g == 0) atomicMax(&s_best[bin * BN + wn * WN + nt * 8 + t * 2 + e], x);
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
                int x = pack_score(acc[mt][nt][h * 2 + e], shift, keep, sub);
#pragma unroll
                for (int s = 1; s < 8; s *= 2)
                  if (s < per_bin) x = max(x, __shfl_xor_sync(0xffffffffu, x, 4 * s));
                if ((g & (per_bin - 1)) == 0)
                  atomicMax(&s_best[bin * BN + wn * WN + nt * 8 + t * 2 + e], x);
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
    const long long bin = bin0 + i / BN;
    const int q = q0 + i % BN;
    if (bin < n_bins_total && q < q_pad) out[bin * q_pad + q] = s_best[i];
  }
}

}  // namespace

extern "C" {

// Launches K1 on `stream` of CUDA device `device`. base: (n_pad, dpad) bf16,
// queries: (q_pad, dpad) bf16, out: (n_pad / per_bin, q_pad) int32, all
// contiguous, 16-byte aligned and on `device`. Returns a cudaError_t code
// (0 = launched). The device is set here because this library carries its
// own copy of the CUDA runtime, whose current device is not PyTorch's.
int clann_scan_topk_packed(const void* base, const void* queries, void* out, long long n_pad,
                           int q_pad, int dpad, int per_bin, int biased, int device,
                           void* stream) {
  if (dpad <= 0 || dpad % BK != 0 || per_bin < 1 || per_bin > 16384 ||
      (per_bin & (per_bin - 1)) != 0 || n_pad < 0 || q_pad < 0 || n_pad % per_bin != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pad == 0 || q_pad == 0) return 0;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int rows_per_cta = per_bin > BM ? per_bin : BM;
  const long long n_row_groups = (n_pad + rows_per_cta - 1) / rows_per_cta;
  const int n_qtiles = (q_pad + BN - 1) / BN;
  const long long grid = n_row_groups * n_qtiles;
  if (grid > INT_MAX) return static_cast<int>(cudaErrorInvalidConfiguration);
  const size_t smem = OPERAND_SMEM + size_t(rows_per_cta / per_bin) * BN * sizeof(int);
  err = cudaFuncSetAttribute(scan_topk_packed_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  scan_topk_packed_kernel<<<static_cast<unsigned>(grid), THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(base), static_cast<const __nv_bfloat16*>(queries),
      static_cast<int32_t*>(out), n_pad, q_pad, dpad, per_bin, biased ? 0.f : 3.f, rows_per_cta,
      n_qtiles);
  return static_cast<int>(cudaGetLastError());
}

const char* clann_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
