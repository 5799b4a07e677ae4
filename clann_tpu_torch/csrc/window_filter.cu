// The global δ engine's window filter for NVIDIA Hopper (sm_90a).
//
// Replaces the window fetch, sketch filter, ball filter and take of one
// loop iteration of JAX's global engine (clann_tpu/ops/global_query.py:222,
// `_loop_pieces`' body, :284-362: the `rec_view[t_sel, blk]` record
// gather, the popcount Hamming test, the one-hot feasibility contraction,
// the chunk consume and the (rank, id) sort), which the port ran as a
// chain of some thirty torch ops over (Q, WB * G) lanes plus K7. The function, per query q
// (ops/window_filter.py states it whole; its plain version is the torch
// chain):
//
//   entry b < WB   = window[q][clamp(off[q], 0, P - WB) + b]
//                  = [table t, block blk, mask words]      (2 + NW words)
//   lane p = b G + l  valid  = mask bit l of entry b and not qdone[q]
//                     record = records[t][clamp(blk, 0, nb - 1) G + l]
//                            = [id, Wd sketch words, cluster]
//                     pass   = valid and feas_bound[q][clamp(cluster)] <= kth_dist[q]
//                              and (no filter or sum popc(sk ^ qsk[q][t mod S]) <= maxdiff[q])
//   consumed = max(1, #{b : passes in lanes [0, (b + 1) G) <= chunk})
//   ids[q][r] = id of the r-th passing lane below consumed G, r < cap;
//               n_sentinel for r >= that count
//   counts = (consumed, passing lanes below consumed G, valid lanes below it)
//
// What bounds it on the card: bytes, the records of the valid lanes. At
// the glove engine's knobs (G = 32, WB = 512, R = 4) that is at most
// 16,384 records of 16 B a query, 67 MB for a 256-query batch: 20 us at
// 3.35 TB/s. The torch chain moved ~4 GB an iteration through (Q, WB G)
// intermediates; here nothing of that size is written.
//
// Design: one CTA of 512 threads a query. The window's lanes are cut into
// words of 32 lanes (lane p in word p / 32), one word a warp step, so a
// warp reads a 32-lane block's 32 records in one coalesced 512 B load
// (16-byte loads where R = 4) and smaller blocks share a warp. A lane
// loads only its own record, and only where it is valid: done queries and
// masked lanes read nothing. Each warp keeps UNROLL words' loads in
// flight; the CTA's query sketches and its cluster feasibility bits (one
// compare of C bounds with kth_dist) sit in shared memory. A ballot gives
// each word's pass and valid bits (in shared memory, 3 words a window
// word), a CTA-wide scan their prefix counts, from which consumed, the
// counts and each passing lane's rank follow (prefix + popc of the lower
// lanes); the warps then re-read the id of each passing lane of the
// consumed blocks (a few hundred a query) and write it at its rank.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_scope.cuh"

namespace clann {
namespace {

constexpr int WF_THREADS = 512;
constexpr int WF_WARPS = WF_THREADS / 32;
constexpr int WF_UNROLL = 4;  // window words whose loads a warp keeps in flight

struct FilterArgs {
  const int32_t* records;  // (L, n_pad, R)
  long long n_pad;
  int L, R, g_log;
  const int32_t* window;  // (Q, P, 2 + NW)
  int P, wb, nw;
  const int32_t* off;
  const uint8_t* qdone;
  const int32_t* qsk;  // (Q, S, Wd)
  int S, Wd;
  const float* feas_bound;  // (Q, C)
  int C;
  const float* kth_dist;
  const int32_t* maxdiff;
  int use_filter, chunk;
  int32_t* ids;  // (Q, cap)
  int cap, n_sentinel;
  int32_t* counts;  // (3, Q)
  int Q;
};

// The record row of a lane, or -1 where it lies outside the records (the
// plain version's K7 gather reads zeros there).
__device__ __forceinline__ long long record_row(const FilterArgs& a, int t, int blk, int lane) {
  const long long nb = a.n_pad >> a.g_log;
  const long long b = blk < 0 ? 0 : (blk >= nb ? nb - 1 : blk);
  const long long row = static_cast<long long>(t) * nb + b;
  if (row < 0 || row >= static_cast<long long>(a.L) * nb) return -1;
  return (row << a.g_log) + lane;
}

// Passing lanes of the window before lane e (s_pre: exclusive prefix counts
// of the words, s_pre[nw32] the total).
__device__ __forceinline__ int pass_before(const uint32_t* s_pass, const uint32_t* s_pre, int e) {
  const int w = e >> 5, r = e & 31;
  return static_cast<int>(s_pre[w]) + (r ? __popc(s_pass[w] & ((1u << r) - 1u)) : 0);
}

// Sum of v over the CTA (every thread gets it); `red` holds WF_WARPS + 1 ints.
__device__ __forceinline__ int cta_sum(int v, int* red) {
  for (int o = 16; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();  // red may still be read from the last call
  if (lane == 0) red[warp] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int i = 0; i < WF_WARPS; ++i) s += red[i];
  return s;
}

template <bool VEC4>
__global__ void __launch_bounds__(WF_THREADS, 2) window_filter_kernel(const FilterArgs a) {
  extern __shared__ uint32_t smem[];
  __shared__ int red[WF_WARPS + 1];
  const int q = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = 1 << a.g_log;
  const int wl = a.wb << a.g_log;
  const int nw32 = (wl + 31) >> 5;
  const int cw = (a.C + 31) >> 5;
  uint32_t* s_pass = smem;              // nw32: pass bits of each window word
  uint32_t* s_valid = s_pass + nw32;    // nw32: valid bits
  uint32_t* s_pre = s_valid + nw32;     // nw32 + 1: exclusive prefix of pass counts
  uint32_t* s_feas = s_pre + nw32 + 1;  // cw: feasible clusters
  int32_t* s_qsk = reinterpret_cast<int32_t*>(s_feas + cw);  // S * Wd
  int32_t* ids = a.ids + static_cast<long long>(q) * a.cap;

  if (a.qdone[q]) {  // no lane is valid: consume the whole window, take nothing
    for (int r = tid; r < a.cap; r += WF_THREADS) ids[r] = a.n_sentinel;
    if (tid == 0) {
      a.counts[q] = a.wb;
      a.counts[a.Q + q] = 0;
      a.counts[2 * a.Q + q] = 0;
    }
    return;
  }

  const float kd = a.kth_dist[q];
  const float* fb = a.feas_bound + static_cast<long long>(q) * a.C;
  for (int w = warp; w < cw; w += WF_WARPS) {
    const int c = (w << 5) + lane;
    const uint32_t bits = __ballot_sync(0xffffffffu, c < a.C && fb[c] <= kd);
    if (lane == 0) s_feas[w] = bits;
  }
  const int sw = a.S * a.Wd;
  for (int i = tid; i < sw; i += WF_THREADS) s_qsk[i] = a.qsk[static_cast<long long>(q) * sw + i];
  __syncthreads();

  // 1. pass and valid bits of every window word
  const int md = a.maxdiff[q];
  int start = a.off[q];
  start = start < 0 ? 0 : (start > a.P - a.wb ? a.P - a.wb : start);
  const int ew = 2 + a.nw;
  const int32_t* win = a.window + (static_cast<long long>(q) * a.P + start) * ew;
  const int32_t* rec = a.records;
  for (int i0 = warp; i0 < nw32; i0 += WF_WARPS * WF_UNROLL) {
    int t[WF_UNROLL], row_ok[WF_UNROLL];
    long long row[WF_UNROLL];
    bool valid[WF_UNROLL];
#pragma unroll
    for (int u = 0; u < WF_UNROLL; ++u) {
      const int p = ((i0 + u * WF_WARPS) << 5) + lane;
      valid[u] = false;
      t[u] = 0;
      row[u] = -1;
      if (p < wl) {
        const int b = p >> a.g_log, l = p & (G - 1);
        const int32_t* e = win + static_cast<long long>(b) * ew;
        const int te = e[0], blk = e[1];
        const uint32_t m = static_cast<uint32_t>(e[2 + (l >> 5)]);
        if ((m >> (l & 31)) & 1u) {
          valid[u] = true;
          t[u] = te;
          row[u] = record_row(a, te, blk, l);
        }
      }
      row_ok[u] = row[u] >= 0;
    }
    int4 r4[WF_UNROLL];
#pragma unroll
    for (int u = 0; u < WF_UNROLL; ++u) {
      r4[u] = make_int4(0, 0, 0, 0);
      if (VEC4 && valid[u] && row_ok[u])
        r4[u] = __ldg(reinterpret_cast<const int4*>(rec) + row[u]);
    }
#pragma unroll
    for (int u = 0; u < WF_UNROLL; ++u) {
      const int i = i0 + u * WF_WARPS;
      bool pass = false;
      if (valid[u]) {
        const int tm = ((t[u] % a.S) + a.S) % a.S;
        const int32_t* qs = s_qsk + tm * a.Wd;
        int ham = 0, cl = 0;
        if (VEC4) {  // R = 4: [id, two sketch words, cluster]
          ham = __popc(static_cast<uint32_t>(r4[u].y ^ qs[0])) +
                __popc(static_cast<uint32_t>(r4[u].z ^ qs[1]));
          cl = r4[u].w;
        } else {
          const int32_t* r = rec + row[u] * a.R;
          for (int w = 0; w < a.Wd; ++w)
            ham += __popc(static_cast<uint32_t>((row_ok[u] ? __ldg(r + 1 + w) : 0) ^ qs[w]));
          cl = row_ok[u] ? __ldg(r + 1 + a.Wd) : 0;
        }
        cl = cl < 0 ? 0 : (cl >= a.C ? a.C - 1 : cl);
        pass = ((s_feas[cl >> 5] >> (cl & 31)) & 1u) && (!a.use_filter || ham <= md);
      }
      const uint32_t pm = __ballot_sync(0xffffffffu, pass);
      const uint32_t vm = __ballot_sync(0xffffffffu, valid[u]);
      if (lane == 0 && i < nw32) {
        s_pass[i] = pm;
        s_valid[i] = vm;
      }
    }
  }
  __syncthreads();

  // 2. exclusive prefix of the words' pass counts: thread tid scans the
  // words [tid * per, (tid + 1) * per)
  const int per = (nw32 + WF_THREADS - 1) / WF_THREADS;
  const int w0 = tid * per, w1 = min(nw32, w0 + per);
  int local = 0;
  for (int w = w0; w < w1; ++w) local += __popc(s_pass[w]);
  int incl = local;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int base = 0;
  for (int i = 0; i < warp; ++i) base += red[i];
  int run = base + incl - local;
  for (int w = w0; w < w1; ++w) {
    s_pre[w] = run;
    run += __popc(s_pass[w]);
  }
  if (tid == WF_THREADS - 1) s_pre[nw32] = run;
  __syncthreads();

  // consumed: the leading blocks whose running pass count stays <= chunk
  int n_ok = 0;
  for (int b = tid; b < a.wb; b += WF_THREADS)
    n_ok += pass_before(s_pass, s_pre, (b + 1) << a.g_log) <= a.chunk;
  const int consumed = max(1, cta_sum(n_ok, red));
  const int limit = consumed << a.g_log;  // lanes of the consumed blocks
  const int taken = pass_before(s_pass, s_pre, limit);
  int seen = 0;
  for (int w = tid; w < nw32 && (w << 5) < limit; w += WF_THREADS) {
    const int r = limit - (w << 5);
    seen += __popc(s_valid[w] & (r >= 32 ? 0xffffffffu : (1u << r) - 1u));
  }
  seen = cta_sum(seen, red);

  // 3. each passing lane of the consumed blocks writes its id at its rank
  for (int i = warp; i < nw32 && (i << 5) < limit; i += WF_WARPS) {
    const int r = limit - (i << 5);
    const uint32_t pm = s_pass[i] & (r >= 32 ? 0xffffffffu : (1u << r) - 1u);
    if (!((pm >> lane) & 1u)) continue;
    const int rank = static_cast<int>(s_pre[i]) + __popc(pm & ((1u << lane) - 1u));
    if (rank >= a.cap) continue;
    const int p = (i << 5) + lane;
    const int b = p >> a.g_log, l = p & (G - 1);
    const int32_t* e = win + static_cast<long long>(b) * ew;
    const long long rw = record_row(a, e[0], e[1], l);
    ids[rank] = rw >= 0 ? rec[rw * a.R] : 0;
  }
  for (int r = taken + tid; r < a.cap; r += WF_THREADS) ids[r] = a.n_sentinel;
  if (tid == 0) {
    a.counts[q] = consumed;
    a.counts[a.Q + q] = taken;
    a.counts[2 * a.Q + q] = seen;
  }
}

template <bool VEC4>
cudaError_t launch_filter(const FilterArgs& a, int smem, cudaStream_t stream) {
  auto* kernel = window_filter_kernel<VEC4>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<a.Q, WF_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clann

extern "C" {

// Launches the window filter on `stream` of CUDA device `device` (see the
// note above and ops/window_filter.py). Every tensor is contiguous and on
// `device`: records (L, n_pad, R) int32, window (Q, P, 2 + ceil(G / 32))
// int32, off (Q,) int32, qdone (Q,) bool, qsk (Q, S, Wd) int32, feas_bound
// (Q, C) float32, kth_dist (Q,) float32, maxdiff (Q,) int32, ids (Q, cap)
// int32 and counts (3, Q) int32 (written). G = 1 << g_log. `smem` is the
// dynamic shared memory the wrapper computed for the shapes. Returns a
// cudaError_t code (0 = launched).
int clann_window_filter(const void* records, int L, long long n_pad, int R, int g_log,
                        const void* window, int P, int wb, const void* off, const void* qdone,
                        const void* qsk, int S, int Wd, const void* feas_bound, int C,
                        const void* kth_dist, const void* maxdiff, int use_filter, int chunk,
                        void* ids, int cap, int n_sentinel, void* counts, int Q, int smem,
                        int device, void* stream) {
  if (!records || !window || !off || !qdone || !qsk || !feas_bound || !kth_dist || !maxdiff ||
      !ids || !counts || L < 1 || R < Wd + 2 || g_log < 0 || g_log > 20 ||
      n_pad % (1LL << g_log) != 0 || wb < 1 || P < wb || S < 1 || Wd < 1 || C < 1 ||
      cap < 0 || Q < 0 || (static_cast<long long>(wb) << g_log) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const clann::DeviceScope scope(device);  // the caller's device again on every return
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  clann::FilterArgs a;
  a.records = static_cast<const int32_t*>(records);
  a.n_pad = n_pad;
  a.L = L;
  a.R = R;
  a.g_log = g_log;
  a.window = static_cast<const int32_t*>(window);
  a.P = P;
  a.wb = wb;
  a.nw = ((1 << g_log) + 31) / 32;
  a.off = static_cast<const int32_t*>(off);
  a.qdone = static_cast<const uint8_t*>(qdone);
  a.qsk = static_cast<const int32_t*>(qsk);
  a.S = S;
  a.Wd = Wd;
  a.feas_bound = static_cast<const float*>(feas_bound);
  a.C = C;
  a.kth_dist = static_cast<const float*>(kth_dist);
  a.maxdiff = static_cast<const int32_t*>(maxdiff);
  a.use_filter = use_filter;
  a.chunk = chunk;
  a.ids = static_cast<int32_t*>(ids);
  a.cap = cap;
  a.n_sentinel = n_sentinel;
  a.counts = static_cast<int32_t*>(counts);
  a.Q = Q;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec4 = R == 4 && Wd == 2 && reinterpret_cast<uintptr_t>(records) % 16 == 0;
  const cudaError_t err = vec4 ? clann::launch_filter<true>(a, smem, s)
                               : clann::launch_filter<false>(a, smem, s);
  return static_cast<int>(err);
}

}  // extern "C"
