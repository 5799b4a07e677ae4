// The global δ engine's score-and-merge for NVIDIA Hopper (sm_90a).
//
// Replaces no TPU kernel: JAX's global engine scores and merges with jnp
// ops (clann_tpu/ops/global_query.py, `_loop_pieces`' body: the
// `vectors[safe_ids]` gather, the dot, `_merge_topk`'s sorts), which the
// port ran as torch ops over every one of the CB = chunk + G compacted
// slots of a query, sentinels included: a (Q, CB, d) gather, a bmm, an id
// sort, a (Q, CB, kk) in-top-k test and a stable sort of kk + CB sims.
// The function, per query q (ops/score_merge.py states it whole; its
// plain version is that torch chain):
//
//   live candidate  = cand[q][i] with 0 <= id < n_sentinel, counted once
//                     however often it occurs, dropped where topk_ids[q]
//                     holds it already
//   its sim         = clamp((dot(vectors[min(id, n_rows - 1)], queries[q]) + 1) * 0.5, 0, 1)
//                     (int8: the exact integer dot times 1/127^2, each step
//                     rounded on its own, as the torch chain rounds it)
//   new top-kk      = the best kk of [the kk old entries, the live
//                     candidates] by (sim descending, an old entry before a
//                     candidate, old entries by position, candidates by id)
//   out_sims, ids   = max(sim, 0); the id, or -1 where the sim is < 0
//
// What bounds it on the card: bytes, the rows of the distinct live
// candidates. At the engine cells' knobs a query takes ~240-330 of its
// 2,080 slots an iteration, so a 256-query batch reads ~256 x 330 x 400 B =
// 34 MB of rows (10 us at 3.35 TB/s) where the torch chain wrote and read
// back a (256, 2,080, 100) f32 tensor (213 MB) and sorted 2,080 ids and
// 2,090 sims a query. Measured on an H100 at that shape: 0.021 ms a call
// with 330 live slots a query, 0.070 ms with all 2,080 (its bound 0.064);
// 256 threads a CTA, or 2 rows in flight a warp, ran 1.3-1.5x slower.
//
// Design: one CTA of 512 threads a query. The CTA marks its kk old ids in
// an open-addressing table in shared memory (twice the entries it can
// hold, a CAS a probe), then inserts each live slot's id: the thread that
// places an id owns it, so a duplicate or an id already in the top-k is
// never read. Each warp scores SC_UNROLL owned rows at a time, a lane a
// 16-byte unit of each (f32 rows of d = 4 u floats; int8 rows in 4-byte
// words through __dp4a), the sum by a butterfly shuffle (every lane ends
// with the same bits, and a row's sum does not depend on the warp). Each
// entry's 64-bit key (orderable sim bits; an old-entry bit; the inverted
// position or id) orders it exactly as the torch chain's stable sort does,
// and a candidate enters the merge only where its key beats the worst old
// key (late iterations merge a few). The merge never sorts: each warp
// finds the kk-th greatest key of its slice of the entries (kk rounds of
// a warp max), the greatest of those bounds the top kk from below and
// leaves at most 16 kk entries, and each of those is written at its rank,
// the count of greater keys among them. Slots in shared arrays are taken
// one atomic a warp (`warp_slot`). The CTA reads its query's kk old entries
// before it writes the new ones, and into other tensors. Nothing of
// (Q, CB, d) or (Q, CB, kk) is written.

#include <cuda_runtime.h>

#include <cstdint>

#include "device_scope.cuh"

namespace clann {
namespace {

constexpr int SC_THREADS = 512;
constexpr int SC_WARPS = SC_THREADS / 32;
constexpr int SC_UNROLL = 4;  // rows whose loads a warp keeps in flight

struct MergeArgs {
  const void* vectors;  // (n_rows, d) float32 or int8
  long long n_rows;
  int d;
  const void* queries;      // (Q, d), the vectors' type
  const float* topk_sims;   // (Q, kk)
  const int32_t* topk_ids;  // (Q, kk)
  const int32_t* cand;      // (Q, cb)
  int cb, kk, n_sentinel, hash_log, q_bytes;
  float* out_sims;   // (Q, kk)
  int32_t* out_ids;  // (Q, kk)
};

// A row's unit of work, its loads (a row's, the query's in shared memory)
// and its multiply-add, by record type:
// float4 / float for f32 rows, a packed 4-byte word (__dp4a) / a byte for
// int8 rows.
template <bool INT8, bool VEC>
struct Rows;

template <>
struct Rows<false, true> {
  using Unit = float4;
  using Acc = float;
  static __device__ __forceinline__ Unit load(const void* p, long long i) {
    return __ldg(static_cast<const float4*>(p) + i);
  }
  static __device__ __forceinline__ Unit query(const void* s_q, int j) {
    return static_cast<const float4*>(s_q)[j];
  }
  static __device__ __forceinline__ Unit zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
  static __device__ __forceinline__ Acc madd(Acc acc, Unit v, Unit q) {
    acc = fmaf(v.x, q.x, acc);
    acc = fmaf(v.y, q.y, acc);
    acc = fmaf(v.z, q.z, acc);
    return fmaf(v.w, q.w, acc);
  }
};

template <>
struct Rows<false, false> {
  using Unit = float;
  using Acc = float;
  static __device__ __forceinline__ Unit load(const void* p, long long i) {
    return __ldg(static_cast<const float*>(p) + i);
  }
  static __device__ __forceinline__ Unit query(const void* s_q, int j) {
    return static_cast<const float*>(s_q)[j];
  }
  static __device__ __forceinline__ Unit zero() { return 0.f; }
  static __device__ __forceinline__ Acc madd(Acc acc, Unit v, Unit q) { return fmaf(v, q, acc); }
};

template <>
struct Rows<true, true> {
  using Unit = int;
  using Acc = int;
  static __device__ __forceinline__ Unit load(const void* p, long long i) {
    return __ldg(static_cast<const int*>(p) + i);
  }
  static __device__ __forceinline__ Unit query(const void* s_q, int j) {
    return static_cast<const int*>(s_q)[j];
  }
  static __device__ __forceinline__ Unit zero() { return 0; }
  static __device__ __forceinline__ Acc madd(Acc acc, Unit v, Unit q) { return __dp4a(v, q, acc); }
};

template <>
struct Rows<true, false> {
  using Unit = int;
  using Acc = int;
  static __device__ __forceinline__ Unit load(const void* p, long long i) {
    return static_cast<int>(__ldg(static_cast<const signed char*>(p) + i));
  }
  static __device__ __forceinline__ Unit query(const void* s_q, int j) {
    return static_cast<const signed char*>(s_q)[j];
  }
  static __device__ __forceinline__ Unit zero() { return 0; }
  static __device__ __forceinline__ Acc madd(Acc acc, Unit v, Unit q) { return acc + v * q; }
};

// Float bits whose unsigned order is the floats' order (-0 as +0).
__device__ __forceinline__ uint32_t order_bits(float s) {
  const uint32_t u = __float_as_uint(s == 0.0f ? 0.0f : s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_order_bits(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7fffffffu) : ~o);
}

// Inserts id >= 0 into the table of 1 << hash_log slots (-1 empty); true
// where this call placed it, false where it was there already.
__device__ __forceinline__ bool insert_id(int32_t* tab, int32_t id, int hash_log) {
  const uint32_t mask = (1u << hash_log) - 1u;
  uint32_t h = (static_cast<uint32_t>(id) * 2654435761u) >> (32 - hash_log);
  while (true) {
    const int32_t prev = atomicCAS(tab + h, -1, id);
    if (prev == -1) return true;
    if (prev == id) return false;
    h = (h + 1) & mask;
  }
}

// The slot of each lane with `take` set among *count's next slots: one
// atomic a warp, the lanes in lane order. Every lane of the warp calls it.
__device__ __forceinline__ int warp_slot(bool take, int* count, int lane) {
  const uint32_t mask = __ballot_sync(0xffffffffu, take);
  int base = 0;
  if (lane == 0 && mask) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(0xffffffffu, base, 0);
  return base + __popc(mask & ((1u << lane) - 1u));
}

// A candidate's sim from its row's dot, rounded step by step as the torch
// chain rounds it.
__device__ __forceinline__ float sim_of(float dot) {
  const float s = __fmul_rn(__fadd_rn(dot, 1.0f), 0.5f);
  return fminf(fmaxf(s, 0.0f), 1.0f);
}

__device__ __forceinline__ float sim_of(int dot) {
  // the chain's f32 scale: the double 1 / 127^2 rounded to float
  return sim_of(__fmul_rn(__int2float_rn(dot), static_cast<float>(1.0 / (127.0 * 127.0))));
}

template <bool INT8, bool VEC>
__global__ void __launch_bounds__(SC_THREADS) score_merge_kernel(const MergeArgs a) {
  using R = Rows<INT8, VEC>;
  using Unit = typename R::Unit;
  using Acc = typename R::Acc;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ unsigned long long s_floor;  // the worst old entry's key
  __shared__ unsigned long long s_thr;    // no key of the top kk is below it
  __shared__ int s_nu, s_nm, s_nt;  // owned candidates; keys in the merge; keys past s_thr
  const int q = blockIdx.x;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int kk = a.kk, cb = a.cb, H = 1 << a.hash_log;
  void* s_q = smem;  // the query: d floats or d bytes, q_bytes rounded to 16
  unsigned long long* s_key = reinterpret_cast<unsigned long long*>(smem + a.q_bytes);  // kk + cb
  int32_t* s_tab = reinterpret_cast<int32_t*>(s_key + kk + cb);  // H
  int32_t* s_uid = s_tab + H;                                   // cb: owned candidate ids
  int32_t* s_oid = s_uid + cb;                                  // kk: old ids

  if (tid == 0) {
    s_floor = ~0ull;
    s_thr = 0;
    s_nu = 0;
    s_nm = 0;
    s_nt = 0;
  }
  for (int i = tid; i < H; i += SC_THREADS) s_tab[i] = -1;
  if (INT8) {
    const signed char* qp = static_cast<const signed char*>(a.queries) + static_cast<long long>(q) * a.d;
    for (int i = tid; i < a.d; i += SC_THREADS) static_cast<signed char*>(s_q)[i] = qp[i];
  } else {
    const float* qp = static_cast<const float*>(a.queries) + static_cast<long long>(q) * a.d;
    for (int i = tid; i < a.d; i += SC_THREADS) static_cast<float*>(s_q)[i] = qp[i];
  }
  __syncthreads();

  // 1. the old entries: their keys (old-entry bit set, the inverted
  // position below it) and their ids marked in the table
  const float* osim = a.topk_sims + static_cast<long long>(q) * kk;
  const int32_t* oid = a.topk_ids + static_cast<long long>(q) * kk;
  for (int p = tid; p < kk; p += SC_THREADS) {
    const int32_t id = oid[p];
    s_oid[p] = id;
    const unsigned long long key =
        (static_cast<unsigned long long>(order_bits(osim[p])) << 32) | (0xffffffffu - p);
    s_key[p] = key;
    atomicMin(&s_floor, key);
    if (id >= 0) insert_id(s_tab, id, a.hash_log);
  }
  __syncthreads();

  // 2. the candidates: the first placement of each live id owns it
  const int32_t* cand = a.cand + static_cast<long long>(q) * cb;
  for (int i0 = warp << 5; i0 < cb; i0 += SC_THREADS) {
    const int i = i0 + lane;
    const int32_t id = i < cb ? cand[i] : -1;
    const bool own = id >= 0 && id < a.n_sentinel && insert_id(s_tab, id, a.hash_log);
    const int at = warp_slot(own, &s_nu, lane);
    if (own) s_uid[at] = id;
  }
  __syncthreads();

  // 3. score the owned rows; a row whose key beats the worst old one
  // enters the merge (old-entry bit clear, the inverted id below it)
  const int nu = s_nu;
  const unsigned long long floor_key = s_floor;
  const int units = VEC ? (a.d >> 2) : a.d;
  for (int base = warp; base < nu; base += SC_WARPS * SC_UNROLL) {
    long long row[SC_UNROLL];
    Acc acc[SC_UNROLL];
#pragma unroll
    for (int u = 0; u < SC_UNROLL; ++u) {
      const int r = base + u * SC_WARPS;
      row[u] = r < nu ? min(static_cast<long long>(s_uid[r]), a.n_rows - 1) : -1;
      acc[u] = 0;
    }
    for (int j0 = 0; j0 < units; j0 += 32) {
      const int j = j0 + lane;
      Unit v[SC_UNROLL];
#pragma unroll
      for (int u = 0; u < SC_UNROLL; ++u)
        v[u] = (row[u] >= 0 && j < units) ? R::load(a.vectors, row[u] * units + j) : R::zero();
      if (j < units) {
        const Unit qj = R::query(s_q, j);
#pragma unroll
        for (int u = 0; u < SC_UNROLL; ++u) acc[u] = R::madd(acc[u], v[u], qj);
      }
    }
    Acc mine = 0;  // lane u < SC_UNROLL keeps row u's dot
#pragma unroll
    for (int u = 0; u < SC_UNROLL; ++u) {
      Acc s = acc[u];
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
      if (lane == u) mine = s;
    }
    const int r = base + lane * SC_WARPS;
    unsigned long long key = 0;
    if (lane < SC_UNROLL && r < nu)
      key = (static_cast<unsigned long long>(order_bits(sim_of(mine))) << 32) |
            (0x7fffffffu - static_cast<uint32_t>(s_uid[r]));
    const bool enter = key > floor_key;
    const int at = warp_slot(enter, &s_nm, lane);
    if (enter) s_key[kk + at] = key;
  }
  __syncthreads();

  // 4. the top kk of the ne keys (all differ). Each warp finds the kk-th
  // greatest key of its slice; no key of the top kk lies below the
  // greatest of those, and at most SC_WARPS kk keys reach it: they go
  // where the id table was, and each is ranked by the greater keys there.
  // Why: the warp whose kk-th key is that threshold holds kk keys at or
  // above it, so the kk-th greatest key of all is too; every other warp's
  // kk-th key lies at or below it, so no slice keeps more than kk keys
  // (no warp has a kk-th key where no slice holds kk keys: thr stays 0 and
  // all ne < SC_WARPS kk keys are kept); every key above a kept one is
  // kept, so a kept key's count of greater kept keys is its rank among all.
  const int ne = kk + s_nm;
  const int per = (ne + SC_WARPS - 1) / SC_WARPS;
  const int lo = warp * per, hi = min(ne, lo + per);
  if (hi - lo >= kk) {
    unsigned long long prev = ~0ull;
    for (int t = 0; t < kk; ++t) {
      unsigned long long m = 0;
      for (int e = lo + lane; e < hi; e += 32) {
        const unsigned long long k = s_key[e];
        if (k < prev && k > m) m = k;
      }
      for (int o = 16; o; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
        m = other > m ? other : m;
      }
      prev = m;
    }
    if (lane == 0) atomicMax(&s_thr, prev);
  }
  __syncthreads();
  unsigned long long* s_top = reinterpret_cast<unsigned long long*>(s_tab);  // H / 2 >= ne
  const unsigned long long thr = s_thr;
  for (int e0 = warp << 5; e0 < ne; e0 += SC_THREADS) {
    const int e = e0 + lane;
    const unsigned long long key = e < ne ? s_key[e] : 0;
    const bool keep = e < ne && key >= thr;
    const int at = warp_slot(keep, &s_nt, lane);
    if (keep) s_top[at] = key;
  }
  __syncthreads();
  const int nt = s_nt;
  float* out_s = a.out_sims + static_cast<long long>(q) * kk;
  int32_t* out_i = a.out_ids + static_cast<long long>(q) * kk;
  for (int e = tid; e < nt; e += SC_THREADS) {
    const unsigned long long key = s_top[e];
    int rank = 0;
    for (int f = 0; f < nt; ++f) rank += s_top[f] > key;
    if (rank < kk) {
      const float s = from_order_bits(static_cast<uint32_t>(key >> 32));
      const uint32_t low = static_cast<uint32_t>(key);
      const int32_t id = (low & 0x80000000u) ? s_oid[0xffffffffu - low]
                                             : static_cast<int32_t>(0x7fffffffu - low);
      out_s[rank] = s > 0.0f ? s : 0.0f;
      out_i[rank] = s < 0.0f ? -1 : id;
    }
  }
}

template <bool INT8, bool VEC>
cudaError_t launch_merge(const MergeArgs& a, int Q, int smem, cudaStream_t stream) {
  auto* kernel = score_merge_kernel<INT8, VEC>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<Q, SC_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace
}  // namespace clann

extern "C" {

// Launches the score-and-merge on `stream` of CUDA device `device` (see the
// note above and ops/score_merge.py). Every tensor is contiguous and on
// `device`: vectors (n_rows, d) float32 (int8 = 0) or int8 (int8 = 1),
// queries (Q, d) of the same type, topk_sims (Q, kk) float32, topk_ids
// (Q, kk) int32, cand (Q, cb) int32, out_sims (Q, kk) float32 and out_ids
// (Q, kk) int32 (written; neither may be an input). The id table has
// 1 << hash_log slots, at least 2 (kk + cb); `smem` is the dynamic shared
// memory the wrapper computed for the shapes. Returns a cudaError_t code
// (0 = launched).
int clann_score_merge(const void* vectors, long long n_rows, int d, int int8,
                      const void* queries, const void* topk_sims, const void* topk_ids,
                      const void* cand, int cb, int kk, int n_sentinel, int hash_log,
                      void* out_sims, void* out_ids, int Q, int smem, int device,
                      void* stream) {
  if (!vectors || !queries || !topk_sims || !topk_ids || !cand || !out_sims || !out_ids ||
      n_rows < 1 || d < 1 || kk < 1 || cb < 0 || Q < 0 || hash_log < 1 || hash_log > 30 ||
      (1LL << hash_log) < 2LL * (kk + cb))
    return static_cast<int>(cudaErrorInvalidValue);
  if (Q == 0) return 0;
  const clann::DeviceScope scope(device);  // the caller's device again on every return
  if (scope.error() != cudaSuccess) return static_cast<int>(scope.error());
  clann::MergeArgs a;
  a.vectors = vectors;
  a.n_rows = n_rows;
  a.d = d;
  a.queries = queries;
  a.topk_sims = static_cast<const float*>(topk_sims);
  a.topk_ids = static_cast<const int32_t*>(topk_ids);
  a.cand = static_cast<const int32_t*>(cand);
  a.cb = cb;
  a.kk = kk;
  a.n_sentinel = n_sentinel;
  a.hash_log = hash_log;
  a.q_bytes = ((d * (int8 ? 1 : 4)) + 15) / 16 * 16;
  a.out_sims = static_cast<float*>(out_sims);
  a.out_ids = static_cast<int32_t*>(out_ids);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t base = reinterpret_cast<uintptr_t>(vectors);
  cudaError_t err;
  if (int8) {
    err = (d % 4 == 0 && base % 4 == 0) ? clann::launch_merge<true, true>(a, Q, smem, s)
                                        : clann::launch_merge<true, false>(a, Q, smem, s);
  } else {
    err = (d % 4 == 0 && base % 16 == 0) ? clann::launch_merge<false, true>(a, Q, smem, s)
                                         : clann::launch_merge<false, false>(a, Q, smem, s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
