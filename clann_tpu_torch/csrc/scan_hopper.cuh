// Hopper main loop of the dense scan kernels K1, K2 and K3 (sm_90a).
//
// All three score bf16 base rows against bf16 queries with f32
// accumulation and reduce each bin (per_bin consecutive base rows) to one
// winner per query, without writing a score to device memory. The epilogue
// policy (a template parameter) says what the winner is:
//
// - PackedKey (K1, K3): one int32,
//     key = (bitcast<int32>(score [+ 3.0 unless biased]) & ~(per_bin - 1))
//           | row_in_bin,   winner = max key over the bin;
// - ArgmaxKey (K2): the exact f32 max of the score and the lowest row
//   reaching it (-0.0 counted as +0.0), carried as two int32 registers:
//   the order-preserving integer image of the float and the row.
//
// A launch covers n_tiles independent tiles. Tile t holds the queries
// [t * tile_q, (t + 1) * tile_q) and scans the tile_rows base rows starting
// at tile_block[t] * tile_rows (row 0 when tile_block is null: K1 and K2
// are one tile over the whole base). PackedKey writes tile t's winners to
// rows [t * tile_bins, (t + 1) * tile_bins) of the (n_tiles * tile_bins,
// tile_q) output; ArgmaxKey (one tile) writes query-major (tile_q,
// tile_bins) values and rows.
//
// What bounds it: at the main path's shape (1,212,416 rows x dpad 128 x
// 2,048 queries) the product is 6.4e11 FLOP, 0.64 ms at the bf16 dense peak,
// against 0.1 ms of DRAM traffic; after the product, about two integer
// operations per score (mask-or, max) form and reduce K1's keys, and two
// and a half K2's winners (max, then compare and select for the lowest
// row). So the design keeps the tensor cores fed and hides the key
// arithmetic behind them (K2's epilogue, on the int32 pipe, only partly):
//
// - Persistent grid: one CTA per SM walks a static list of work items
//   (tile, query group of 256, item_rows base rows). Items are numbered
//   query group fastest, so the CTAs running together read the same base
//   rows (from DRAM about once, then from L2), and the grid is a multiple of
//   the query groups per tile, so a CTA of K1 keeps one query group for its
//   whole life.
// - Warp specialisation: warpgroup 2 is the producer (one thread issues TMA
//   loads; setmaxnreg gives its registers away), warpgroups 0 and 1 consume.
//   Base tiles of 64 rows x 64 dims (8 KB, 128-byte swizzle) flow through a
//   ring of full / empty mbarriers. A query group stays resident in shared
//   memory while dpad <= 256 (two buffers up to dpad 128, so the next
//   group's load overlaps the current one); beyond, each ring stage also
//   carries the group's matching 64-dim query slice.
// - wgmma with queries on M and base rows on N: each consumer warpgroup
//   owns 128 queries (two m64 blocks) and issues m64n64k16 (bf16 in, f32
//   accumulate). Up to dpad 128 the queries' operand sits in registers,
//   loaded once per query group, so the tensor cores read only the base
//   tile from shared memory (with both operands there, the m64n64 product
//   asks for all of the SM's shared-memory bandwidth); beyond, both come
//   from shared memory. The accumulators are double-buffered: the product
//   of the next tile runs on the tensor cores while the same warps turn the
//   previous tile into winners.
// - In the accumulator layout a thread holds, for each of its 4 queries,
//   16 of a tile's 64 rows (pairs of neighbours), and the 4 lanes of a quad
//   hold all 64. So a bin max is a register max over the thread's columns,
//   kept across the tiles of a bin, plus two shuffles in the quad at the
//   bin's end. `biased` is a
//   template parameter: the main paths add nothing per score. K2 walks a
//   thread's columns in ascending row order and replaces its winner only on
//   a strictly greater value, so ties keep the lower row; the quad
//   shuffles compare (value, then row). All of it is integer arithmetic on
//   the accumulators' bits: no float compare or move touches them.
// - K3 skips dead work: an item whose query group holds no live slot (live
//   slots are a prefix of each tile, tile_live[t] of them), whose block is
//   outside the base, or whose rows all lie past n_pad, loads and computes
//   nothing and writes the winner that zero scores give, (bitcast(0 +
//   shift) & ~(per_bin - 1)) | (per_bin - 1), which is what the plain
//   version computes there.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>
#include <string.h>

#include "sm90_async.cuh"

namespace clann {
namespace hopper {
// Internal linkage: each .cu is compiled on its own and keeps its own
// instances of the kernel templates.
namespace {

constexpr int ROWS = 64;                        // base rows per tile (wgmma N)
constexpr int KS = 64;                          // dims per K slice: one 128-byte swizzle row
constexpr int QG = 256;                         // queries per group: 2 warpgroups x 2 m64 blocks
constexpr int THREADS = 384;                    // consumers 0-255, producer 256-383
constexpr int CONSUMER_WARPS = 8;
constexpr int BASE_STAGE = ROWS * KS * 2;       // 8 KB
constexpr int Q_SLICE = QG * KS * 2;            // 32 KB
constexpr int RESIDENT_MAX_NK = 4;              // queries resident while dpad <= 256
constexpr int RESIDENT_STAGES = 8;              // >= 2 tiles of RESIDENT_MAX_NK slices
constexpr int STREAM_STAGES = 5;
constexpr int MAX_PER_BIN = 16384;

struct Params {
  int32_t* out;               // packed keys (K1, K3) or rows (K2)
  int32_t* vals;              // K2: the f32 values' bits; else null
  const int32_t* tile_block;  // (n_tiles,) or null (one tile at row 0)
  const int32_t* tile_live;   // (n_tiles,) live slots per tile, or null (all live)
  long long n_pad;
  int tile_rows;
  int n_blocks;               // ceil(n_pad / tile_rows): block ids with rows
  int n_items;
  int tile_bins;              // tile_rows / per_bin
  int tile_q;
  int nk;                     // dpad / KS
  int per_bin;
  int bin_shift;              // log2(per_bin)
  int item_rows;              // whole bins, a multiple of ROWS unless one item spans the tile
  int row_chunks;             // items along a tile's rows
  int n_qg;                   // query groups per tile
  int n_qbuf;                 // resident query buffers (1 or 2)
  int stages;
};

// (32-bit index arithmetic throughout: a 64-bit division is a call, and a
// call in the kernel makes ptxas serialise the wgmma.)
struct Item {
  int tile;
  int blk;
  int row0;  // first row, relative to the tile's block
  int rows;
  int qg;
  bool live;
};

__device__ __forceinline__ Item get_item(const Params& p, int i) {
  Item it;
  const int rest = i / p.n_qg;
  it.qg = i - rest * p.n_qg;
  it.tile = rest / p.row_chunks;
  it.row0 = (rest - it.tile * p.row_chunks) * p.item_rows;
  it.rows = min(p.item_rows, p.tile_rows - it.row0);
  it.blk = p.tile_block ? __ldg(p.tile_block + it.tile) : 0;
  it.live = it.blk >= 0 && it.blk < p.n_blocks &&
            static_cast<long long>(it.blk) * p.tile_rows + it.row0 < p.n_pad;
  if (p.tile_live) it.live = it.live && __ldg(p.tile_live + it.tile) > it.qg * QG;
  return it;
}

// A (64-dim x box_rows) box at (col, row) of `map` into shared memory; the
// box's bytes complete a transaction on `bar`. Out-of-bounds rows read 0.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int col, int row,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_u32(bar))
      : "memory");
}

// Shared-memory matrix descriptor of a K-major tile whose rows are 128
// bytes, 128-byte swizzled in 8-row (1,024-byte) atoms, as TMA writes it.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// The accumulators are f32 values held in 32-bit integer registers: the
// epilogue works on their bits, and keeping one register type end to end
// spares the conversions between the two that, placed inside the wgmma
// pipeline, would make ptxas serialise it.
using Acc = uint32_t[2][32];

// Keeps the compiler from moving accesses of the accumulators across the
// asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_acc(Acc& acc) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int r = 0; r < 32; ++r) asm volatile("" : "+r"(acc[h][r])::"memory");
}

// d (+)= A(64 x 16, desc a) * B(16 x 64, desc b)^T, f32 accumulate.
__device__ __forceinline__ void wgmma_m64n64k16(uint32_t (&d)[32], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}

// The same product with A (64 x 16) from registers: the m16n8k16 A
// fragment of each warp's 16 rows.
__device__ __forceinline__ void wgmma_m64n64k16_rs(uint32_t (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]),
        "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),
        "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]), "+r"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The queries' operand lives in registers while its fragments fit beside
// two accumulators (dpad <= 128: 32 registers a slice); the wgmma then
// reads only the base tile from shared memory, half the bytes.
template <int NK>
constexpr bool kRegA = NK >= 1 && NK <= 2;
template <int NK>
using QFrag = uint32_t[kRegA<NK> ? NK : 1][2][KS / 16][4];

// This thread's A fragments of its warpgroup's 128 queries, from the
// resident query buffer q (NK slices, 128-byte swizzled): fragment
// [ks][m][kk] holds rows wg*128 + 64m + 16w + lane/4 (+8) and dims
// 64ks + 16kk + 2(lane%4) (+1, +8, +9).
template <int NK>
__device__ __forceinline__ void load_qfrag(QFrag<NK>& af, const uint8_t* q, int wg) {
  if constexpr (kRegA<NK>) {
    const int lane = threadIdx.x & 31;
    const int w = (threadIdx.x >> 5) & 3;
    const int r = wg * 128 + w * 16 + (lane >> 2);  // m = 0, rows r and r + 8
    const int sw = r & 7;                            // (r + 8) & 7 too
#pragma unroll
    for (int ks = 0; ks < NK; ++ks)
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int kk = 0; kk < KS / 16; ++kk)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int row = r + 64 * m + 8 * (i & 1);
            const int chunk = (2 * kk + (i >> 1)) ^ sw;
            af[ks][m][kk][i] = *reinterpret_cast<const uint32_t*>(
                q + size_t(ks) * Q_SLICE + row * 128 + chunk * 16 + 4 * (lane & 3));
          }
  }
}

// Shared memory: [query buffers][ring of stages][mbarriers], 1,024-aligned.
struct Smem {
  uint8_t* qbuf;   // n_qbuf x nk x Q_SLICE (resident) or unused
  uint8_t* ring;   // stages x stage_bytes: base slice [+ query slice]
  uint64_t* full;
  uint64_t* empty;
  uint64_t* qfull;   // [2]
  uint64_t* qempty;  // [2]
  int stage_bytes;
};

inline __host__ __device__ size_t smem_bytes(bool stream, int nk, int n_qbuf, int stages) {
  const size_t stage = stream ? BASE_STAGE + Q_SLICE : BASE_STAGE;
  const size_t qbytes = stream ? 0 : size_t(n_qbuf) * nk * Q_SLICE;
  return 1024 + qbytes + stages * stage + (2 * stages + 4) * sizeof(uint64_t);
}

// Position of a consumer or the producer in the ring.
struct Ring {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1;
    }
  }
};

// A bin's winner so far: the key (PackedKey; r unused) or the
// order-preserving image of the score and its row in the bin (ArgmaxKey).
struct Win {
  int v;
  int r;
};

// The score's bits, shifted by +3.0 unless the bias column carries it.
template <bool BIASED>
__device__ __forceinline__ int key_bits(uint32_t v) {
  return BIASED ? static_cast<int>(v) : __float_as_int(__uint_as_float(v) + 3.0f);
}

// Epilogue of K1 and K3: the row rides in the low bits of one int32 key,
// so every reduction is a max.
template <bool BIASED>
struct PackedKey {
  static constexpr bool kRow = false;
  __device__ static __forceinline__ Win make(uint32_t acc, int sub, int keep) {
    return {(key_bits<BIASED>(acc) & keep) | sub, 0};
  }
  // the winners of one tile's columns (rows sub + 8j + e) in each slot (h, s)
  __device__ static __forceinline__ void tile(const Acc& acc, int sub, int keep,
                                              Win (&tw)[2][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        int k = INT_MIN;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) k = max(k, make(acc[h][4 * j + 2 * s + e], sub + 8 * j + e, keep).v);
        tw[h][s] = {k, 0};
      }
  }
  // x comes after w in row order (within a thread) / anywhere (across lanes)
  __device__ static __forceinline__ void scan(Win& w, Win x) { w.v = max(w.v, x.v); }
  __device__ static __forceinline__ void merge(Win& w, Win x) { w.v = max(w.v, x.v); }
  // what zero scores give (an item that scans nothing)
  __device__ static __forceinline__ Win zero(int per_bin) {
    return {(key_bits<BIASED>(0u) & ~(per_bin - 1)) | (per_bin - 1), 0};
  }
  __device__ static __forceinline__ void put(const Params& p, const Item& it, int bin, int q,
                                             Win w) {
    p.out[(static_cast<long long>(it.tile) * p.tile_bins + bin) * p.tile_q + q] = w.v;
  }
};

// Epilogue of K2: the exact max and the lowest row reaching it. The value
// is carried as an int32 that orders like the float, -0.0 and +0.0 both 0:
// m = bits & 0x7FFFFFFF, image = m for a positive sign, -m for a negative.
struct ArgmaxKey {
  static constexpr bool kRow = true;
  __device__ static __forceinline__ int image(uint32_t acc) {
    const int b = static_cast<int>(acc);
    const int s = b >> 31;
    return ((b & 0x7FFFFFFF) ^ s) - s;
  }
  __device__ static __forceinline__ Win make(uint32_t acc, int sub, int) { return {image(acc), sub}; }
  // The tile's winner per slot, compared on the images (IMAGE) or on the raw
  // bits: as int32 they order the positive floats and put every other value
  // below them, one operation less per score. The max first (three-input
  // integer max), then the lowest column reaching it, scanned from the top.
  template <bool IMAGE>
  __device__ static __forceinline__ void tile_scan(const Acc& acc, int sub, Win (&tw)[2][2]) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        int x[16];  // column c = 2j + e: row sub + 8j + e
#pragma unroll
        for (int c = 0; c < 16; ++c) {
          const uint32_t a = acc[h][4 * (c >> 1) + 2 * s + (c & 1)];
          x[c] = IMAGE ? image(a) : static_cast<int>(a);
        }
        int m = x[0];
#pragma unroll
        for (int c = 1; c < 16; ++c) m = max(m, x[c]);
        int r = 8 * 7 + 1;
#pragma unroll
        for (int c = 14; c >= 0; --c)
          if (x[c] == m) r = 8 * (c >> 1) + (c & 1);
        tw[h][s] = {m, sub + r};
      }
  }
  // Nearly every tile of real data has a positive winner in every slot:
  // then the raw bits are the images and suffice; a warp with any other
  // winner redoes the tile on the images.
  __device__ static __forceinline__ void tile(const Acc& acc, int sub, int, Win (&tw)[2][2]) {
    tile_scan<false>(acc, sub, tw);
    const bool pos = tw[0][0].v > 0 && tw[0][1].v > 0 && tw[1][0].v > 0 && tw[1][1].v > 0;
    if (!__all_sync(0xffffffffu, pos)) tile_scan<true>(acc, sub, tw);
  }
  // rows ascend within a thread: only a strictly greater value replaces
  __device__ static __forceinline__ void scan(Win& w, Win x) {
    if (x.v > w.v) w = x;
  }
  __device__ static __forceinline__ void merge(Win& w, Win x) {
    if (x.v > w.v || (x.v == w.v && x.r < w.r)) w = x;
  }
  __device__ static __forceinline__ Win zero(int) { return {0, 0}; }
  // query-major (tile_q, tile_bins) values (f32 bits) and global rows (one
  // tile at block 0)
  __device__ static __forceinline__ void put(const Params& p, const Item& it, int bin, int q,
                                             Win w) {
    const long long at = (static_cast<long long>(it.tile) * p.tile_q + q) * p.tile_bins + bin;
    p.vals[at] = w.v >= 0 ? w.v : (-w.v | INT_MIN);
    p.out[at] = (bin << p.bin_shift) + w.r;
  }
};

template <class E>
__device__ __forceinline__ Win shfl_xor(Win w, int mask) {
  return {__shfl_xor_sync(0xffffffffu, w.v, mask),
          E::kRow ? __shfl_xor_sync(0xffffffffu, w.r, mask) : 0};
}

template <class E>
__device__ __forceinline__ void put(const Params& p, const Item& it, int bin, int q_loc, Win w) {
  const int q = it.qg * QG + q_loc;
  if (q < p.tile_q && bin < p.tile_bins) E::put(p, it, bin, q, w);
}

// The winners of an item that scans nothing: every score is 0.
template <class E>
__device__ void write_dead(const Params& p, const Item& it, int wg) {
  const Win w = E::zero(p.per_bin);
  const int bin0 = it.row0 >> p.bin_shift;
  const int nb = (it.rows + p.per_bin - 1) >> p.bin_shift;
  for (int i = threadIdx.x % 128; i < nb * 128; i += 128)
    put<E>(p, it, bin0 + i / 128, wg * 128 + i % 128, w);
}

// Turns one accumulated tile (rows r0 .. r0 + 63 of the item's tile-of-rows
// for this warpgroup's 128 queries) into winners and writes every bin that
// ends in it. acc[h][4j + 2s + e] holds query wg*128 + 64h + 16w + lane/4 +
// 8s against row r0 + 8j + 2(lane%4) + e. run[h][s] carries the winner of a
// bin across tiles when per_bin >= 64.
template <class E>
__device__ __forceinline__ void epilogue(const Acc& acc, const Params& p, const Item& it,
                                         int t, int wg, Win (&run)[2][2]) {
  const int lane = threadIdx.x & 31;
  const int w = (threadIdx.x >> 5) & 3;
  const int quad = lane & 3;
  const int per_bin = p.per_bin;
  const int keep = ~(per_bin - 1);
  const int r0 = it.row0 + t * ROWS;
  const int q0 = wg * 128 + w * 16 + (lane >> 2);  // query of (h = 0, s = 0)
  if (per_bin >= ROWS) {
    const int in_bin = r0 & (per_bin - 1);
    if (in_bin == 0) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int s = 0; s < 2; ++s) run[h][s] = {INT_MIN, 0};
    }
    Win tw[2][2];
    E::tile(acc, in_bin + 2 * quad, keep, tw);
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int s = 0; s < 2; ++s) E::scan(run[h][s], tw[h][s]);
    if (in_bin + ROWS == per_bin) {  // the bin ends in this tile
      // Reduce over the quad; lane quad then writes the winner of slot
      // (hk, sk). The packed key reduces each slot on its own (four short
      // independent chains: the next tile's wgmma waits on them); K2's
      // two-register winner, whose epilogue is bound by integer work, takes
      // a butterfly with a third of the shuffles and merges: across lane
      // bit 0 a lane keeps slot sk of both h and sends the other, across
      // bit 1 it keeps hk.
      const int hk = quad >> 1, sk = quad & 1;
      Win x;
      if constexpr (E::kRow) {
        Win w[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          w[h] = sk ? run[h][1] : run[h][0];
          E::merge(w[h], shfl_xor<E>(sk ? run[h][0] : run[h][1], 1));
        }
        x = hk ? w[1] : w[0];
        E::merge(x, shfl_xor<E>(hk ? w[0] : w[1], 2));
      } else {
        Win k[2][2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int s = 0; s < 2; ++s) {
            k[h][s] = run[h][s];
            E::merge(k[h][s], shfl_xor<E>(k[h][s], 1));
            E::merge(k[h][s], shfl_xor<E>(k[h][s], 2));
          }
        x = hk ? (sk ? k[1][1] : k[1][0]) : (sk ? k[0][1] : k[0][0]);
      }
      put<E>(p, it, r0 >> p.bin_shift, q0 + 64 * hk + 8 * sk, x);
    }
    return;
  }
  // per_bin < 64: whole bins inside the tile
  const int bin0 = r0 >> p.bin_shift;
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int q = q0 + 64 * h + 8 * s;
      Win acc_run = {INT_MIN, 0};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * quad;  // column of e = 0
        Win k = E::make(acc[h][4 * j + 2 * s], c & (per_bin - 1), keep);
        const Win k1 = E::make(acc[h][4 * j + 2 * s + 1], (c + 1) & (per_bin - 1), keep);
        if (per_bin == 1) {
          put<E>(p, it, bin0 + c, q, k);
          put<E>(p, it, bin0 + c + 1, q, k1);
          continue;
        }
        E::scan(k, k1);
        if (per_bin == 2) {
          put<E>(p, it, bin0 + c / 2, q, k);
          continue;
        }
        if (per_bin == 4) {
          E::merge(k, shfl_xor<E>(k, 1));
          if ((quad & 1) == 0) put<E>(p, it, bin0 + c / 4, q, k);
          continue;
        }
        // per_bin 8, 16 or 32: per_bin / 8 chunks j per bin, 4 lanes per chunk
        if (((8 * j) & (per_bin - 1)) == 0)
          acc_run = k;
        else
          E::scan(acc_run, k);
        if (((8 * j + 8) & (per_bin - 1)) == 0) {
          Win x = acc_run;
          E::merge(x, shfl_xor<E>(x, 1));
          E::merge(x, shfl_xor<E>(x, 2));
          if (quad == 0) put<E>(p, it, bin0 + ((8 * j) >> p.bin_shift), q, x);
        }
      }
    }
}

// State of a consumer warpgroup as it walks its items.
struct Walk {
  int i;  // current item
  Item it;
  int t = 0;      // current tile of the item
  int tiles = 0;  // tiles of the item
  Ring ring;      // next stage to consume
  int rel = 0;    // next stage to release
  int qloads = 0;
  int qkey = -1;
  int qb = 0;
};

// Moves to the next tile of a live item; writes the winners of the dead
// items passed on the way. False when the CTA has no tile left.
template <class E>
__device__ __forceinline__ bool next_tile(const Params& p, Walk& wk, int wg) {
  if (++wk.t < wk.tiles) return true;
  for (wk.i += static_cast<int>(gridDim.x); wk.i < p.n_items; wk.i += static_cast<int>(gridDim.x)) {
    wk.it = get_item(p, wk.i);
    if (wk.it.live) {
      wk.t = 0;
      wk.tiles = (wk.it.rows + ROWS - 1) / ROWS;
      return true;
    }
    write_dead<E>(p, wk.it, wg);
  }
  return false;
}

// Releases n stages to the producer: one arrival per consumer warp.
__device__ __forceinline__ void release(const Params& p, const Smem& sm, Walk& wk, int n) {
  __syncwarp();
  for (int k = 0; k < n; ++k) {
    if ((threadIdx.x & 31) == 0) mbar_arrive(sm.empty + wk.rel);
    if (++wk.rel == p.stages) wk.rel = 0;
  }
}

__device__ __forceinline__ int query_key(const Params& p, const Item& it) {
  return it.tile * p.n_qg + it.qg;
}

// Waits for the current item's query group (resident mode).
__device__ __forceinline__ void bind_query(const Params& p, const Smem& sm, Walk& wk) {
  wk.qb = wk.qloads % p.n_qbuf;
  mbar_wait(sm.qfull + wk.qb, (wk.qloads / p.n_qbuf) & 1);
  ++wk.qloads;
  wk.qkey = query_key(p, wk.it);
}

// Issues the wgmma of one slice: this warpgroup's 128 queries (A, two m64
// blocks at a_addr) against the stage's 64 base rows (B).
__device__ __forceinline__ void mma_slice(Acc& acc, uint32_t a_addr, uint32_t b_addr,
                                          int first) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < KS / 16; ++kk) {
    const int scale = (first && kk == 0) ? 0 : 1;
    const uint64_t b = sw128_desc(b_addr + kk * 32);
    wgmma_m64n64k16(acc[0], sw128_desc(a_addr + kk * 32), b, scale);
    wgmma_m64n64k16(acc[1], sw128_desc(a_addr + 64 * 128 + kk * 32), b, scale);
  }
}

// All NK slices of the current tile against the resident query group
// (registers af, or the query buffer), one commit group (unrolled: no loop
// carries the accumulators inside the wgmma pipeline).
template <int NK>
__device__ __forceinline__ void mma_tile(Acc& acc, const QFrag<NK>& af, const Params& p,
                                         const Smem& sm, Walk& wk, int wg) {
  const uint8_t* q = sm.qbuf + size_t(wk.qb) * NK * Q_SLICE + wg * 128 * 128;
#pragma unroll
  for (int ks = 0; ks < NK; ++ks) {
    mbar_wait(sm.full + wk.ring.stage, wk.ring.phase);
    const uint32_t b_addr = smem_u32(sm.ring + size_t(wk.ring.stage) * sm.stage_bytes);
    if constexpr (kRegA<NK>) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KS / 16; ++kk) {
        const int scale = (ks == 0 && kk == 0) ? 0 : 1;
        const uint64_t b = sw128_desc(b_addr + kk * 32);
        wgmma_m64n64k16_rs(acc[0], af[ks][0][kk], b, scale);
        wgmma_m64n64k16_rs(acc[1], af[ks][1][kk], b, scale);
      }
    } else {
      mma_slice(acc, smem_u32(q + size_t(ks) * Q_SLICE), b_addr, ks == 0);
    }
    wk.ring.next(p.stages);
  }
  wgmma_commit();
}

// Waits for the current item's query group and, with the register
// operand, loads its fragments (no wgmma may be reading the old ones).
template <int NK>
__device__ __forceinline__ void bind_query_frag(QFrag<NK>& af, const Params& p, const Smem& sm,
                                                Walk& wk, int wg) {
  bind_query(p, sm, wk);
  load_qfrag<NK>(af, sm.qbuf + size_t(wk.qb) * NK * Q_SLICE, wg);
}

// One step of the resident pipeline: the tile in `cur` is in flight; issue
// the next tile into `nxt`, retire `cur` and turn it into winners while `nxt`
// runs. False when there was no next tile.
template <class E, int NK>
__device__ __forceinline__ bool step(Acc& cur, Acc& nxt, QFrag<NK>& af, const Params& p,
                                     const Smem& sm, Walk& wk, int wg, Win (&run)[2][2]) {
  const Item cit = wk.it;
  const int ct = wk.t;
  const int cqb = wk.qb;
  const bool more = next_tile<E>(p, wk, wg);
  if (more && query_key(p, wk.it) != wk.qkey) {
    // a new query group: retire everything that reads the old one first
    wgmma_wait<0>();
    fence_acc(cur);
    release(p, sm, wk, NK);
    __syncwarp();
    if ((threadIdx.x & 31) == 0) mbar_arrive(sm.qempty + cqb);
    bind_query_frag<NK>(af, p, sm, wk, wg);
    mma_tile<NK>(nxt, af, p, sm, wk, wg);
  } else if (more) {
    mma_tile<NK>(nxt, af, p, sm, wk, wg);
    wgmma_wait<1>();
    fence_acc(cur);
    release(p, sm, wk, NK);
  } else {
    wgmma_wait<0>();
    fence_acc(cur);
    release(p, sm, wk, NK);
  }
  epilogue<E>(cur, p, cit, ct, wg, run);
  return more;
}

// NK: dpad / 64 when the queries are resident (1-4), 0 when they stream
// with the ring (any dpad, read from p.nk).
template <class E, bool STREAM, int NK>
__global__ void __launch_bounds__(THREADS, 1)
hopper_scan_kernel(const __grid_constant__ CUtensorMap tm_base,
                   const __grid_constant__ CUtensorMap tm_q, const Params p) {
  extern __shared__ __align__(1024) uint8_t packed_smem[];
  uint8_t* base = reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(packed_smem) + 1023) &
                                             ~uintptr_t(1023));
  Smem sm;
  sm.stage_bytes = STREAM ? BASE_STAGE + Q_SLICE : BASE_STAGE;
  sm.qbuf = base;
  sm.ring = STREAM ? base : base + size_t(p.n_qbuf) * p.nk * Q_SLICE;
  sm.full = reinterpret_cast<uint64_t*>(sm.ring + size_t(p.stages) * sm.stage_bytes);
  sm.empty = sm.full + p.stages;
  sm.qfull = sm.empty + p.stages;
  sm.qempty = sm.qfull + 2;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(sm.full + s, 1);
      mbar_init(sm.empty + s, CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(sm.qfull + b, 1);
      mbar_init(sm.qempty + b, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread issues every load, in the consumers' order
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      Ring ring;
      int qkey = -1;
      int qloads = 0;
      for (int i = blockIdx.x; i < p.n_items; i += gridDim.x) {
        const Item it = get_item(p, i);
        if (!it.live) continue;
        const int qrow = it.tile * p.tile_q + it.qg * QG;
        if (!STREAM && query_key(p, it) != qkey) {
          const int b = qloads % p.n_qbuf;
          const int use = qloads / p.n_qbuf;
          if (use > 0) mbar_wait(sm.qempty + b, (use - 1) & 1);
          mbar_expect_tx(sm.qfull + b, p.nk * Q_SLICE);
          for (int ks = 0; ks < p.nk; ++ks)
            tma_load(sm.qbuf + (size_t(b) * p.nk + ks) * Q_SLICE, &tm_q, ks * KS, qrow,
                     sm.qfull + b);
          ++qloads;
          qkey = query_key(p, it);
        }
        const int row = it.blk * p.tile_rows + it.row0;
        const int tiles = (it.rows + ROWS - 1) / ROWS;
        for (int t = 0; t < tiles; ++t)
          for (int ks = 0; ks < p.nk; ++ks) {
            mbar_wait(sm.empty + ring.stage, ring.phase ^ 1);
            uint8_t* st = sm.ring + size_t(ring.stage) * sm.stage_bytes;
            mbar_expect_tx(sm.full + ring.stage, sm.stage_bytes);
            tma_load(st, &tm_base, ks * KS, row + t * ROWS, sm.full + ring.stage);
            if (STREAM) tma_load(st + BASE_STAGE, &tm_q, ks * KS, qrow, sm.full + ring.stage);
            ring.next(p.stages);
          }
      }
    }
  } else {
    // ---- consumers: warpgroups 0 and 1, 128 queries each
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    Walk wk;
    wk.i = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
    Win run[2][2] = {};
    Acc acc0, acc1;
    if constexpr (!STREAM) {
      QFrag<NK> af;
      if (!next_tile<E>(p, wk, wg)) return;
      bind_query_frag<NK>(af, p, sm, wk, wg);
      mma_tile<NK>(acc0, af, p, sm, wk, wg);
      while (step<E, NK>(acc0, acc1, af, p, sm, wk, wg, run) &&
             step<E, NK>(acc1, acc0, af, p, sm, wk, wg, run)) {
      }
    } else {
      // queries arrive with each slice: one tile at a time, each slice
      // released as soon as the wgmma reading it has retired
      while (next_tile<E>(p, wk, wg)) {
        for (int ks = 0; ks < p.nk; ++ks) {
          mbar_wait(sm.full + wk.ring.stage, wk.ring.phase);
          const uint8_t* st = sm.ring + size_t(wk.ring.stage) * sm.stage_bytes;
          mma_slice(acc0, smem_u32(st + BASE_STAGE + wg * 128 * 128), smem_u32(st), ks == 0);
          wgmma_commit();
          wk.ring.next(p.stages);
          if (ks > 0) {
            wgmma_wait<1>();
            release(p, sm, wk, 1);
          }
        }
        wgmma_wait<0>();
        fence_acc(acc0);
        release(p, sm, wk, 1);
        epilogue<E>(acc0, p, wk.it, wk.t, wg, run);
      }
    }
  }
}

// cuTensorMapEncodeTiled, looked up in libcuda through the runtime (the
// library does not link it).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                                              &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A (rows, dpad) bf16 row-major tensor read in boxes of 64 dims x box_rows
// rows with the 128-byte swizzle; rows past the end read as 0.
inline bool make_map(CUtensorMap* map, const void* ptr, long long rows, int dpad, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dpad), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dpad) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(KS), static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What one launch scans; see the file comment.
struct Launch {
  const void* base;         // (n_pad, dpad) bf16
  const void* queries;      // (n_tiles * tile_q, dpad) bf16
  const int32_t* tile_block;
  const int32_t* tile_live;
  int32_t* out;             // see Params
  int32_t* vals;
  long long n_pad;
  long long tile_rows;
  long long n_tiles;
  int tile_q;
  int dpad;
  int per_bin;
  int min_item_rows;        // rows per work item at least (whole bins)
};

template <class E, bool STREAM, int NK>
int launch_kernel(const CUtensorMap& tm_base, const CUtensorMap& tm_q, const Params& p, int grid,
                  size_t smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(hopper_scan_kernel<E, STREAM, NK>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  hopper_scan_kernel<E, STREAM, NK><<<grid, THREADS, smem, stream>>>(tm_base, tm_q, p);
  return static_cast<int>(cudaGetLastError());
}

// Checks a launch, builds its tensor maps and work list and launches it on
// `stream` of CUDA device `device`. Returns a cudaError_t code (0 =
// launched).
template <class E>
int launch_scan(const Launch& L, int device, void* stream) {
  const int P = L.per_bin;
  if (L.dpad <= 0 || L.dpad % KS != 0 || P < 1 || P > MAX_PER_BIN || (P & (P - 1)) != 0 ||
      L.n_pad < 0 || L.tile_rows <= 0 || L.tile_q < 0 || L.n_tiles < 0 || L.tile_rows % P != 0 ||
      L.min_item_rows < ROWS || L.min_item_rows % ROWS != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  // ArgmaxKey writes the rows of one tile at block 0 (K2), beside its values
  if (E::kRow && (L.tile_block != nullptr || L.n_tiles > 1 || L.vals == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // TMA coordinates are int32: every base row a tile can reach and every
  // query row of a group must fit
  const long long n_blocks = L.tile_block ? (L.n_pad + L.tile_rows - 1) / L.tile_rows : 1;
  const long long q_rows = L.n_tiles * static_cast<long long>(L.tile_q);
  if (n_blocks * L.tile_rows + ROWS > INT_MAX || q_rows + QG > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  if (L.n_tiles == 0 || L.tile_q == 0) return 0;

  long long item_rows = P > L.min_item_rows ? P : L.min_item_rows;
  const long long tile_rows_up = (L.tile_rows + ROWS - 1) / ROWS * ROWS;
  if (item_rows > tile_rows_up) item_rows = tile_rows_up;  // a multiple of P (P | tile_rows)
  const long long row_chunks = (L.tile_rows + item_rows - 1) / item_rows;
  const long long n_qg = (L.tile_q + QG - 1) / QG;
  const long long n_items = L.n_tiles * row_chunks * n_qg;
  if (n_items > INT_MAX || L.n_tiles * n_qg > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);

  Params p;
  p.out = L.out;
  p.vals = L.vals;
  p.tile_block = L.tile_block;
  p.tile_live = L.tile_live;
  p.n_pad = L.n_pad;
  p.tile_rows = static_cast<int>(L.tile_rows);
  p.n_blocks = static_cast<int>(n_blocks);
  p.tile_q = L.tile_q;
  p.nk = L.dpad / KS;
  p.per_bin = P;
  p.bin_shift = 0;
  while ((1 << p.bin_shift) < P) ++p.bin_shift;
  p.item_rows = static_cast<int>(item_rows);
  p.row_chunks = static_cast<int>(row_chunks);
  p.n_qg = static_cast<int>(n_qg);
  p.n_items = static_cast<int>(n_items);
  p.tile_bins = static_cast<int>(L.tile_rows / P);
  const bool stream_q = p.nk > RESIDENT_MAX_NK;
  p.n_qbuf = p.nk <= 2 ? 2 : 1;
  p.stages = stream_q ? STREAM_STAGES : RESIDENT_STAGES;
  const size_t smem = smem_bytes(stream_q, p.nk, p.n_qbuf, p.stages);

  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // a multiple of the query groups per tile, so a CTA keeps its group
  long long grid = p.n_qg <= sms ? (sms / p.n_qg) * p.n_qg : sms;
  if (grid > p.n_items) grid = p.n_items;

  CUtensorMap tm_base, tm_q;
  memset(&tm_base, 0, sizeof(tm_base));
  memset(&tm_q, 0, sizeof(tm_q));
  if ((L.n_pad > 0 && !make_map(&tm_base, L.base, L.n_pad, L.dpad, ROWS)) ||
      !make_map(&tm_q, L.queries, q_rows, L.dpad, QG))
    return static_cast<int>(cudaErrorInvalidValue);

  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int g = static_cast<int>(grid);
  switch (stream_q ? 0 : p.nk) {
    case 1: return launch_kernel<E, false, 1>(tm_base, tm_q, p, g, smem, s);
    case 2: return launch_kernel<E, false, 2>(tm_base, tm_q, p, g, smem, s);
    case 3: return launch_kernel<E, false, 3>(tm_base, tm_q, p, g, smem, s);
    case 4: return launch_kernel<E, false, 4>(tm_base, tm_q, p, g, smem, s);
    default: return launch_kernel<E, true, 0>(tm_base, tm_q, p, g, smem, s);
  }
}

}  // namespace
}  // namespace hopper
}  // namespace clann
