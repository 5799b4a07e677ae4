// Block-probed scan candidate kernel (K3) for NVIDIA Hopper (sm_90a).
//
// Replaces the pallas_call in clann_tpu/ops/pallas/block_scan.py::
// block_scan_topk_e2e (its `wrapped` body runs _scan_kernel_packed with
// biased=True on one (query tile, base block) pair per grid step). The
// (query, block) pairs of a batch are sorted by block and cut into tiles of
// q_tile query slots; tile t holds the pre-gathered bf16 query rows
// [t * q_tile, (t + 1) * q_tile) and scans the base block tile_block[t],
// rows [tile_block[t] * block_n, (tile_block[t] + 1) * block_n). It writes
// K1's packed bin winners of that pair into its own slab of the output:
//
//   out[t * nb + bin][s] = max over rows r of the bin of
//       (bitcast<int32>(dot_f32(base[r], qg[t * q_tile + s])) & ~(per_bin-1))
//       | (r mod per_bin),    nb = block_n / per_bin
//
// The bias column carries the +3.0 (shift 0): live slots hold 3.0 there,
// dead slots and pad rows 0, so their winners fall below 0x3F800000 and the
// decode drops them.
//
// On the TPU the block id reached the DMA through scalar prefetch; here the
// kernel reads it from the device array tile_block, so no host sync sets a
// size or a block. It is K1's Hopper main loop (scan_hopper.cuh) with that
// table: work items are (tile, query group of 256 slots, 2,048 rows), query
// group fastest, and tiles come sorted by block, so the CTAs running
// together stream one base block (8 MB at block_n 32768, dpad 128), read
// from DRAM about once and then from L2. What bounds it is the tensor cores
// on the live slots. Live slots are a prefix of each tile (tile_live[t] of
// them): an item whose query group holds none, or whose block lies outside
// the base, loads and computes nothing and writes the winner of zero
// scores, 0 | (per_bin - 1), as the plain version does for those slots.

#include "scan_hopper.cuh"

extern "C" {

// Launches K3 on `stream` of CUDA device `device`. base: (n_pad, dpad) bf16,
// queries: (n_tiles * q_tile, dpad) bf16, tile_block: (n_tiles,) int32,
// tile_live: (n_tiles,) int32 live slots per tile or null (every slot
// computed), out: (n_tiles * block_n / per_bin, q_tile) int32, all
// contiguous, 16-byte aligned (the int32 tables 4-byte) and on `device`. A
// block id outside [0, ceil(n_pad / block_n)) scans no rows. Returns a
// cudaError_t code (0 = launched).
int clann_block_scan_packed(const void* base, const void* queries, const void* tile_block,
                            const void* tile_live, void* out, long long n_pad, long long block_n,
                            int q_tile, long long n_tiles, int dpad, int per_bin, int device,
                            void* stream) {
  if (tile_block == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  clann::hopper::Launch L;
  L.base = base;
  L.queries = queries;
  L.tile_block = static_cast<const int32_t*>(tile_block);
  L.tile_live = static_cast<const int32_t*>(tile_live);
  L.out = static_cast<int32_t*>(out);
  L.vals = nullptr;
  L.n_pad = n_pad;
  L.tile_rows = block_n;
  L.n_tiles = n_tiles;
  L.tile_q = q_tile;
  L.dpad = dpad;
  L.per_bin = per_bin;
  L.group_shift = 0;  // a key per row, no rounding: K1's options are not K3's
  L.min_item_rows = 2048;  // a query group reload per item: coarser items amortise it
  return clann::hopper::launch_scan<clann::hopper::PackedKey<true>>(L, device, stream);
}

}  // extern "C"
