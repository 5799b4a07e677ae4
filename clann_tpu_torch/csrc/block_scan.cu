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
// On the TPU the block id reached the DMA through scalar prefetch; here each
// CTA reads it from the device array tile_block, so no host sync sets a
// size or a block. It is K1's main loop and epilogue (scan_common.cuh) with
// that table: CTAs are numbered query group fastest, then row group, then
// tile, and tiles come sorted by block, so the CTAs resident together stream
// one base block (8 MB at block_n 32768, dpad 128), read from DRAM about
// once and then from L2. What bounds it is K1's: tensor cores and the
// packing epilogue. Tiles past the last live slot and the dead slots of
// each block's last tile are computed like live ones (their rows are
// written, and the decode never reads them).

#include "scan_common.cuh"

extern "C" {

// Launches K3 on `stream` of CUDA device `device`. base: (n_pad, dpad) bf16,
// queries: (n_tiles * q_tile, dpad) bf16, tile_block: (n_tiles,) int32, out:
// (n_tiles * block_n / per_bin, q_tile) int32, all contiguous, 16-byte
// aligned (tile_block 4-byte) and on `device`. A block id outside
// [0, n_pad / block_n) scans no rows. Returns a cudaError_t code
// (0 = launched).
int clann_block_scan_packed(const void* base, const void* queries, const void* tile_block,
                            void* out, long long n_pad, long long block_n, int q_tile,
                            long long n_tiles, int dpad, int per_bin, int device, void* stream) {
  clann::ScanShape sh;
  long long grid = 0;
  if (tile_block == nullptr ||
      !clann::make_shape(sh, grid, base, queries, tile_block, n_pad, block_n, q_tile, n_tiles,
                         dpad, per_bin, clann::MAX_PER_BIN))
    return static_cast<int>(cudaErrorInvalidValue);
  clann::PackedEpi epi;
  epi.out = static_cast<int32_t*>(out);
  epi.shift = 0.f;
  epi.keep = ~(per_bin - 1);
  return clann::launch_scan(sh, grid, epi, device, stream);
}

}  // extern "C"
