"""Device-memory capacity planning for large builds (PyTorch port of
``clann_tpu.parallel.capacity``; framework-free).

The reference never plans memory: it reports bytes after the fact
(collection.hpp:249-254). `plan_capacity` answers "how many devices does
this build need?" analytically, before any allocation, from the structures
that build_index materialises:

- f32 normalized vectors            n*d*4
- bf16 scan copy (+bias col, pad)   n_pad * dpad * 2      [dense paths]
- per-table sorted hash + idx       L * n * 8
- packed (id, sketch, cluster) rec  L * n_pad * (2+W) * 4 [global engine]
- sketches                          n * S * W * 4
- prefix directories + geometry     (small, counted)

The per-structure byte model is the JAX package's, unchanged, so the table
counts that the PUFFINN surface derives from a byte budget (puffinn.py) are
JAX's. `headroom` reserves device memory for transient workspace (score
tiles, sort scratch) and the allocator's fragmentation. The one
device-specific number is the default `hbm_bytes`: the port's card, an
NVIDIA H100 80GB HBM3, in place of JAX's 16 GiB TPU v5e. Whether the 0.25
headroom and `fits_single_chip` hold on that card is not measured.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from clann_tpu_torch.config import Config

# device memory of an NVIDIA H100 80GB HBM3: the total_memory that
# torch.cuda.get_device_properties reports for it (chip_smoke.py prints it)
HBM_H100 = 85_017_493_504


def _scan_pad(n: int, k: int) -> int:
    from clann_tpu_torch.ops.ivf import pallas_scan_plan

    block_n = pallas_scan_plan(n, k)[0]
    return -(-n // block_n) * block_n


@dataclasses.dataclass(frozen=True)
class CapacityPlan:
    """Byte budget of one build and the device count it needs."""

    per_structure: Dict[str, int]
    shardable_bytes: int  # splits across devices (per-point/per-slot data)
    replicated_bytes: int  # lives on every device (params, directories)
    hbm_bytes: int
    usable_bytes: int  # hbm * (1 - headroom)
    fits_single_chip: bool
    min_devices: int  # smallest count where a shard + replicated fits
    recommended_devices: int  # min_devices rounded up to a power of two

    @property
    def total_bytes(self) -> int:
        return self.shardable_bytes + self.replicated_bytes


def plan_capacity(
    n: int,
    d: int,
    config: Config = None,
    hbm_bytes: int = HBM_H100,
    headroom: float = 0.25,
) -> CapacityPlan:
    """Plan the device count for an n x d angular build under `config`.

    headroom: fraction of device memory reserved for transient workspace
    (batched score / sort buffers, allocator fragmentation); 0.25 is the
    JAX package's value.
    """
    cfg = config or Config()
    L = cfg.num_tables
    S = cfg.num_sketches
    W = cfg.sketch_bits // 32
    C = cfg.num_clusters(n)
    n_pad = _scan_pad(n, cfg.k)
    dpad = -(-(d + 1) // 128) * 128
    n_slot = n + ((-n) % max(1, cfg.gather_block))

    per: Dict[str, int] = {"vectors_f32": n * d * 4}
    if cfg.dense_layout:
        per["scan_copy_bf16"] = n_pad * dpad * 2
        per["dense_geometry"] = C * (d + 2) * 4
    # the fused scan keeps its own padded bf16 base (ops/ivf._pallas_base)
    # beside the dense layout's; it is built only at the shapes the router
    # sends to the kernel (ops/ivf.pallas_scan_viable)
    from clann_tpu_torch.ops.ivf import pallas_scan_viable

    if pallas_scan_viable(n, d):
        per["pallas_scan_base_bf16"] = n_pad * dpad * 2
    per["tables_hash_idx"] = L * n * 8
    per["sketches"] = n * S * W * 4
    if cfg.pack_slot_records:
        per["slot_records"] = L * n_slot * (2 + W) * 4
    if cfg.lsh_engine in ("global", "both"):
        per["g_tables"] = L * n * 4
        per["g_records"] = L * n_slot * (2 + W) * 4
        per["g_dir"] = L * ((1 << cfg.global_dir_bits) + 1) * 4
    if cfg.lsh_engine in ("clustered", "both"):
        per["prefix_dir"] = L * C * ((1 << cfg.prefix_dir_bits) + 1) * 4
    per["cluster_geometry"] = C * (d + 4) * 4
    # hash/sketch function parameters (replicated, tiny): planes/signs
    per["hash_params"] = L * cfg.max_hashbits * d * 4 + S * cfg.sketch_bits * d * 4

    replicated = (
        per.get("g_dir", 0)
        + per.get("prefix_dir", 0)
        + per["cluster_geometry"]
        + per["hash_params"]
    )
    shardable = sum(per.values()) - replicated

    usable = int(hbm_bytes * (1.0 - headroom))
    avail = max(1, usable - replicated)
    min_dev = max(1, math.ceil(shardable / avail))
    rec = 1 << (min_dev - 1).bit_length()
    return CapacityPlan(
        per_structure=per,
        shardable_bytes=int(shardable),
        replicated_bytes=int(replicated),
        hbm_bytes=int(hbm_bytes),
        usable_bytes=usable,
        fits_single_chip=shardable + replicated <= usable,
        min_devices=min_dev,
        recommended_devices=rec,
    )
