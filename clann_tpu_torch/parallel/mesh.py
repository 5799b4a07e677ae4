"""Device meshes and the shard collectives (PyTorch port of
``clann_tpu.parallel.mesh``).

The JAX package's mesh is single-controller: one process drives every
device of a `jax.sharding.Mesh`, and `shard_map` runs one body per device.
The port keeps that model. A `Mesh` is an array of torch devices with axis
names; a sharded function runs its shard bodies in order from one thread,
each on its shard's device, and the shard_map collectives become the plain
functions below over per-shard tensors (`all_gather`, `psum`, `pmax`,
`owner_row`). Several shards may name one device: a 4-shard mesh on one
card is `make_mesh(4, devices=["cuda:0"] * 4)`, and its shards then run one
after another.

Across processes (parallel/distributed.global_mesh) `ranks` names the
process that owns each device. A process runs only its own shards (the
others are None in its per-shard lists), and the collectives cross
processes through torch.distributed.all_gather.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

CLUSTER_AXIS = "cluster"
QUERY_AXIS = "query"

# Per-card spans of the shard bodies, a reading of how the cards overlap:
# while this is a list, every sharded search appends (device, start event,
# end event) around each shard body it runs on a CUDA device, recorded on
# that card's current stream (no host sync). None (the default) records
# nothing.
SHARD_SPANS: Optional[list] = None


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Devices laid out on named axes: ("cluster",) or ("query", "cluster")."""

    devices: np.ndarray  # object array of torch.device, one dim per axis name
    axis_names: Tuple[str, ...]
    ranks: Optional[np.ndarray] = None  # owning process of each device; None = this one

    @property
    def shape(self) -> Dict[str, int]:
        """{axis name: size}, in axis order (jax Mesh.shape)."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def multiprocess(self) -> bool:
        return self.ranks is not None and len(np.unique(self.ranks)) > 1

    def cluster_devices(self, query_block: int = 0) -> List[torch.device]:
        """The devices along the cluster axis (row `query_block` of a 2-D
        mesh)."""
        row = self.devices if self.devices.ndim == 1 else self.devices[query_block]
        return list(row)

    def is_local(self, shard: int, query_block: int = 0) -> bool:
        """Does this process run cluster shard `shard`?"""
        if not self.multiprocess:
            return True
        import torch.distributed as dist

        r = self.ranks if self.ranks.ndim == 1 else self.ranks[query_block]
        return int(r[shard]) == dist.get_rank()


@contextlib.contextmanager
def shard_span(device):
    """Record one shard body on `device` into SHARD_SPANS, when it is a
    list."""
    spans, dev = SHARD_SPANS, torch.device(device)
    if spans is None or dev.type != "cuda":
        yield
        return
    stream = torch.cuda.current_stream(dev)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record(stream)
    yield
    end.record(stream)
    spans.append((dev, start, end))


def _device_array(devices) -> np.ndarray:
    arr = np.empty(len(devices), dtype=object)
    for i, d in enumerate(devices):
        arr[i] = torch.device(d)
    return arr


def visible_devices() -> List[torch.device]:
    """Every CUDA device this process sees (the default mesh devices)."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def make_mesh(
    n_devices: Optional[int] = None,
    axis_name: str = CLUSTER_AXIS,
    devices: Optional[Sequence] = None,
) -> Mesh:
    """1-D mesh over the first n_devices of `devices` (default: every
    visible CUDA device). A device may repeat: shards then share it."""
    devs = list(visible_devices() if devices is None else devices)
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(_device_array(devs), (axis_name,))


def make_mesh_2d(
    n_query: int, n_cluster: int, devices: Optional[Sequence] = None
) -> Mesh:
    """(query, cluster) mesh: queries data-parallel x clusters sharded."""
    devs = list(visible_devices() if devices is None else devices)
    if n_query * n_cluster > len(devs):
        raise ValueError(
            f"mesh {n_query}x{n_cluster} needs {n_query * n_cluster} devices,"
            f" only {len(devs)} available"
        )
    arr = _device_array(devs[: n_query * n_cluster]).reshape(n_query, n_cluster)
    return Mesh(arr, (QUERY_AXIS, CLUSTER_AXIS))


# --- collectives over the shards of one mesh axis -------------------------
# `parts` holds one tensor per shard, in shard order, None for the shards
# of other processes; every part has the same shape and dtype.


def all_gather(mesh: Mesh, parts: Sequence[Optional[torch.Tensor]],
               device) -> torch.Tensor:
    """jax.lax.all_gather: the parts stacked (D, ...) on `device`."""
    local = torch.stack([p.to(device) for p in parts if p is not None])
    if not mesh.multiprocess:
        return local
    import torch.distributed as dist

    out = [torch.empty_like(local) for _ in range(dist.get_world_size())]
    dist.all_gather(out, local)
    return torch.cat(out)


def psum(mesh: Mesh, parts, device) -> torch.Tensor:
    """jax.lax.psum: the parts summed on `device`, in their dtype."""
    return all_gather(mesh, parts, device).sum(dim=0, dtype=_dtype(parts))


def pmax(mesh: Mesh, parts, device) -> torch.Tensor:
    """jax.lax.pmax: the elementwise maximum of the parts on `device`."""
    return all_gather(mesh, parts, device).amax(dim=0)


def owner_row(mesh: Mesh, rows, owns, device) -> torch.Tensor:
    """The one-hot psum row gather (parallel/gmm.py): each shard offers a
    row and a 0-d bool saying whether it owns it; exactly one does, and
    its row is returned as it is (a copy, not a sum), without a host sync."""
    all_rows = all_gather(mesh, rows, device)
    all_owns = all_gather(mesh, owns, device)
    return all_rows[torch.argmax(all_owns.to(torch.int32))]


def _dtype(parts) -> torch.dtype:
    return next(p for p in parts if p is not None).dtype
