"""Multi-process runtime helpers (PyTorch port of
``clann_tpu.parallel.distributed``).

The reference is single-process (OpenMP shared memory only). The JAX
package joins hosts with `jax.distributed`: every host runs the same
program and the hosts' devices form one global mesh. The port does the
same with a torch.distributed process group: `initialize_distributed`
opens it, `global_mesh` spans every process's devices (each process runs
only its own shards, parallel/mesh.py), and `host_local_slice` splits
host-side work by rank.

Several processes on one host take one card each, torchrun's layout: a
process whose environment names its LOCAL_RANK (and not a
LOCAL_WORLD_SIZE of 1) owns one card alone, as a JAX process owns only its
local devices: cuda:{LOCAL_RANK} when it sees that card, cuda:0 when it
sees exactly one (a launcher gave it only its own through
CUDA_VISIBLE_DEVICES), and a ValueError otherwise. `initialize_distributed`
makes that card current before it opens an NCCL group, and `global_mesh`
gives the process that card unless the caller names its devices.

A single process needs no initialization; these helpers are gated so the
same entry points work everywhere.
"""

from __future__ import annotations

import logging
import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from clann_tpu_torch.parallel.mesh import CLUSTER_AXIS, Mesh, _device_array, visible_devices

log = logging.getLogger("clann_tpu_torch")


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> bool:
    """Open the torch.distributed process group when running multi-process.

    Arguments default from torchrun's environment (MASTER_ADDR /
    MASTER_PORT, WORLD_SIZE, RANK). `coordinator_address` is "host:port"
    (a tcp:// init method) or any init-method URL (e.g. file://...).
    `backend` defaults to nccl with a CUDA device, gloo without. With nccl
    and a LOCAL_RANK in the environment, that card is made current first
    (NCCL binds each rank to the current device). Without an address and
    a process count (a single process) nothing is opened and False is
    returned; True when a group was opened. The card is `_local_card`'s.
    """
    import torch.distributed as dist

    if coordinator_address is None and os.environ.get("MASTER_ADDR"):
        coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                               f"{os.environ.get('MASTER_PORT', '29500')}")
    num_processes = num_processes or _int_env("WORLD_SIZE")
    process_id = process_id if process_id is not None else _int_env("RANK")

    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "a process group needs a coordinator address, a process count and "
            f"this process's id (got {coordinator_address!r}, {num_processes!r}, "
            f"{process_id!r})")
    init_method = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
    backend = backend or ("nccl" if torch.cuda.is_available() else "gloo")
    local_rank = _int_env("LOCAL_RANK")
    if backend == "nccl" and local_rank is not None:
        torch.cuda.set_device(_local_card(local_rank))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)
    log.info("torch.distributed initialized: process %d/%d (%s)",
             dist.get_rank(), dist.get_world_size(), backend)
    return True


def _int_env(name: str) -> Optional[int]:
    v = os.environ.get(name)
    return int(v) if v else None


def _world() -> tuple:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_card(local_rank: int) -> int:
    """The card of the process with this LOCAL_RANK: LOCAL_RANK itself while
    this process sees that many cards, 0 when it sees exactly one; a
    LOCAL_RANK beyond several visible cards raises (no other card is
    taken in its place)."""
    n = len(visible_devices())
    if local_rank < n:
        return local_rank
    if n == 1:
        return 0
    raise ValueError(f"LOCAL_RANK {local_rank} names no card of the {n} this process sees")


def default_local_devices() -> List[torch.device]:
    """This process's devices: its one card (`_local_card`) when it is one
    of several processes on its host (LOCAL_RANK set, LOCAL_WORLD_SIZE
    unset or above 1) in a group of several processes, else every visible
    CUDA device."""
    local_rank = _int_env("LOCAL_RANK")
    if (_world()[1] > 1 and local_rank is not None
            and _int_env("LOCAL_WORLD_SIZE") != 1):
        return [torch.device("cuda", _local_card(local_rank))]
    return visible_devices()


def global_mesh(axis_name: str = CLUSTER_AXIS,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the devices of every process, rank by rank.

    `local_devices`: this process's devices (default:
    `default_local_devices()`, one card per process when several share a
    host); every process must bring the same number. A process runs only
    the shards on its own devices; the collectives cross processes. The
    mesh lists this process's devices in every rank's place, so its first
    device, where the merges land, is always one of its own.
    """
    local = list(default_local_devices() if local_devices is None else local_devices)
    rank, world = _world()
    if world > 1:
        import torch.distributed as dist

        counts = [None] * world
        dist.all_gather_object(counts, len(local))
        if len(set(counts)) != 1:
            raise ValueError(f"processes bring different device counts: {counts}")
    return Mesh(_device_array(local * world), (axis_name,),
                ranks=np.repeat(np.arange(world), len(local)))


def host_local_slice(n_items: int) -> slice:
    """The contiguous block of `n_items` owned by this process, for
    splitting host-side build work (e.g. per-shard assembly) by rank."""
    p, np_ = _world()
    per = -(-n_items // np_)
    return slice(p * per, min((p + 1) * per, n_items))
