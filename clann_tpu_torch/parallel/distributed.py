"""Multi-process runtime helpers (PyTorch port of
``clann_tpu.parallel.distributed``).

The reference is single-process (OpenMP shared memory only). The JAX
package joins hosts with `jax.distributed`: every host runs the same
program and the hosts' devices form one global mesh. The port does the
same with a torch.distributed process group: `initialize_distributed`
opens it, `global_mesh` spans every process's devices (each process runs
only its own shards, parallel/mesh.py), and `host_local_slice` splits
host-side work by rank.

A single process needs no initialization; these helpers are gated so the
same entry points work everywhere.
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

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
    `backend` defaults to nccl with a CUDA device, gloo without. Without
    an address and a process count (a single process) nothing is opened
    and False is returned; True when a group was opened.
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


def global_mesh(axis_name: str = CLUSTER_AXIS,
                local_devices: Optional[Sequence] = None) -> Mesh:
    """1-D mesh over the devices of every process, rank by rank.

    `local_devices`: this process's devices (default: its visible CUDA
    devices); every process must bring the same number. A process runs
    only the shards on its own devices; the collectives cross processes.
    """
    local = list(visible_devices() if local_devices is None else local_devices)
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
