"""Device meshes and the shard collectives (PyTorch port of
``clann_tpu.parallel.mesh``).

The JAX package's mesh is single-controller: one process drives every
device of a `jax.sharding.Mesh`, and `shard_map` runs one body per device,
all at once. The port keeps that model. A `Mesh` is an array of torch
devices with axis names; a sharded function hands its shard bodies to
`run_shards`, which runs the bodies of distinct cards at once (one worker
thread per card, each on its card's current stream) and the shards of one
card in order; loop bodies of many small ops take turns issuing
(`taking_turns`, `host_read`), and the shard_map collectives become the
plain functions below over per-shard tensors (`all_gather`, `psum`,
`pmax`, `owner_row`).
Several shards may name one device: a 4-shard mesh on one card is
`make_mesh(4, devices=["cuda:0"] * 4)`, and its shards then run one after
another from the calling thread.

Across processes (parallel/distributed.global_mesh) `ranks` names the
process that owns each device. A process runs only its own shards (the
others are None in its per-shard lists), and the collectives cross
processes through torch.distributed.all_gather.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import threading
import traceback
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from clann_tpu_torch.metrics.trace import TRACER

CLUSTER_AXIS = "cluster"
QUERY_AXIS = "query"

# True inside `_shards_in_order()`: run_shards then runs every body in shard
# order from the calling thread, as the port did before it ran the cards at
# once. For readings and tests only.
_IN_ORDER = False
_LOCK = threading.Lock()  # the worker pool
_WORKERS: Dict[torch.device, concurrent.futures.ThreadPoolExecutor] = {}
# .worker: this thread is a card's worker; .turn: it holds _TURN
_THREAD = threading.local()
# The issuing turn of the workers' loop bodies (taking_turns / host_read).
_TURN = threading.Lock()


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
def _shards_in_order():
    """Within this block run_shards runs every shard body in shard order
    from the calling thread (the in-order reading beside the at-once one)."""
    global _IN_ORDER
    prev, _IN_ORDER = _IN_ORDER, True
    try:
        yield
    finally:
        _IN_ORDER = prev


@contextlib.contextmanager
def taking_turns():
    """Within this block a run_shards worker issues torch ops only while
    it holds the turn, which it passes on while it waits in `host_read`:
    the cards' loop bodies interleave their host work (one thread issuing
    at a time) and overlap their device work. Every torch op releases and
    retakes the interpreter lock, so workers issuing small ops side by side
    hand the lock over at every op, which costs far more than the op on
    some hosts; taking turns hands it over once per host read. Outside a
    worker (inline runs, one card) it does nothing. The waits for the turn
    are the tracer's `shards/turn_wait` spans."""
    if not getattr(_THREAD, "worker", False) or getattr(_THREAD, "turn", False):
        yield
        return
    with TRACER.span("shards/turn_wait"):
        _TURN.acquire()
    _THREAD.turn = True
    try:
        yield
    finally:
        _THREAD.turn = False
        _TURN.release()


def host_read(fn: Callable[[], Any]) -> Any:
    """fn(), a read that waits on the device (a loop's host sync); a worker
    holding the turn (taking_turns) passes it on while it waits."""
    if not getattr(_THREAD, "turn", False):
        return fn()
    _THREAD.turn = False
    _TURN.release()
    try:
        return fn()
    finally:
        with TRACER.span("shards/turn_wait"):
            _TURN.acquire()
        _THREAD.turn = True


def _card(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _worker(dev: torch.device) -> concurrent.futures.ThreadPoolExecutor:
    """The card's worker: one thread, made on first use and kept."""
    with _LOCK:
        pool = _WORKERS.get(dev)
        if pool is None:
            pool = _WORKERS[dev] = concurrent.futures.ThreadPoolExecutor(
                1, thread_name_prefix=f"clann-shards-{dev}")
        return pool


def run_shards(devices: Sequence[Optional[torch.device]],
               body: Callable[[int], Any]) -> List[Any]:
    """`body(i)` for every shard i whose device is not None (the shards of
    this process), each inside a `shards/body` span; returns the results
    by shard (None for the others). The shard_map of the single controller.

    The shards are grouped by device, and each device gets one worker
    thread: the devices' bodies run at once, and one device's shards run
    in shard order in its worker. A worker makes its card current and
    takes, on every card of the call, the stream that is current in the
    calling thread, so the caller's merges (all_gather, .to(lead)) are
    ordered after the bodies' work with no new events. When every shard
    lies on one device (a one-card mesh, a CPU mesh, one process per card),
    under `_shards_in_order()`, or when called from a worker, the bodies run
    inline in shard order. Loop bodies that issue many small ops take turns
    (taking_turns, host_read). While the tracer is active in the calling
    thread, the workers are marked traced for these bodies (their spans
    are on the host clock: the profiler does not reach them).

    Waits for every worker. If bodies raised, the first one's exception (in
    shard order) is raised once every worker has stopped, with the others'
    added to it as notes.
    """
    out: List[Any] = [None] * len(devices)
    live = [i for i, d in enumerate(devices) if d is not None]
    groups: Dict[torch.device, List[int]] = {}
    for i in live:
        groups.setdefault(_card(devices[i]), []).append(i)

    def run(i):
        with TRACER.span("shards/body"):
            return body(i)

    if _IN_ORDER or len(groups) <= 1 or getattr(_THREAD, "worker", False):
        for i in live:
            out[i] = run(i)
        return out
    streams = [torch.cuda.current_stream(d) for d in groups if d.type == "cuda"]
    traced = TRACER.active()

    def work(dev, shards):
        _THREAD.worker = True
        with contextlib.ExitStack() as scope:
            scope.enter_context(TRACER.marked(traced))
            for st in streams:
                scope.enter_context(torch.cuda.stream(st))
            if dev.type == "cuda":
                scope.enter_context(torch.cuda.device(dev))
            for i in shards:
                out[i] = run(i)

    futures = [(shards[0], _worker(dev).submit(work, dev, shards))
               for dev, shards in groups.items()]
    concurrent.futures.wait([f for _, f in futures])
    errors = [f.exception() for _, f in sorted(futures, key=lambda x: x[0])
              if f.exception() is not None]
    if errors:
        for other in errors[1:]:
            errors[0].add_note("another shard body raised too:\n"
                               + "".join(traceback.format_exception(other)))
        raise errors[0]
    return out


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
