"""Mesh-sharded greedy minimum-maximum (Gonzalez) clustering (PyTorch port
of ``clann_tpu.parallel.gmm``).

ops/gmm.py over points split across a mesh's shards, for builds beyond one
device. Each of the k iterations is

    per shard: matvec (n/D, d) @ (d,)  ->  local (max, argmax)
    all_gather of the D (max, argmax) pairs  ->  global argmax
    owner_row of the new center          ->  the center row on every shard

so the traffic per iteration is O(D + d) whatever n. The result is
bit-identical to ops/gmm.greedy_minimum_maximum (the same distance
arithmetic row by row, the same first-max-wins tie-break as the reference
gmm.rs:5-15: a global tie goes to the smallest point index). No step syncs
with the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from clann_tpu_torch.ops.distances import as_device_f32, exact_dot, l2_normalize
from clann_tpu_torch.parallel.mesh import all_gather, make_mesh, owner_row, pmax

_INT_MAX = torch.iinfo(torch.int32).max


def _local_gmm(mesh, x_parts, bases, *, k: int, n_real: int, lead):
    """The shard_map body of JAX's `_local_gmm`, shard by shard.
    x_parts: per-shard (n_local, d) normalized rows (None off-process)."""
    shards = [s for s, x in enumerate(x_parts) if x is not None]
    n_local = next(x_parts[s].shape[0] for s in shards)
    gids = {s: bases[s] + torch.arange(n_local, device=x_parts[s].device) for s in shards}
    valid = {s: gids[s] < n_real for s in shards}  # padding rows never become centers

    def dist_col(s, center_vec):
        dots = exact_dot(x_parts[s], center_vec.to(x_parts[s].device))
        return torch.clamp(1.0 - dots, 0.0, 2.0)

    def center_row(global_idx):
        """The center vector from its owning shard (one-hot psum in JAX)."""
        rows, owns = [None] * len(x_parts), [None] * len(x_parts)
        for s in shards:
            gi = global_idx.to(x_parts[s].device)
            local_pos = gi - bases[s]
            owns[s] = (local_pos >= 0) & (local_pos < n_local)
            rows[s] = x_parts[s][torch.clamp(local_pos, 0, n_local - 1)]
        return owner_row(mesh, rows, owns, lead)

    def global_argmax(dists):
        """First-max-wins over all shards (gmm.rs:5-15 tie-break)."""
        ms, gis = [None] * len(x_parts), [None] * len(x_parts)
        for s in shards:
            masked = torch.where(valid[s], dists[s], -torch.inf)
            li = torch.argmax(masked)
            ms[s], gis[s] = masked[li], gids[s][li]
        ms, gis = all_gather(mesh, ms, lead), all_gather(mesh, gis, lead)
        # among shards at the max, the smallest global index wins
        return torch.min(torch.where(ms >= torch.max(ms), gis, _INT_MAX))

    c0 = center_row(torch.zeros((), dtype=torch.int64, device=lead))
    dists = {s: dist_col(s, c0) for s in shards}
    assignment = {s: torch.zeros(n_local, dtype=torch.int64, device=x_parts[s].device)
                  for s in shards}
    centers = torch.zeros(k, dtype=torch.int64, device=lead)
    for idx in range(1, k):
        farthest = global_argmax(dists)
        centers[idx] = farthest
        c = center_row(farthest)
        for s in shards:
            new_dists = dist_col(s, c)
            closer = new_dists < dists[s]  # strict < (gmm.rs:48)
            assignment[s] = torch.where(closer, idx, assignment[s])
            dists[s] = torch.where(closer, new_dists, dists[s])
    # per-shard partial radii, max-combined across the mesh
    radii = [None] * len(x_parts)
    for s in shards:
        radii[s] = torch.zeros(k, dtype=torch.float32, device=x_parts[s].device).scatter_reduce(
            0, torch.where(valid[s], assignment[s], 0),
            torch.where(valid[s], dists[s], 0.0), reduce="amax", include_self=True)
    assign_all = [assignment.get(s) for s in range(len(x_parts))]
    return centers, all_gather(mesh, assign_all, lead).reshape(-1), pmax(mesh, radii, lead)


def sharded_gmm(
    data, k: int, mesh=None, axis: str = "shard", metric: str = "angular",
    assume_normalized: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mesh-sharded GMM. Same contract as ops/gmm.greedy_minimum_maximum:
    (centers (k,) int64, assignment (n,) int64, radii (k,) f32) tensors, on
    the device of the mesh's first shard.

    `data`: a host array or a tensor; each shard's rows are copied to its
    device. assume_normalized: as in ops/gmm (skips the normalize pass).
    """
    if metric != "angular":
        raise ValueError("sharded GMM currently supports the angular metric")
    if mesh is None:
        mesh = make_mesh(axis_name=axis)
    devs = mesh.cluster_devices()
    lead = devs[0]
    D = len(devs)
    x = data if isinstance(data, torch.Tensor) else np.asarray(data, np.float32)
    n = x.shape[0]
    if n <= k:
        ar = torch.arange(n, device=lead)
        return ar, ar.clone(), torch.zeros(n, dtype=torch.float32, device=lead)

    n_local = -(-n // D)  # rows past n are zero padding
    x_parts, bases = [], []
    for s, dev in enumerate(devs):
        bases.append(s * n_local)
        if not mesh.is_local(s):
            x_parts.append(None)
            continue
        xs = as_device_f32(x[s * n_local:(s + 1) * n_local], dev)
        if xs.shape[0] < n_local:
            xs = torch.nn.functional.pad(xs, (0, 0, 0, n_local - xs.shape[0]))
        x_parts.append(xs if assume_normalized else l2_normalize(xs))
    centers, assignment, radii = _local_gmm(mesh, x_parts, bases, k=k, n_real=n, lead=lead)
    return centers, assignment[:n], radii
