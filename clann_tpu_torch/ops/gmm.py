"""Greedy minimum-maximum (Gonzalez) k-center clustering (PyTorch port).

Port of ``clann_tpu.ops.gmm`` with the reference GMM semantics
(reference: src/core/gmm.rs:21-63):
- first center is point 0 (gmm.rs:33)
- k-1 iterations: next center = argmax of current min-distance (first max
  wins, gmm.rs:5-15), then relax distances with strict `<` (gmm.rs:47-52)
- per-cluster radius = max assigned distance (gmm.rs:56-60)
- degenerate n <= k: every point its own center (gmm.rs:26-31)

Each iteration is one (n, d) x (d,) matvec plus elementwise updates, all on
the device: `torch.argmax` returns the first maximal index on the CPU and on
CUDA, and the chosen center stays a device tensor, so the loop issues work
without a host synchronization per iteration.
"""

from __future__ import annotations

import torch

from clann_tpu_torch.ops.distances import as_device_f32, exact_dot, l2_normalize


def _row(x: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """x[c] for a 0-d device index, as an index kernel (no host sync)."""
    return torch.index_select(x, 0, c.reshape(1))[0]


def greedy_minimum_maximum(data, k: int, metric: str = "angular",
                           assume_normalized: bool = False, device=None):
    """Cluster `data` into k groups; returns (centers, assignment, radii).

    centers: (k,) int64 indices into data rows
    assignment: (n,) int64 indices into centers
    radii: (k,) float32 max distance of an assigned point to its center
    All three are tensors on `device` (default: the data's device, or the
    CPU for numpy input). `assume_normalized`: the caller guarantees unit
    rows (angular) and the normalize pass is skipped.
    """
    if device is None:
        device = data.device if isinstance(data, torch.Tensor) else "cpu"
    x = as_device_f32(data, device)
    n = x.shape[0]
    if n <= k:
        ar = torch.arange(n, device=device)
        return ar, ar.clone(), torch.zeros(n, dtype=torch.float32, device=device)

    if metric == "angular":
        xn = x if assume_normalized else l2_normalize(x)

        def dist_col(c):
            # 1 - Xn @ Xn[c] (reference: angulardata.rs:38-43)
            return torch.clamp(1.0 - exact_dot(xn, _row(xn, c)), 0.0, 2.0)

    else:
        sq = torch.sum(x * x, dim=1)

        def dist_col(c):
            d2 = sq + _row(sq, c) - 2.0 * exact_dot(x, _row(x, c))
            return torch.sqrt(torch.clamp(d2, min=0.0))

    centers = torch.zeros(k, dtype=torch.int64, device=device)
    dists = dist_col(centers[0])
    assignment = torch.zeros(n, dtype=torch.int64, device=device)
    for idx in range(1, k):
        farthest = torch.argmax(dists)  # first max (gmm.rs:5-15)
        centers[idx] = farthest
        new_dists = dist_col(farthest)
        closer = new_dists < dists  # strict < (gmm.rs:48)
        assignment = torch.where(closer, idx, assignment)
        dists = torch.where(closer, new_dists, dists)
    radii = torch.zeros(k, dtype=torch.float32, device=device).scatter_reduce(
        0, assignment, dists, reduce="amax", include_self=True
    )
    return centers, assignment, radii

