"""Batched distance computation and the brute-force k-NN oracle (PyTorch).

Port of ``clann_tpu.ops.distances``:
- cosine distance with precomputed norms (reference: src/metricdata/angulardata.rs:12-35)
- L2 via the squared-norm identity (reference: src/metricdata/euclideandata.rs:24-45)
- brute-force search oracle (reference: src/utils/mod.rs:116-131 and
  libpuffinn collection.hpp:524-541)
- PUFFINN cosine *similarity* convention sim = (dot+1)/2 in [0, 1]
  (reference: libpuffinn/include/puffinn/similarity_measure/cosine.hpp:19-23)
  and the CLANN distance<->similarity map sim = 1 - dist/2
  (reference: src/puffinn_binds/puffinn_types.rs:77-79).

Precision: every product here is a float32 matmul. On a CUDA device that is
full float32 only while ``torch.backends.cuda.matmul.allow_tf32`` is False,
which is PyTorch's default; the library never changes that flag, and
callers that need exact distances (tests, ``chip_smoke.py``) set it
explicitly. This plays the role of JAX's ``Precision.HIGHEST``.

``approx_max_k`` has no PyTorch counterpart: the port selects with the exact
``torch.topk`` and keeps the ``recall_target`` parameter. JAX on the CPU
lowers ``approx_max_k`` to an exact top-k as well, so both packages return
the same sets there (up to ties).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


def as_device_f32(x, device) -> torch.Tensor:
    """Float32 tensor on `device` from a numpy array or tensor."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(x, dtype=np.float32), device=device)


def exact_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """float32 matmul (full precision with TF32 off; see module doc)."""
    return torch.matmul(a.float(), b.float())


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    n = torch.linalg.vector_norm(x, dim=-1, keepdim=True)
    return x / torch.where(n == 0, torch.ones_like(n), n)


def _normalize_queries(q: torch.Tensor) -> torch.Tensor:
    """The scan bodies' fused query normalization (norm floored at 1e-30)."""
    return q / torch.clamp(
        torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=1e-30
    )


def cosine_distance_block(base_n: torch.Tensor, queries_n: torch.Tensor) -> torch.Tensor:
    """(q, n) cosine distances between pre-normalized rows.

    dist = 1 - cos (reference: angulardata.rs:25-35).
    """
    dots = exact_dot(queries_n, base_n.T)
    return torch.clamp(1.0 - dots, 0.0, 2.0)


def l2_distance_block(base: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """(q, n) euclidean distances (reference: euclideandata.rs:24-45)."""
    b_sq = torch.sum(base * base, dim=1)
    q_sq = torch.sum(queries * queries, dim=1)
    dots = exact_dot(queries, base.T)
    d2 = q_sq[:, None] + b_sq[None, :] - 2.0 * dots
    return torch.sqrt(torch.clamp(d2, min=0.0))


def cosine_to_similarity(dist):
    """CLANN distance -> PUFFINN similarity: sim = 1 - dist/2
    (reference: src/puffinn_binds/puffinn_types.rs:77-79)."""
    return 1.0 - dist / 2.0


def similarity_to_cosine(sim):
    """PUFFINN similarity -> CLANN cosine distance (inverse of above)."""
    return 2.0 * (1.0 - sim)


def cosine_similarity_block(base_n: torch.Tensor, queries_n: torch.Tensor) -> torch.Tensor:
    """(q, n) PUFFINN similarities sim=(dot+1)/2 (reference: cosine.hpp:19-23)."""
    dots = exact_dot(queries_n, base_n.T)
    return torch.clamp((dots + 1.0) * 0.5, 0.0, 1.0)


def brute_force_topk(base, queries, k: int = 10, metric: str = "angular",
                     block_q: int = 256, device="cuda"):
    """Exact k nearest neighbors (ascending distance), the test oracle.

    Reference: src/utils/mod.rs:116-131 (Rust brute_force_search) and
    collection.hpp:524-541 (C++ search_bf). Blocked over queries so the
    (block_q, n) distance tile stays bounded. Returns (distances (q, k),
    indices (q, k) int64) as tensors on `device` (the card unless the
    caller names the CPU).
    """
    device = resolve_device(device)
    base = as_device_f32(base, device)
    queries = as_device_f32(queries, device)
    if metric == "angular":
        base = l2_normalize(base)
        queries = l2_normalize(queries)
    block_q = min(block_q, max(1, queries.shape[0]))
    out_d, out_i = [], []
    for s in range(0, queries.shape[0], block_q):
        qblk = queries[s : s + block_q]
        if metric == "angular":
            d = cosine_distance_block(base, qblk)
        else:
            d = l2_distance_block(base, qblk)
        neg_d, idx = torch.topk(-d, k, dim=1)
        out_d.append(-neg_d)
        out_i.append(idx)
    return torch.cat(out_d), torch.cat(out_i)


def rescore(base_n: torch.Tensor, ids: torch.Tensor, queries_n: torch.Tensor):
    """Exact f32 sims of (Q, m) candidate ids (-1 = empty -> -inf)."""
    n = base_n.shape[0]
    safe = torch.clamp(ids, 0, n - 1)
    ex = torch.einsum("qmd,qd->qm", base_n[safe], queries_n)
    return torch.where(ids >= 0, ex, torch.full_like(ex, -torch.inf))


def _block_topk(queries_n, base_n, k, start, stop, top_s, top_i):
    """One scan block: exact top-k of the block merged into the running
    (top_s, top_i)."""
    dots = torch.matmul(queries_n, base_n[start:stop].T)
    s, j = torch.topk(dots, min(k, stop - start), dim=1)
    merged_s = torch.cat([top_s, s], dim=1)
    merged_i = torch.cat([top_i, j + start], dim=1)
    ms, sel = torch.topk(merged_s, k, dim=1)
    return ms, torch.gather(merged_i, 1, sel)


def _check_k(k: int, n: int) -> None:
    if k > n:
        # lax.top_k refuses the same request (JAX raises ValueError too)
        raise ValueError(f"k={k} exceeds the {n} points scanned")


def _dense_scan_impl(
    base_n, queries_n, *, k: int, block_points: int, recall_target: float,
    exact: bool, normalize_queries: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked dense scan: per-block top-k merged into a running top-k.

    `recall_target` is accepted for parity with the JAX signature; the
    per-block selection is the exact torch.topk (module doc). Without
    `exact`, the winners are re-scored exactly like the JAX path does, so
    returned values match the exact path at equal membership.
    """
    del recall_target
    if normalize_queries:
        queries_n = _normalize_queries(queries_n)
    n = base_n.shape[0]
    _check_k(k, n)
    q = queries_n.shape[0]
    top_s = torch.full((q, k), -torch.inf, dtype=torch.float32,
                       device=queries_n.device)
    top_i = torch.full((q, k), -1, dtype=torch.int64, device=queries_n.device)
    for start in range(0, n, block_points):
        top_s, top_i = _block_topk(
            queries_n, base_n, k, start, min(n, start + block_points),
            top_s, top_i,
        )
    if not exact:
        ex = rescore(base_n, top_i, queries_n)
        top_s, sel = torch.topk(ex, k, dim=1)
        top_i = torch.gather(top_i, 1, sel)
    return top_s, top_i


def _certified_scan_impl(
    base_n, queries_n, *, k: int, block_points: int,
    recall_target: float, eps: float, normalize_queries: bool = False,
):
    """Exact top-k via the approximate scan + a certifying count pass.

    Port of the JAX algorithm (see its docstring for the soundness
    argument): pass 1 keeps the winners' SCAN-precision scores and takes
    tau_q = the k-th of them; pass 2 counts |{p : dot(q, p) >= tau_q - eps}|
    with the same product. count == k certifies the winner set; any other
    count sends the query to the direct exact sort in the caller. tau stays
    in scan precision — comparing against the rescored value would mix two
    precisions. Returns (top_sims desc, top_ids, counts (Q,) int32).
    """
    del recall_target
    if normalize_queries:
        queries_n = _normalize_queries(queries_n)
    n = base_n.shape[0]
    _check_k(k, n)
    q = queries_n.shape[0]
    dev = queries_n.device
    top_s = torch.full((q, k), -torch.inf, dtype=torch.float32, device=dev)
    top_i = torch.full((q, k), -1, dtype=torch.int64, device=dev)
    for start in range(0, n, block_points):
        top_s, top_i = _block_topk(
            queries_n, base_n, k, start, min(n, start + block_points),
            top_s, top_i,
        )

    tau = top_s[:, k - 1]
    # underfull rows (all -inf) route to the fallback instead of counting n
    tau = torch.where(torch.isfinite(tau), tau, torch.full_like(tau, torch.inf))
    thresh = (tau - eps)[:, None]
    counts = torch.zeros(q, dtype=torch.int32, device=dev)
    for start in range(0, n, block_points):
        dots = torch.matmul(queries_n, base_n[start : start + block_points].T)
        counts += torch.sum(dots >= thresh, dim=1, dtype=torch.int32)

    ex = rescore(base_n, top_i, queries_n)
    ts, sel = torch.topk(ex, k, dim=1)
    return ts, torch.gather(top_i, 1, sel), counts


def dense_scan_topk(
    base,
    queries,
    k: int = 10,
    block_points: int = 262144,
    recall_target: float = 0.95,
    exact: bool = False,
    batch_q: int = 2048,
    device="cuda",
):
    """Full dense scan: blocked f32 matmuls + per-block top-k + exact merge.

    Returns numpy (cosine dot-similarities desc (q, k), ids). The returned
    similarity VALUES are exact. Runs on the card unless `device` names the
    CPU.
    """
    device = resolve_device(device)
    base_n = l2_normalize(as_device_f32(base, device))
    qn = l2_normalize(as_device_f32(queries, device))
    outs_s, outs_i = [], []
    for s in range(0, qn.shape[0], batch_q):
        ts, ti = _dense_scan_impl(
            base_n, qn[s : s + batch_q], k=k,
            block_points=min(block_points, base_n.shape[0]),
            recall_target=recall_target, exact=exact,
        )
        outs_s.append(ts.cpu().numpy())
        outs_i.append(ti.cpu().numpy().astype(np.int32))
    return np.concatenate(outs_s), np.concatenate(outs_i)
