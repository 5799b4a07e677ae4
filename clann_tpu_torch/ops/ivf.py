"""Dense scans and dense IVF probing (PyTorch port of ``clann_tpu.ops.ivf``).

`scan_search` answers a batch of queries with either the plain blocked scan
(ops/distances._dense_scan_impl, or the certified exact scan) or the fused
kernel path (ops/scan_topk.fused_scan_topk_e2e, whose candidate stage is the
hand-written CUDA kernel K1 on a CUDA device).

`dense_search` and `adaptive_dense_search` probe the dense layout
(core/index.build_dense_layout): the rows nearest each query by center
distance are inverted to row-major query lists, scored with one batched
f32 product per group of rows (the JAX package's einsum at
Precision.HIGHEST; no Pallas kernel there, and none here), reduced to a
top-k per (row, query slot), scattered back and merged. The ball-overlap
certificate (index.rs:342-361) counts, per query, the unprobed rows that
could still hold a better neighbour. Where JAX is free to order things
(its unstable sort of the probe list, its quicksort argsort of the rows),
the port sorts stably; the TPU's `approx_max_k` is an exact top-k here,
as it is in JAX on the CPU.

The plan (`pallas_scan_plan`) and the routing threshold
(`PALLAS_SCAN_MIN_N`) are the JAX package's, kept verbatim: `block_n` and
`num_bins` decide which candidates survive, so changing them would change
results. Both were tuned on another accelerator; the values for this port's
hardware are an open measurement, not something these constants encode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.metrics.trace import TRACER
from clann_tpu_torch.ops.distances import (
    _certified_scan_impl,
    _dense_scan_impl,
    as_device_f32,
    exact_dot,
    l2_normalize,
)
from clann_tpu_torch.ops.query import topk_stable


class DenseSearchStats(NamedTuple):
    distance_computations: np.ndarray  # (Q,) int32 — points scanned
    candidates: np.ndarray  # (Q,) int32 — == distance_computations here
    clusters_visited: np.ndarray  # (Q,) int32
    dropped_probes: np.int32  # () — always 0 for a full scan
    uncertified: np.ndarray  # (Q,) int32 — 1 where the certificate failed
    probed_clusters: Optional[np.ndarray] = None  # (Q, P) owner cluster ids
    probed_counts: Optional[np.ndarray] = None  # (Q, P) points scanned


def auto_n_probe(n_rows: int) -> int:
    """Default probe budget (in segment rows): ~1.5*sqrt(R), in [8, R]."""
    return int(min(n_rows, max(8, round(np.sqrt(n_rows) * 1.5))))


# Routing threshold of the JAX package (its measured crossover on a TPU v5e,
# clann_tpu/ops/ivf.py): `use_pallas` requests below it run the plain scan
# unless the caller pins pallas_auto_route=False. Kept for parity.
PALLAS_SCAN_MIN_N = 800_000


def pallas_scan_viable(n: int, d: Optional[int] = None) -> bool:
    """Should the fused kernel path run at this shape? (JAX rule.)"""
    del d
    return n >= PALLAS_SCAN_MIN_N


def pallas_scan_plan(
    n: int, k: int, d: Optional[int] = None
) -> Tuple[int, int, int, int]:
    """(block_n, num_bins, rescore_m, q_tile): the JAX plan, verbatim.

    The budget arithmetic below is the JAX package's model of the TPU's
    on-chip memory ("VMEM": the f32 score tile once plus two buffers of the
    bf16 base tile within 120 MB). It is kept bit-for-bit because block_n
    and num_bins define which candidates survive; an H100 plan is separate
    work. Bins target a total budget of max(2048, 32k) candidates across
    blocks (fewer blocks -> more bins per block), capped at block_n
    (per_bin = 1 is an exact scan of tiny datasets).
    """
    if n >= 4_000_000:
        block_n = 65536
    elif n >= 32768:
        block_n = 32768
    else:
        block_n = max(256, 1 << (n - 1).bit_length())
    dpad = 128 if d is None else ((d + 1 + 127) // 128) * 128
    budget = 120 * 1024 * 1024
    q_tile = 512
    while q_tile > 256 and block_n * (q_tile * 4 + 2 * dpad * 2) > budget:
        q_tile //= 2
    while block_n > 1024 and block_n * (q_tile * 4 + 2 * dpad * 2) > budget:
        block_n //= 2
    n_blocks = (n + block_n - 1) // block_n
    target = max(2048, 32 * k)
    nb = 1 << (max(
        64, (target + n_blocks - 1) // n_blocks,
        1 << (k - 1).bit_length(),
    ) - 1).bit_length()
    num_bins = min(nb, block_n)
    rescore_m = min(num_bins, max(32, 1 << (k - 1).bit_length()))
    return block_n, num_bins, rescore_m, q_tile


def make_pallas_base(vectors: torch.Tensor, block_n: int) -> torch.Tensor:
    """(n_pad, dpad) bf16 copy of `vectors` with the bias column at d.

    Layout of the JAX package's _pallas_base: rows padded to a block_n
    multiple, columns to a multiple of 128 with at least one spare; the
    bias column is 1.0 on real rows (3.0 on the query side), so the
    product carries the kernel's +3.0 score shift. Pad rows and columns
    are zero.
    """
    n, d = vectors.shape
    dpad = ((d + 1 + 127) // 128) * 128
    n_pad = ((n + block_n - 1) // block_n) * block_n
    base = torch.zeros((n_pad, dpad), dtype=torch.bfloat16, device=vectors.device)
    base[:n, :d] = vectors.to(torch.bfloat16)
    base[:n, d] = 1.0
    return base


def _pallas_base(index, block_n: int) -> torch.Tensor:
    """make_pallas_base cached on the index, so repeated searches pay no
    re-padding. The cache is keyed by the vectors tensor and block_n."""
    cache = index.pallas_base_cache
    key = (id(index.vectors), block_n)
    hit = cache.get(key)
    if hit is not None and hit[0] is index.vectors:
        return hit[1]
    base = make_pallas_base(index.vectors, block_n)
    cache.clear()
    cache[key] = (index.vectors, base)
    return base


def _ids_pack_spec(n: int, k: int) -> Tuple[int, int]:
    """(bits, words) for bit-packing (Q, k) ids in [-1, n) into 32-bit
    words; the value n encodes the empty sentinel (-1)."""
    bits = max(1, int(n).bit_length())  # represents values 0..n inclusive
    words = (k * bits + 31) // 32
    return bits, words


def _pack_ids_device(ids: torch.Tensor, *, n: int, bits: int, words: int):
    """Bit-pack (Q, k) ids into (Q, words) int32 words, -1 -> n.

    PyTorch has no uint32 shifts, so the words are built in int64 and
    masked to 32 bits; the result is their int32 two's-complement image,
    which the host reads as uint32 (bit-identical to the JAX package's
    uint32 words).
    """
    k = ids.shape[1]
    v = torch.where(ids < 0, n, ids).to(torch.int64)
    out = torch.zeros((ids.shape[0], words), dtype=torch.int64, device=ids.device)
    mask32 = (1 << 32) - 1
    for i in range(k):
        off = i * bits
        w, s = off // 32, off % 32
        out[:, w] |= (v[:, i] << s) & mask32
        if s + bits > 32:
            out[:, w + 1] |= v[:, i] >> (32 - s)
    out = torch.where(out >= (1 << 31), out - (1 << 32), out)
    return out.to(torch.int32)


def _unpack_ids_host(words_np: np.ndarray, *, n: int, bits: int, k: int):
    """Exact host-side inverse of _pack_ids_device (numpy)."""
    w64 = words_np.astype(np.uint64)
    mask = np.uint64((1 << bits) - 1)
    ids = np.empty((words_np.shape[0], k), np.int64)
    for i in range(k):
        off = i * bits
        w, s = off // 32, off % 32
        val = w64[:, w] >> np.uint64(s)
        if s + bits > 32:
            val = val | (w64[:, w + 1] << np.uint64(32 - s))
        ids[:, i] = (val & mask).astype(np.int64)
    return np.where(ids == n, -1, ids).astype(np.int32)


def scan_search(
    index,
    queries,
    k: Optional[int] = None,
    recall_target: float = 0.95,
    exact: bool = False,
    batch_q: int = 2048,
    use_pallas: bool = False,
    pull: str = "packed",
    pallas_auto_route: bool = True,
    exact_certify: bool = True,
    exact_eps: float = 1e-6,
):
    """Full dense scan of the index vectors (the C=1 full-probe case).

    Returns (distances ascending (Q, k) numpy or None, ids (Q, k) int32
    numpy, DenseSearchStats), the JAX contract. Arguments as in the JAX
    function:

    pull: "packed" (distances and ids), "ids" (ids only; distances None)
      or "ids-packed" (ids bit-packed to ceil(log2(n+1)) bits on the
      device, unpacked exactly on the host; distances None).
    use_pallas: the fused kernel path (K1 on a CUDA device).
    pallas_auto_route: with use_pallas, run the plain scan below
      PALLAS_SCAN_MIN_N; False pins the kernel path.
    exact / exact_certify / exact_eps: the exact scan; with the default
      pull it runs the certified algorithm and re-runs the queries whose
      certificate fails through the direct exact sort (counted in
      stats.uncertified).
    """
    k = index.config.k if k is None else k
    dev = index.vectors.device
    qn = as_device_f32(queries, dev)
    if qn.dim() == 1:
        qn = qn[None, :]
    n = index.vectors.shape[0]
    if qn.shape[0] == 0:
        empty_d = (None if pull in ("ids", "ids-packed")
                   else np.zeros((0, k), np.float32))
        return (
            empty_d,
            np.zeros((0, k), np.int32),
            DenseSearchStats(
                distance_computations=np.zeros(0, np.int32),
                candidates=np.zeros(0, np.int32),
                clusters_visited=np.zeros(0, np.int32),
                dropped_probes=np.int32(0),
                uncertified=np.zeros(0, np.int32),
            ),
        )

    if use_pallas and pallas_auto_route and not pallas_scan_viable(
        n, d=int(index.vectors.shape[1])
    ):
        use_pallas = False  # below the routing threshold: plain scan

    bits = words = None
    if pull == "ids-packed":
        bits, words = _ids_pack_spec(n, k)
    outs_s, outs_i, uncert_rows = [], [], []
    if use_pallas:
        from clann_tpu_torch.ops.scan_topk import fused_scan_topk_e2e

        block_n, num_bins, rescore_m, q_tile = pallas_scan_plan(
            n, k, d=int(index.vectors.shape[1])
        )
        base_p = _pallas_base(index, block_n)
        for s in range(0, qn.shape[0], batch_q):
            with TRACER.span("scan/sub_batch"):
                ts, ti = fused_scan_topk_e2e(
                    base_p, index.vectors, qn[s : s + batch_q],
                    n_real=n, k=k, rescore_m=rescore_m,
                    num_bins=num_bins, block_n=block_n, q_tile=q_tile,
                    normalize=True, biased=True,
                )
            outs_s.append(ts)
            outs_i.append(ti)
    else:
        # bound the transient (batch, block) score matrix to ~4 GB
        block_points = min(
            262144, n,
            max(32768, int(4e9 / (4 * min(batch_q, qn.shape[0])))),
        )
        certify = exact and exact_certify and pull == "packed"
        for s in range(0, qn.shape[0], batch_q):
            blk = qn[s : s + batch_q]
            if not certify:
                ts, ti = _dense_scan_impl(
                    index.vectors, blk, k=k, block_points=block_points,
                    recall_target=recall_target, exact=exact,
                    normalize_queries=True,
                )
            else:
                ts, ti, cts = _certified_scan_impl(
                    index.vectors, blk, k=k, block_points=block_points,
                    recall_target=max(recall_target, 0.95), eps=exact_eps,
                    normalize_queries=True,
                )
                bad = cts != k
                uncert_rows.append(bad.to(torch.int32))
                bidx = torch.nonzero(bad).flatten()
                if bidx.numel():
                    es, ei = _dense_scan_impl(
                        index.vectors, blk[bidx], k=k,
                        block_points=block_points,
                        recall_target=recall_target, exact=True,
                        normalize_queries=True,
                    )
                    ts[bidx] = es
                    ti[bidx] = ei
            outs_s.append(ts)
            outs_i.append(ti)

    ids_dev = torch.cat(outs_i)
    Q = ids_dev.shape[0]
    if pull == "ids-packed":
        ids_dev = _pack_ids_device(ids_dev, n=n, bits=bits, words=words)
    with TRACER.span("search/pull"):  # waits for the scan
        uncert = (torch.cat(uncert_rows).cpu().numpy() if uncert_rows
                  else np.zeros(Q, np.int32))
        ids = ids_dev.cpu().numpy()
        dots = None if pull in ("ids", "ids-packed") else torch.cat(outs_s).cpu().numpy()
    with TRACER.span("search/to_numpy"):
        dc = np.full(Q, n, np.int32)
        stats = DenseSearchStats(
            distance_computations=dc,
            candidates=dc,
            clusters_visited=np.full(Q, index.n_clusters, np.int32),
            dropped_probes=np.int32(0),
            uncertified=uncert,
        )
        if pull == "ids-packed":
            return None, _unpack_ids_host(ids.view(np.uint32), n=n, bits=bits, k=k), stats
        ids = ids.astype(np.int32)
        if dots is None:
            return None, ids, stats
        dists = np.where(ids >= 0, np.clip(1.0 - dots, 0.0, 2.0), np.inf)
        return dists, ids, stats


def _dedup_topk_np(cat_s: np.ndarray, cat_i: np.ndarray, k: int):
    """Host-side per-row top-k with id dedup (best sim per id kept).

    cat_s/cat_i: (Q, M) candidate sims/ids, -1 = empty; the adaptive wave
    merge, where re-probed rows (last-wave padding) can surface an id twice."""
    o = np.argsort(-cat_s, axis=1, kind="stable")
    s = np.take_along_axis(cat_s, o, axis=1)
    i = np.take_along_axis(cat_i, o, axis=1)
    # group equal ids (stable keeps sim-desc order within a group), mask
    # every occurrence after the first, then restore sim order
    o2 = np.argsort(i, axis=1, kind="stable")
    i2 = np.take_along_axis(i, o2, axis=1)
    dup2 = np.zeros_like(i2, bool)
    dup2[:, 1:] = (i2[:, 1:] == i2[:, :-1]) & (i2[:, 1:] >= 0)
    dup = np.zeros_like(dup2)
    np.put_along_axis(dup, o2, dup2, axis=1)
    s = np.where(dup, -1.0, s)
    i = np.where(dup, -1, i)
    o3 = np.argsort(-s, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(s, o3, axis=1), np.take_along_axis(i, o3, axis=1)


def auto_probe_cap(n_queries: int, n_probe: int, n_clusters: int) -> int:
    """Slot capacity per row: 4x the average load, padded to 8."""
    avg = n_queries * n_probe / max(1, n_clusters)
    cap = int(max(8, min(n_queries, 4 * avg)))
    return (cap + 7) // 8 * 8


# f32 scores per group of rows in ivf_search_batch_impl (the JAX budget)
SCORE_BUDGET = 1 << 30


def ivf_search_batch_impl(index, queries_n: torch.Tensor, *, k: int, n_probe: int,
                          probe_cap: int, probe_rows: Optional[torch.Tensor] = None,
                          approx_topk: bool = True):
    """Dense probe search of one batch of normalized queries.

    Returns (sims desc (Q, k), global ids (Q, k) int32, DenseSearchStats of
    tensors). probe_rows: explicit (Q, P) segment rows to probe (the
    adaptive waves); else the n_probe rows nearest by center distance.
    Every top-k here is exact, whatever `approx_topk` says: JAX's
    `approx_max_k` is a TPU binning and lowers to the exact top-k
    elsewhere, so the keyword is accepted and changes nothing.
    """
    Q, d = queries_n.shape
    dev = queries_n.device
    C = index.seg_centers.shape[0]  # segment ROWS
    S_max = index.seg_vectors.shape[1]
    cap = probe_cap
    seg_sizes = index.seg_sizes

    with TRACER.span("ivf/probe"):
        # 1. rank rows per query (index.rs:592-616; rows of one cluster share a
        # center, exact ties that lax.top_k breaks toward the lower row)
        center_dist = torch.clamp(1.0 - exact_dot(queries_n, index.seg_centers.T), 0.0, 2.0)
        if probe_rows is None:
            P = min(n_probe, C)
            probe = topk_stable(-center_dist, P)[1]
        else:
            probe = probe_rows.to(device=dev, dtype=torch.int64)
            P = probe.shape[1]

        # 2. invert to row-major padded query lists: a stable sort keeps each
        # row's queries ascending (JAX's sort leaves that order open; it
        # decides only which probes a full row drops)
        sc, flat = torch.sort(probe.reshape(-1), stable=True)
        sq, sp = torch.div(flat, P, rounding_mode="floor"), flat % P
        crange = torch.arange(C, device=dev)
        cl_start = torch.searchsorted(sc, crange, side="left")
        counts = torch.searchsorted(sc, crange, side="right") - cl_start  # probes per row
        jj = torch.arange(cap, device=dev)
        take = torch.clamp(cl_start[:, None] + jj[None, :], 0, Q * P - 1)
        slot_valid = jj[None, :] < counts[:, None]  # (C, cap)
        qidx = torch.where(slot_valid, sq[take], Q)  # Q == dump row
        pidx = torch.where(slot_valid, sp[take], 0)
        dropped = torch.sum(torch.clamp(counts - cap, min=0))

    with TRACER.span("ivf/scan"):
        # 3+4. score groups of rows (a fixed budget of f32 scores per group),
        # each reduced at once to a top-k per (row, slot)
        kk = min(k, S_max)
        qpad = torch.cat([queries_n, queries_n.new_zeros((1, d))])
        col = torch.arange(S_max, device=dev)
        group = max(1, min(C, SCORE_BUDGET // max(1, cap * S_max * 4)))
        top_s = torch.empty((C, cap, kk), dtype=torch.float32, device=dev)
        top_i = torch.empty((C, cap, kk), dtype=torch.int32, device=dev)
        for g0 in range(0, C, group):
            rows = slice(g0, min(C, g0 + group))
            qv = qpad[qidx[rows]]  # (group, cap, d); the dump row scores zeros
            dots = torch.bmm(qv, index.seg_vectors[rows].transpose(1, 2))  # (group, cap, S_max)
            sims = torch.clamp((dots + 1.0) * 0.5, 0.0, 1.0)  # cosine.hpp:19-23
            ok = (slot_valid[rows][:, :, None]
                  & (col[None, :] < seg_sizes[rows][:, None])[:, None, :])
            ts, tj = torch.topk(torch.where(ok, sims, -1.0), kk, dim=2)
            top_s[rows] = ts
            top_i[rows] = torch.gather(index.seg_ids[rows][:, None, :].expand(-1, cap, -1), 2, tj)
        if kk < k:
            top_s = torch.nn.functional.pad(top_s, (0, k - kk), value=-1.0)
            top_i = torch.nn.functional.pad(top_i, (0, k - kk), value=-1)
        out_s = torch.full((Q + 1, P, k), -1.0, dtype=torch.float32, device=dev)
        out_i = torch.full((Q + 1, P, k), -1, dtype=torch.int32, device=dev)
        out_s.index_put_((qidx, pidx), top_s)
        out_i.index_put_((qidx, pidx), top_i)
        final_s, sel = topk_stable(out_s[:Q].reshape(Q, P * k), k)
        final_i = torch.gather(out_i[:Q].reshape(Q, P * k), 1, sel)
        final_i = torch.where((final_s < 0) | (final_i < 0), -1, final_i)
        final_s = torch.clamp(final_s, min=0.0)

        # stats + ball-overlap certificate (index.rs:342-361, per row with the
        # owner cluster's radius). probed_ok: the (query, probe) pairs actually
        # scanned — a probe dropped by a full row certifies nothing
        probed_ok = torch.zeros((Q + 1, P), dtype=torch.bool, device=dev)
        probed_ok.index_put_((qidx, pidx), torch.ones_like(qidx, dtype=torch.bool))
        probed_ok = probed_ok[:Q]
        probed_sizes = seg_sizes[probe] * probed_ok  # (Q, P)
        kth_dist = torch.where(final_i[:, k - 1] >= 0, 2.0 * (1.0 - final_s[:, k - 1]), torch.inf)
        overlapping = (center_dist - index.seg_radii[None, :]) <= kth_dist[:, None]  # (Q, C)
        is_probed = torch.zeros((Q, C), dtype=torch.int32, device=dev).scatter_add_(
            1, probe, probed_ok.to(torch.int32)) > 0
        uncertified = torch.sum(overlapping & ~is_probed & (seg_sizes[None, :] > 0), dim=1)
        stats = DenseSearchStats(
            distance_computations=probed_sizes.sum(dim=1, dtype=torch.int32),
            candidates=probed_sizes.sum(dim=1, dtype=torch.int32),
            clusters_visited=probed_ok.sum(dim=1, dtype=torch.int32),
            dropped_probes=dropped.to(torch.int32),
            uncertified=uncertified.to(torch.int32),
            probed_clusters=index.seg_cluster[probe],
            probed_counts=probed_sizes.to(torch.int32),
        )
    return final_s, final_i, stats


def _require_layout(index) -> None:
    if index.seg_vectors is None:
        raise ValueError(
            "index was built without the dense layout "
            "(config.dense_layout=False); use the lsh search path"
        )


def _queries(index, queries) -> torch.Tensor:
    q = as_device_f32(queries, index.device)
    return l2_normalize(q[None, :] if q.dim() == 1 else q)


def adaptive_dense_search(index, queries, k: Optional[int] = None, wave: int = 16,
                          max_waves: Optional[int] = None,
                          probe_cap: Optional[int] = None):
    """Adaptive dense probing: waves of `wave` segment rows, in center-
    distance order, until the ball-overlap certificate retires each query
    (index.rs:331-439 with its non-metric caveat, index.rs:342-361). Run to
    completion it is exact up to that caveat. A wave whose capacity
    overflows is rerun at twice the capacity (up to Q, which cannot drop).

    Returns numpy (distances ascending, ids, DenseSearchStats).
    """
    _require_layout(index)
    cfg = index.config
    k = cfg.k if k is None else k
    R = int(index.seg_centers.shape[0])
    # a wave never exceeds the row count, which keeps the last wave's
    # padding (drawn from wave 0) disjoint from the wave itself
    wave = min(wave, R)
    max_waves = max_waves or -(-R // wave)
    qn = _queries(index, queries)
    Q = qn.shape[0]
    cap = probe_cap or cfg.probe_cap or auto_probe_cap(Q, wave, R)

    center_dist = torch.clamp(1.0 - exact_dot(qn, index.seg_centers.T), 0.0, 2.0).cpu().numpy()
    # stable: rows of a split cluster tie exactly (JAX's quicksort orders
    # them arbitrarily)
    order = np.argsort(center_dist, axis=1, kind="stable").astype(np.int64)  # (Q, R)
    radii = index.seg_radii.cpu().numpy()
    seg_sizes = index.seg_sizes.cpu().numpy()

    top_s = np.zeros((Q, k), np.float32)
    top_i = np.full((Q, k), -1, np.int32)
    done = np.zeros(Q, bool)
    dc = np.zeros(Q, np.int64)
    visited = np.zeros(Q, np.int32)
    for w in range(max_waves):
        lo = w * wave
        hi = min(lo + wave, R)
        probe_w = order[:, lo:hi]
        n_real_w = probe_w.shape[1]
        if n_real_w < wave:
            # pad with DISTINCT already-probed rows (wave 0 is full):
            # re-probing them is idempotent under the id-dedup merge
            probe_w = np.concatenate([probe_w, order[:, : wave - n_real_w]], axis=1)
        probe_t = torch.as_tensor(probe_w, device=index.device)
        cap_w = cap
        while True:
            sims, ids, wst = ivf_search_batch_impl(index, qn, k=k, n_probe=wave,
                                                   probe_cap=cap_w, probe_rows=probe_t)
            if cap_w >= Q or int(wst.dropped_probes) == 0:
                break
            cap_w = min(Q, 2 * cap_w)
        with TRACER.span("search/pull"):
            sims, ids = sims.cpu().numpy(), ids.cpu().numpy()
        active = ~done
        cat_s = np.concatenate([top_s, np.where(active[:, None], sims, -1)], 1)
        cat_i = np.concatenate([top_i, np.where(active[:, None], ids, -1)], 1)
        top_s, top_i = _dedup_topk_np(cat_s, cat_i, k)
        dc += np.where(active, seg_sizes[probe_w[:, :n_real_w]].sum(axis=1), 0)
        visited += np.where(active, hi - lo, 0).astype(np.int32)
        # certificate: can the next unvisited row improve the k-th?
        if hi >= R:
            done[:] = True
        else:
            nxt = order[:, hi]
            kth_dist = np.where(top_i[:, k - 1] >= 0, 2.0 * (1.0 - top_s[:, k - 1]), np.inf)
            done |= center_dist[np.arange(Q), nxt] - radii[nxt] > kth_dist
        if done.all():
            break

    dists = np.where(top_i >= 0, 2.0 * (1.0 - top_s), np.inf)
    stats = DenseSearchStats(
        distance_computations=dc.astype(np.int32),
        candidates=dc.astype(np.int32),
        clusters_visited=visited,
        dropped_probes=np.int32(0),
        uncertified=(~done).astype(np.int32),
    )
    return dists, top_i, stats


def dense_search(index, queries, k: Optional[int] = None, n_probe: Optional[int] = None,
                 probe_cap: Optional[int] = None, batch_size: int = 2048,
                 approx_topk: bool = True):
    """Dense IVF search of a query set in batches of `batch_size`.

    Returns numpy (distances ascending, ids, DenseSearchStats). n_probe
    defaults to config.n_probe or auto_n_probe(R); probe_cap to
    config.probe_cap or auto_probe_cap per batch. A short last batch (of a
    set larger than one batch) repeats its last query up to batch_size, as
    zero rows would tie at every center and crowd the first rows' slots.
    `approx_topk` is accepted and changes nothing (ivf_search_batch_impl).
    """
    _require_layout(index)
    cfg = index.config
    k = cfg.k if k is None else k
    C = index.seg_centers.shape[0]  # segment rows
    if n_probe is None:
        n_probe = cfg.n_probe or auto_n_probe(C)
    qn = _queries(index, queries)

    out_s, out_i, out_st = [], [], []
    for start in range(0, qn.shape[0], batch_size):
        block = qn[start : start + batch_size]
        pad = 0
        if block.shape[0] < batch_size and qn.shape[0] > batch_size:
            pad = batch_size - block.shape[0]
            block = torch.cat([block, block[-1:].expand(pad, -1)])
        cap = probe_cap or cfg.probe_cap or auto_probe_cap(block.shape[0], min(n_probe, C), C)
        sims, ids, stats = ivf_search_batch_impl(index, block, k=k, n_probe=n_probe,
                                                 probe_cap=cap)
        keep = block.shape[0] - pad
        with TRACER.span("search/pull"):  # waits for the block's device work
            out_s.append(sims[:keep].cpu().numpy())
            out_i.append(ids[:keep].cpu().numpy())
            # dropped_probes counts the batches' pad rows too, as JAX's does
            out_st.append({f: int(v) if f == "dropped_probes" else v[:keep].cpu().numpy()
                           for f, v in zip(DenseSearchStats._fields, stats)})

    with TRACER.span("search/to_numpy"):
        sims = np.concatenate(out_s, axis=0)
        ids = np.concatenate(out_i, axis=0)
        stats = DenseSearchStats(**{
            f: np.sum([st[f] for st in out_st]) if f == "dropped_probes"
            else np.concatenate([st[f] for st in out_st])
            for f in DenseSearchStats._fields})
        dists = 2.0 * (1.0 - sims)
        dists = np.where(ids < 0, np.inf, dists)
    return dists, ids, stats
