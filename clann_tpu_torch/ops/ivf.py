"""Full dense scans over the index vectors (PyTorch port of the scan half
of ``clann_tpu.ops.ivf``).

`scan_search` answers a batch of queries with either the plain blocked scan
(ops/distances._dense_scan_impl, or the certified exact scan) or the fused
kernel path (ops/scan_topk.fused_scan_topk_e2e, whose candidate stage is the
hand-written CUDA kernel K1 on a CUDA device).

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

from clann_tpu_torch.ops.distances import (
    _certified_scan_impl,
    _dense_scan_impl,
    as_device_f32,
)


class DenseSearchStats(NamedTuple):
    distance_computations: np.ndarray  # (Q,) int32 — points scanned
    candidates: np.ndarray  # (Q,) int32 — == distance_computations here
    clusters_visited: np.ndarray  # (Q,) int32
    dropped_probes: np.int32  # () — always 0 for a full scan
    uncertified: np.ndarray  # (Q,) int32 — 1 where the certificate failed
    probed_clusters: Optional[np.ndarray] = None
    probed_counts: Optional[np.ndarray] = None


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
    dc = np.full(Q, n, np.int32)
    uncert = (torch.cat(uncert_rows).cpu().numpy() if uncert_rows
              else np.zeros(Q, np.int32))
    stats = DenseSearchStats(
        distance_computations=dc,
        candidates=dc,
        clusters_visited=np.full(Q, index.n_clusters, np.int32),
        dropped_probes=np.int32(0),
        uncertified=uncert,
    )
    if pull == "ids-packed":
        raw = _pack_ids_device(ids_dev, n=n, bits=bits, words=words)
        ids = _unpack_ids_host(raw.cpu().numpy().view(np.uint32), n=n,
                               bits=bits, k=k)
        return None, ids, stats
    ids = ids_dev.cpu().numpy().astype(np.int32)
    if pull == "ids":
        return None, ids, stats
    dots = torch.cat(outs_s).cpu().numpy()
    dists = np.where(ids >= 0, np.clip(1.0 - dots, 0.0, 2.0), np.inf)
    return dists, ids, stats
