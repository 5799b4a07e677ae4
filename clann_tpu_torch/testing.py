"""Comparison helpers shared by the parity tests and ``chip_smoke.py``.

numpy / torch only. Two rules recur:

- top-k results are compared per query as SETS of ids, because
  ``torch.topk`` gives no order for ties while ``lax.top_k`` prefers the
  lower index; an id may differ only where its similarity ties the k-th
  one (within `tie_eps`).
- packed kernel winners are compared by the row they name and by the
  decoded value, which may differ by one quantization step (pg * 2^-22 in
  [2, 4)) where two f32 sums taken in another order straddle a step.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def index_arrays(index) -> Dict[str, object]:
    """Everything `core.index.index_from_arrays` takes, as numpy arrays and
    scalars, read off an index of either package (e.g. a JAX-built one:
    its uint32 words are carried across as int32 bit patterns)."""
    from clann_tpu_torch.core.index import (
        DENSE_FIELDS, GEOMETRY_FIELDS, LSH_FIELDS, META_FIELDS)

    def arr(v):
        return None if v is None else np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)

    out: Dict[str, object] = {f: arr(getattr(index, f)) for f in GEOMETRY_FIELDS}
    out.update({f: arr(getattr(index, f, None)) for f in (*LSH_FIELDS, *DENSE_FIELDS)})
    out.update({f: getattr(index, f) for f in META_FIELDS if hasattr(index, f)})
    for f in ("hash_params", "sketch_params"):
        p = getattr(index, f, None)
        out[f] = None if p is None else {k: arr(v) for k, v in dict(p).items()}
    return out


def jaccard_index_arrays(index) -> Dict[str, object]:
    """Everything `core.jaccard.jaccard_index_from_arrays` takes, read off a
    Jaccard index of either package (uint32 words carried as int32 bit
    patterns on the way in)."""
    from clann_tpu_torch.core.jaccard import JACCARD_FIELDS, JACCARD_META

    def arr(v):
        return None if v is None else np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)

    out: Dict[str, object] = {f: arr(getattr(index, f, None)) for f in JACCARD_FIELDS}
    out.update({f: getattr(index, f) for f in JACCARD_META})
    for f in ("hash_params", "sketch_params"):
        out[f] = {k: arr(v) for k, v in dict(getattr(index, f)).items()}
    return out


def quant_step(pg: int) -> float:
    """Decode quantization step of the packed kernel at pg rows per bin:
    the low log2(pg) mantissa bits of a float in [2, 4) (ulp 2^-22)."""
    return pg * 2.0 ** -22


def assert_topk_match(ids_a, sims_a, ids_b, sims_b, *, atol: float = 1e-5,
                      tie_eps: float = 1e-6):
    """Assert two (Q, k) top-k results agree.

    sims (descending similarities or ascending distances) must agree
    elementwise within `atol` (inf == inf). Per query, the id sets must be
    equal except for ids whose value lies within `atol + tie_eps` of that
    query's k-th value (boundary ties).
    """
    ids_a, ids_b = np.asarray(ids_a), np.asarray(ids_b)
    sa = np.asarray(sims_a, np.float64)
    sb = np.asarray(sims_b, np.float64)
    assert ids_a.shape == ids_b.shape, (ids_a.shape, ids_b.shape)
    both_inf = np.isinf(sa) & np.isinf(sb) & (np.sign(sa) == np.sign(sb))
    diff = np.where(both_inf, 0.0, np.abs(sa - sb))
    assert np.all(diff <= atol), f"max value diff {np.nanmax(diff)} > {atol}"
    bad = []
    for r in range(ids_a.shape[0]):
        a, b = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        if a == b:
            continue
        finite = sa[r][np.isfinite(sa[r])]
        if finite.size == 0:
            bad.append(r)
            continue
        kth = finite[-1]
        va = dict(zip(ids_a[r].tolist(), sa[r].tolist()))
        vb = dict(zip(ids_b[r].tolist(), sb[r].tolist()))
        only = [va[i] for i in a - b] + [vb[i] for i in b - a]
        if not all(abs(v - kth) <= atol + tie_eps for v in only):
            bad.append(r)
    assert not bad, f"id sets differ beyond ties in rows {bad[:10]}"


def decode_winners(packed, per_bin: int):
    """(row in bin, decoded value) of K1 packed winners (numpy)."""
    p = np.asarray(packed, dtype=np.int32)
    sub = p & (per_bin - 1)
    val = (p & ~(per_bin - 1)).view(np.float32).astype(np.float64) - 3.0
    return sub, val


def packed_agreement(packed_a, packed_b, per_bin: int,
                     n_bins_real: int = None) -> Dict[str, float]:
    """Agreement of two (n_bins_total, q_pad) K1 outputs over the first
    `n_bins_real` bins: the fraction of (bin, query) winners naming the same
    row, and the largest decoded value difference."""
    if isinstance(packed_a, torch.Tensor):
        packed_a = packed_a.cpu().numpy()
    if isinstance(packed_b, torch.Tensor):
        packed_b = packed_b.cpu().numpy()
    if n_bins_real is not None:
        packed_a, packed_b = packed_a[:n_bins_real], packed_b[:n_bins_real]
    sa, va = decode_winners(packed_a, per_bin)
    sb, vb = decode_winners(packed_b, per_bin)
    return {
        "same_winner": float(np.mean(sa == sb)),
        "identical": float(np.mean(packed_a == packed_b)),
        "max_abs_err": float(np.max(np.abs(va - vb))) if va.size else 0.0,
    }
