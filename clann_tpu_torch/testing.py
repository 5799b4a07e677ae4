"""Comparison helpers shared by the parity tests and ``chip_smoke.py``.

numpy / torch only. Two rules recur:

- top-k results are compared per query as SETS of ids, because
  ``torch.topk`` gives no order for ties while ``lax.top_k`` prefers the
  lower index; an id may differ only where its similarity ties the k-th
  one (within `tie_eps`).
- packed kernel winners are compared by the row they name and by the
  decoded value, which may differ by one quantization step (pg * 2^-22 in
  [2, 4); 2^-6 there when the scores are rounded to bf16) where two f32
  sums taken in another order straddle a step.
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
        DENSE_FIELDS, GEOMETRY_FIELDS, LSH_FIELDS, META_FIELDS, PARAM_FIELDS)

    def arr(v):
        return None if v is None else np.asarray(v.cpu() if isinstance(v, torch.Tensor) else v)

    out: Dict[str, object] = {f: arr(getattr(index, f)) for f in GEOMETRY_FIELDS}
    out.update({f: arr(getattr(index, f, None)) for f in (*LSH_FIELDS, *DENSE_FIELDS)})
    out.update({f: getattr(index, f) for f in META_FIELDS if hasattr(index, f)})
    for f in PARAM_FIELDS:
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


def decode_winners(packed, per_bin: int, group_r: int = 1):
    """(row in bin, decoded value) of K1 packed winners (numpy), as the JAX
    decode reads them: the low log2(pg) bits (pg = per_bin / group_r) hold
    the winning group, whose first row is returned."""
    pg = per_bin // group_r
    p = np.asarray(packed, dtype=np.int32)
    sub = (p & (pg - 1)) * group_r
    val = (p & ~(pg - 1)).view(np.float32).astype(np.float64) - 3.0
    return sub, val


def packed_agreement(packed_a, packed_b, per_bin: int,
                     n_bins_real: int = None, group_r: int = 1) -> Dict[str, float]:
    """Agreement of two (n_bins_total, q_pad) K1 outputs over the first
    `n_bins_real` bins: the fraction of (bin, query) winners naming the same
    row (group, with `group_r`), and the largest decoded value
    difference."""
    if isinstance(packed_a, torch.Tensor):
        packed_a = packed_a.cpu().numpy()
    if isinstance(packed_b, torch.Tensor):
        packed_b = packed_b.cpu().numpy()
    if n_bins_real is not None:
        packed_a, packed_b = packed_a[:n_bins_real], packed_b[:n_bins_real]
    sa, va = decode_winners(packed_a, per_bin, group_r)
    sb, vb = decode_winners(packed_b, per_bin, group_r)
    return {
        "same_winner": float(np.mean(sa == sb)),
        "identical": float(np.mean(packed_a == packed_b)),
        "max_abs_err": float(np.max(np.abs(va - vb))) if va.size else 0.0,
    }


def sharded_real_slot_mismatches(a, b) -> list:
    """Fields of two sharded indexes (parallel/sharded.ShardedIndex) that
    differ on a real slot. Only the real slots are compared, since the pad
    lengths may differ (build_sharded rounds n_max up to gather_block).
    The two may lie on different devices (b's shards are compared on a's).
    Returns the names, with the shard, of the fields that differ."""
    if a.shard_points != b.shard_points:
        return ["shard_points"]

    def equal(x, y):
        return torch.equal(x, y.to(x.device))

    bad = []
    for s, n_loc in enumerate(a.shard_points):
        for f in ("vectors", "sketches", "global_ids", "assignment"):
            if not equal(getattr(a, f)[s][:n_loc], getattr(b, f)[s][:n_loc]):
                bad.append(f"{f}[{s}]")
        for f in ("sorted_hash", "sorted_idx", "g_sorted_hash", "g_records", "slot_records"):
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None):
                bad.append(f)
            elif x is not None and not equal(x[s][:, :n_loc], y[s][:, :n_loc]):
                bad.append(f"{f}[{s}]")
        for f in ("cluster_starts", "centers", "center_ids", "radii", "brute", "g_dir"):
            x, y = getattr(a, f), getattr(b, f)
            if (x is None) != (y is None):
                bad.append(f)
            elif x is not None and not equal(x[s], y[s]):
                bad.append(f"{f}[{s}]")
    return bad


# The window filter's edge cases (window_filter_case's `case`): what each
# forces on every query of a seeded random window.
WINDOW_CASES = ("random", "qdone", "short", "all_pass", "none_pass")
# The cases the window filter is held to, on the CPU against the engine's
# former chain and on the card against its plain version: (case, G, WB,
# chunk, cap, filter on, dead_block_routing, seed) on 24 queries of 10
# tables of 997 slots and 37 clusters: the engine's shape at the tests'
# size (G 8, chunk 512, filter_expand 8 -> WB 512, cap chunk + G), then the
# edge cases.
WINDOW_FILTER_CASES = {
    "random": ("random", 8, 512, 512, 520, True, True, 0),
    "qdone rows": ("qdone", 8, 512, 512, 520, True, True, 1),
    "fully masked blocks past the streams' ends": ("short", 8, 64, 128, 136, True, True, 2),
    "every lane passes: consumed stops at chunk": ("all_pass", 8, 64, 40, 48, True, True, 3),
    "chunk below G: consumed held at 1, ranks past cap dropped":
        ("all_pass", 8, 16, 3, 5, True, True, 4),
    "none pass": ("none_pass", 8, 64, 128, 136, True, True, 5),
    "filter_type none": ("random", 8, 64, 128, 136, False, True, 6),
    "dead_block_routing off": ("qdone", 8, 64, 128, 136, True, False, 7),
    "G 32 (one mask word a block)": ("random", 32, 64, 512, 544, True, True, 8),
    "G 64 (two mask words a block; no stream map)": ("short", 64, 16, 256, 320, True, True, 9),
    "G 1": ("random", 1, 100, 37, 38, True, True, 10),
}
WINDOW_FILTER_SHAPE = dict(q=24, tables=10, slots=997, clusters=37)


def window_filter_case(*, q: int, tables: int, slots: int, gather_block: int, wb: int,
                       clusters: int, case: str = "random", sketches: int = 32,
                       sketch_words: int = 2, ranges: int = 0, seed: int = 0,
                       device="cpu") -> Dict[str, object]:
    """Seeded random operands of `ops.window_filter.window_filter`, made as
    the global engine makes them: (Q, M) stream ranges over `tables`
    hash-sorted tables of `slots` slots (M = `ranges`, default 3 a table),
    their block stream (`fc`, `bstarts`), its stream map `smap` (G <= 32;
    else None), cursors `off` inside each stream, records (L, n_pad,
    2 + Wd) with clusters a little outside [0, C) (the filter clamps),
    query sketches, ball bounds, k-th distances and sketch thresholds.
    `case` (WINDOW_CASES): "qdone" marks a third of the queries done,
    "short" gives most queries fewer blocks than the window (fully masked
    blocks past the stream's end), "all_pass" makes every cluster feasible
    and every sketch pass, "none_pass" none."""
    from clann_tpu_torch.ops.prefixmap import block_stream, stream_block_map

    if case not in WINDOW_CASES:
        raise ValueError(f"case {case!r} not in {WINDOW_CASES}")
    G, dev = gather_block, torch.device(device)
    g_log = G.bit_length() - 1
    gen = torch.Generator(device="cpu").manual_seed(seed)
    big = torch.Generator(device=dev).manual_seed(seed)  # the records, made where they live

    def ints(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=gen, dtype=torch.int64)

    M = ranges or 3 * tables
    long_share = 0.15 if case == "short" else 0.85
    scale = torch.where(torch.rand((q, 1), generator=gen) < long_share, 6 * G, 1)
    sizes = torch.minimum(ints(0, 1 << 30, (q, M)) % (scale + 1), torch.tensor(slots))
    sizes = torch.where(torch.rand((q, M), generator=gen) < 0.2, 0, sizes)
    starts = ints(0, 1 << 30, (q, M)) % (slots - sizes + 1)
    starts, sizes = starts.to(torch.int32), sizes.to(torch.int32)
    bstarts, bcounts = block_stream(starts, sizes, g_log)
    fc = torch.cumsum(bcounts, dim=1, dtype=torch.int32)
    total = fc[:, -1]
    off = (torch.rand((q,), generator=gen) * (total.to(torch.float32) + 1)).to(torch.int32)
    off = torch.minimum(off, total)
    smap = None
    if G <= 32:
        tb = 1 << max(int(total.max()) + wb, 1).bit_length()
        smap = stream_block_map(fc, bstarts, starts, sizes, g_log, tables, tb)

    n_pad = -(-slots // G) * G
    W = sketch_words
    records = torch.cat([
        torch.randint(lo, hi, (tables, n_pad, w), generator=big, dtype=torch.int64,
                      device=dev).to(torch.int32)
        for lo, hi, w in ((0, slots, 1), (-(1 << 31), 1 << 31, W), (-2, clusters + 2, 1))],
        dim=2)
    qsk = ints(-(1 << 31), 1 << 31, (q, sketches, W)).to(torch.int32)
    feas_bound = torch.rand((q, clusters), generator=gen) * 2.0 - 1.0
    kth_dist = torch.rand((q,), generator=gen) * 1.2 - 0.2
    kth_dist = torch.where(torch.rand((q,), generator=gen) < 0.1, torch.inf, kth_dist)
    maxdiff = ints(16 * W - 2, 16 * W + 3, (q,)).to(torch.int32)
    qdone = torch.zeros((q,), dtype=torch.bool)
    if case == "qdone":
        qdone = torch.rand((q,), generator=gen) < 1 / 3
    elif case == "all_pass":
        kth_dist = torch.full((q,), torch.inf)
        maxdiff = torch.full((q,), 32 * W, dtype=torch.int32)
    elif case == "none_pass":
        kth_dist = torch.full((q,), -torch.inf)
        maxdiff = torch.full((q,), -1, dtype=torch.int32)
    out = dict(records=records, starts=starts, sizes=sizes, bstarts=bstarts, fc=fc, off=off,
               smap=smap, qdone=qdone, qsk=qsk, feas_bound=feas_bound.to(torch.float32),
               kth_dist=kth_dist.to(torch.float32), maxdiff=maxdiff)
    out = {k: None if v is None else v.to(dev) for k, v in out.items()}  # records: there
    out.update(g_log=g_log, wb=wb, n_sentinel=slots)
    return out


def packed_derived_window(case: Dict[str, object], tables: int) -> torch.Tensor:
    """The in-loop derivation of a `window_filter_case`'s next WB blocks
    at its cursors, packed by the global engine's `derived_window`."""
    from clann_tpu_torch.ops.global_query import derived_window

    return derived_window(case, case["off"], wb=case["wb"], gather_block=1 << case["g_log"],
                          tables=tables, dense_index=False)


def run_window_filter(fn, case: Dict[str, object], *, use_map: bool, chunk: int, cap: int,
                      use_filter: bool, routing: bool, loop_stats=None):
    """`fn` (ops.window_filter's wrapper or plain version) on a
    `window_filter_case`: its stream map, or its derived window packed."""
    tables = case["records"].shape[0]
    window = case["smap"] if use_map else packed_derived_window(case, tables)
    return fn(case["records"], window, case["off"], case["qdone"], case["qsk"],
              case["feas_bound"], case["kth_dist"], case["maxdiff"],
              gather_block=1 << case["g_log"], wb=case["wb"], chunk=chunk, cap=cap,
              n_sentinel=case["n_sentinel"], use_filter=use_filter, routing=routing,
              loop_stats=loop_stats)


# The score-and-merge's cases (score_merge_case's `case`): what each forces
# on every query's row of candidate slots.
SCORE_MERGE_CASES = ("random", "compacted", "duplicates", "in_topk", "sentinels",
                     "all_sentinel", "full_row", "sim_zero", "equal_sims", "empty_topk")
# The shape the score-and-merge is held to on the CPU: (Q, n, d, CB); kk
# is 10 with f32 rows and 20 (2k) with int8 rows, as in the engine.
SCORE_MERGE_SHAPE = dict(q=12, n=600, d=13, cb=72)
_TWINS = 4  # rows of a twin group: equal sims on distinct ids


def score_merge_case(*, q: int, n: int, d: int, cb: int, kk: int, int8: bool = False,
                     case: str = "random", seed: int = 0, device="cpu") -> Dict[str, object]:
    """Seeded operands of `ops.score_merge.score_merge`, made as the global
    engine makes them: vectors (n, d) (unit rows, or their int8 shadows
    with `int8`) and queries; a running top-kk per query (distinct ids of
    unit rows, their sims in descending order, empty slots (0, -1) after
    them); (Q, CB) candidate slots whose live ids sit anywhere in the row
    ("compacted": at its front, as the window filter writes them), the
    sentinel n elsewhere. Rows [0, 32) form twin groups of 4 equal rows
    (equal sims on distinct ids); rows [n - 4Q, n) hold 4 rows a query at
    -2x the query, whose sims are exactly 0. `case` (SCORE_MERGE_CASES)
    picks the live ids: "random" a mix of every kind below, "duplicates"
    from a few ids, "in_topk" mostly the query's top-kk ids, "sentinels"
    also sentinels above n, "all_sentinel" none (done queries),
    "full_row" every slot live, "sim_zero" the query's sim-0 rows against
    an empty top-kk, "equal_sims" twins (also in the top-kk), "empty_topk"
    random ids into an empty top-kk."""
    from clann_tpu_torch.core.index import quantize_q8
    from clann_tpu_torch.ops.query import score_rows

    if case not in SCORE_MERGE_CASES:
        raise ValueError(f"case {case!r} not in {SCORE_MERGE_CASES}")
    if n < 4 * q + 8 * _TWINS + kk:
        raise ValueError(f"n {n} too small for {q} queries' sim-0 rows and the twins")
    gen = torch.Generator().manual_seed(seed)

    def unit(x):
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)

    def ints(hi, size):
        return torch.randint(0, hi, (size,), generator=gen, dtype=torch.int64)

    qn = unit(torch.randn((q, d), generator=gen))
    vec = unit(torch.randn((n, d), generator=gen))
    n_twin, zero0 = 8 * _TWINS, n - 4 * q
    vec[:n_twin] = vec[:n_twin:_TWINS].repeat_interleave(_TWINS, dim=0)
    if int8:
        vec, queries = quantize_q8(vec), quantize_q8(qn)
        vec[zero0:] = torch.where(queries >= 0, -127, 127).to(torch.int8).repeat_interleave(
            4, dim=0)
    else:
        vec[zero0:] = -2.0 * qn.repeat_interleave(4, dim=0)
        queries = qn

    topk_sims = torch.zeros((q, kk), dtype=torch.float32)
    topk_ids = torch.full((q, kk), -1, dtype=torch.int32)
    cand = torch.full((q, cb), n, dtype=torch.int32)
    for i in range(q):
        filled = 0 if case in ("sim_zero", "empty_topk") else (
            int(ints(kk + 1, 1)) if case == "random" else kk)
        old = torch.randperm(zero0, generator=gen)[:filled]
        if case == "equal_sims":  # the top-kk holds twins of the candidates
            old = torch.cat([ints(n_twin, 2 * filled).unique()[:filled // 2],
                             old])[:filled].unique()
        if filled:
            sims = score_rows(vec, queries[i : i + 1], old[None])[0]
            sims, order = torch.sort(sims, descending=True, stable=True)
            topk_sims[i, : len(old)] = sims
            topk_ids[i, : len(old)] = old[order].to(torch.int32)
        live = {"all_sentinel": 0, "full_row": cb}.get(case, int(ints(cb + 1, 1)))
        kinds = {
            "random": ints(zero0, live),
            "duplicates": ints(zero0, max(2, live // 8))[ints(max(2, live // 8), live)],
            "in_topk": ints(zero0, live),
            "sim_zero": zero0 + 4 * i + ints(4, live),
            "equal_sims": ints(n_twin, live),
        }
        ids = kinds.get(case, ints(zero0, live))
        pick = torch.rand((live,), generator=gen)
        mine = topk_ids[i][topk_ids[i] >= 0].to(torch.int64)
        if case in ("random", "in_topk", "full_row") and len(mine):
            share = 0.6 if case == "in_topk" else 0.15
            ids = torch.where(pick < share, mine[ints(len(mine), live)], ids)
        if case in ("random", "full_row", "sim_zero", "empty_topk"):
            ids = torch.where(pick > 0.85, zero0 + 4 * i + ints(4, live), ids)
        if case in ("random", "full_row"):
            ids = torch.where((pick > 0.7) & (pick <= 0.85), ints(n_twin, live), ids)
        row = torch.full((cb,), n, dtype=torch.int64)
        if case == "sentinels":
            row = torch.where(torch.rand((cb,), generator=gen) < 0.3, n + ints(1000, cb), row)
        pos = torch.arange(live) if case == "compacted" else torch.randperm(cb, generator=gen)[:live]
        row[pos] = ids
        cand[i] = row.to(torch.int32)
    out = dict(vectors=vec, queries=queries, topk_sims=topk_sims, topk_ids=topk_ids,
               compact_ids=cand)
    out = {k: v.to(device).contiguous() for k, v in out.items()}
    out["n_sentinel"] = n
    return out


def run_score_merge(fn, case: Dict[str, object], loop_stats=None):
    """`fn` (ops.score_merge's wrapper or plain version) on a
    `score_merge_case`."""
    return fn(case["vectors"], case["queries"], case["topk_sims"], case["topk_ids"],
              case["compact_ids"], n_sentinel=case["n_sentinel"], loop_stats=loop_stats)
