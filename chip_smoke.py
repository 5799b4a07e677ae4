#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (clann_tpu_torch) on one GPU.

    python3 chip_smoke.py            # the whole run, on cuda:0
    python3 chip_smoke.py --profile  # also torch.profiler breakdowns

Phases, each printing a line; any failure exits non-zero (nothing is
caught):

1. device: needs torch.cuda.is_available(); prints the card's name and
   power limit and turns TF32 off for float32 matmuls and cuDNN.
2. build: compiles clann_tpu_torch/csrc/*.cu with nvcc (one process per
   source, in parallel) into build/kernels/ and prints ptxas' register /
   shared-memory / spill summary.
3. kernels vs plain, each against its plain PyTorch version on the card, at
   the main paths' shapes and at small ragged ones, then CUDA-event times of
   both at the main paths' shapes:
   K1 (packed scan; 1,183,514 x 100 -> dpad 128, block_n 32768, 64 bins,
   2,048 queries), K2 (unpacked scan; pallas_scan_topk's block_n 16384,
   128 bins, 2,048 queries), K3 (block scan; ragged shapes here, the bench
   layout with 4,096 queries at B = 9 after the build).
4. main paths on the glove-100-angular-shaped synthetic set of bench.py
   (1,183,514 x 100 train, 10,000 queries, clustered_unit_vectors with 1024
   modes, spread 0.7), exact ground truth on the card, then
   init_with_config -> build -> search_batch(mode="scan-pallas") with
   recall@10 >= 0.9 and id-recall >= 0.8, the "scan" mode and the certified
   exact scan; pallas_scan_topk (K2) with the same gates; and the block
   modes: "scan-block" at the auto budget (no gate), "scan-block" at every
   block and "scan-block-adaptive" (both gated). Each path is run with the
   launch counts set to 0 just before it and read just after, and fails if
   its kernel was not launched.
5. gather: K4-K7 against their plain versions on the card, bit-exact, at
   the gather-rate probe's shapes (131,072 rows: 4 KB pages, 8-row groups
   and 128-word slices of the (1,849,250, 128) word table), K7 at the global
   engine's record table (L = 128, G = 32, 512-byte rows), at ragged row
   counts with the first and last rows and out-of-range indices (zeros),
   and at 12-byte rows (the 4-byte-lane instance); then CUDA-event times of
   each kernel and its plain version. Then the gather-rate probe's entry
   point (clann_tpu_torch.probes.gather_rate.run) as a path of its own,
   which must launch K4-K7.
6. lsh-build: the LSH configuration of bench.py's lsh_at_0.9 row
   (LSH_AT_09.json "chosen": L = 128, gather_block 32, chunk 2048,
   filter_expand 8, global engine, no dense layout) built with
   init_with_config -> build on the same data: seconds per build span,
   bytes of each LSH array, peak device memory.
7. lsh: search_batch(mode="lsh") over the first 2,048 queries at delta 0.95
   and 0.9, gated recall@10 >= 0.8 * delta, failing if K7 was not launched;
   recall, id-recall, dc and candidates per query, QPS, loop iterations and
   host syncs per batch; batch 256 against one batch of 1,024.

It prints the kernels as one JSON line, the nvidia-smi name / power limit
line, and last {"ok": true, "device": {...}}. Imports only torch, numpy and
the clann_tpu_torch package beside this file.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The main path's shape (bench.py's headline configuration)
N_TRAIN, DIMS, N_QUERIES, K = 1_183_514, 100, 10_000, 10
KERNEL_QUERIES = 2_048  # one search batch (scan_search's batch_q)
BLOCK_QUERIES = 4_096  # one block-scan batch (block_scan_search's batch_q)
RECALL_GATE, ID_RECALL_GATE = 0.9, 0.8  # bench.py's gates
SAME_WINNER_GATE = 0.99
K2_VALUE_TOL = 1e-5  # f32 sums of exact bf16 products in another order
LSH_QUERIES = 2_048  # the lsh path's query count (first queries of the set)
LSH_DELTAS = (0.95, 0.9)
LSH_BIG_BATCH = 1_024  # compared with the engine's default batch of 256
DEVICE = "cuda"


def sync():
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def fail(msg: str):
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def log(msg: str):
    print(msg, flush=True)


def import_port():
    """The port from THIS checkout (never an installed copy)."""
    sys.path.insert(0, HERE)
    import clann_tpu_torch

    pkg = os.path.dirname(os.path.abspath(clann_tpu_torch.__file__))
    if os.path.dirname(pkg) != HERE:
        fail(f"clann_tpu_torch imported from {pkg}, not from {HERE}")
    return clann_tpu_torch


def phase_device():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs one CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[device] {name}; count={torch.cuda.device_count()}; "
        f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    log(f"[device] nvidia-smi name,power.limit: {smi}")
    return name, smi


def phase_build():
    from clann_tpu_torch.ops import _build

    t0 = time.perf_counter()
    path = _build.build()
    _build.load_library()
    log(f"[build] {path.relative_to(HERE) if path.is_relative_to(HERE) else path} "
        f"in {time.perf_counter() - t0:.1f} s")
    for line in _build.PTXAS_INFO:
        log(f"[build] {line}")
    if not _build.PTXAS_INFO:
        log("[build] library was already built; no ptxas summary this run")


def _norm(x):
    import torch

    return x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)


def compare_kernel(base, qp, per_bin, biased, label):
    """K1 vs its plain version on the same device tensors."""
    from clann_tpu_torch.ops import scan_topk as st

    got = st.scan_candidates_packed(base, qp, per_bin=per_bin, biased=biased)
    sync()
    ref = st.packed_candidates_plain(base, qp, per_bin=per_bin, biased=biased)
    sync()
    return check_packed(got, ref, per_bin, label)


def check_packed(got, ref, per_bin, label, live_only=False):
    """Gates of a packed kernel (K1, K3) against its plain version. With
    `live_only`, the winners of live slots are compared (the plain
    version's value >= bitcast(1.0)); every other winner, of dead slots and
    pad rows, must be bit-identical."""
    import torch

    from clann_tpu_torch.ops.block_scan import _VALID_FLOOR
    from clann_tpu_torch.testing import packed_agreement, quant_step

    if got.shape != ref.shape or got.dtype != torch.int32:
        fail(f"{label}: kernel output {tuple(got.shape)} {got.dtype}, plain {tuple(ref.shape)}")
    if live_only:
        live = ref >= _VALID_FLOOR
        if not torch.equal(got >= _VALID_FLOOR, live) or not torch.equal(got[~live], ref[~live]):
            fail(f"{label}: kernel and plain version differ on dead slots or pad rows")
        got, ref = got[live], ref[live]
        label = f"{label} ({live.float().mean().item():.3f} of winners live)"
    agree = packed_agreement(got, ref, per_bin)
    tol = quant_step(per_bin) + 1e-5
    log(f"[kernel-vs-plain] {label}: same winner {agree['same_winner']:.6f}, "
        f"identical packed {agree['identical']:.6f}, max |value diff| "
        f"{agree['max_abs_err']:.3e} (tolerance: same winner >= {SAME_WINNER_GATE}, "
        f"|diff| <= pg*2^-22 + 1e-5 = {tol:.3e})")
    if agree["same_winner"] < SAME_WINNER_GATE or agree["max_abs_err"] > tol:
        fail(f"{label}: kernel disagrees with its plain version: {agree}")
    return agree


@contextlib.contextmanager
def traced():
    """The package tracer on for a block (its build spans synchronize the
    card, so they time device work); yields a function that formats the
    spans' seconds."""
    from clann_tpu_torch.metrics.trace import TRACER

    TRACER.clear()
    TRACER.enabled = True
    try:
        yield lambda: ", ".join(f"{k} {v:.3f}" for k, v in sorted(TRACER.totals.items()))
    finally:
        TRACER.enabled = False


def time_cuda(fn, reps):
    """Mean ms per call over `reps` calls, by CUDA events (after a warm-up)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_kernel(train, test, card):
    """K1 against its plain version at the main path's shapes and at small
    ragged ones; then both timed at the main path's shapes."""
    import torch

    from clann_tpu_torch.data.synthetic import random_unit_vectors
    from clann_tpu_torch.ops import scan_topk as st
    from clann_tpu_torch.ops.ivf import make_pallas_base, pallas_scan_plan

    dev = torch.device(DEVICE)
    block_n, num_bins, _, q_tile = pallas_scan_plan(N_TRAIN, K, d=DIMS)
    per_bin = block_n // num_bins
    base = make_pallas_base(_norm(torch.from_numpy(train).to(dev)), block_n)
    qp = st.pad_queries(_norm(torch.from_numpy(test[:KERNEL_QUERIES]).to(dev)),
                        base.shape[1], q_tile, biased=True)
    log(f"[kernel-vs-plain] main-path operands: base {tuple(base.shape)} bf16, "
        f"queries {tuple(qp.shape)} bf16, block_n {block_n}, num_bins {num_bins}, "
        f"per_bin {per_bin}")
    bench = compare_kernel(base, qp, per_bin, True, "main path")

    # small ragged shapes: n_real not a multiple of per_bin, q_pad not a
    # multiple of the kernel's 128-query tile, dpad 128 and 256, both shifts
    rng_rows = 3001
    for per_bin_s, biased, d in ((1, False, 37), (4, True, 37), (16, False, 130),
                                 (64, True, 37), (2048, True, 37)):
        v = _norm(torch.from_numpy(random_unit_vectors(rng_rows, d, seed=per_bin_s)).to(dev))
        b = make_pallas_base(v, 4096)
        if not biased:
            b[:rng_rows, d] = 0.0
        q = st.pad_queries(_norm(torch.from_numpy(random_unit_vectors(77, d, seed=7)).to(dev)),
                           b.shape[1], 32, biased=biased)
        compare_kernel(b, q, per_bin_s, biased,
                       f"ragged n_real={rng_rows} n_pad={b.shape[0]} d={d} dpad={b.shape[1]} "
                       f"q_pad={q.shape[0]} per_bin={per_bin_s} biased={biased}")
        tv, ti = st.fused_scan_candidates_packed(
            b, q, n_real=rng_rows, num_bins=4096 // per_bin_s, block_n=4096,
            q_tile=32, biased=biased)
        if int(ti.max()) >= rng_rows or not bool(torch.isfinite(tv[ti >= 0]).all()):
            fail("decoded candidates past n_real or non-finite")

    # times at the main path's shapes, kernel and plain in turns
    ms, plain_ms, t_kern, t_plain = time_pair(
        lambda: st.scan_candidates_packed(base, qp, per_bin=per_bin, biased=True),
        lambda: st.packed_candidates_plain(base, qp, per_bin=per_bin, biased=True))
    flop = 2.0 * base.shape[0] * base.shape[1] * qp.shape[0]
    log(f"[kernel-time] K1 at base {tuple(base.shape)} x queries {tuple(qp.shape)}: "
        f"kernel {ms:.3f} ms ({t_kern[0]:.3f}, {t_kern[1]:.3f}; "
        f"{flop / ms / 1e9:.1f} TFLOP/s), plain {plain_ms:.3f} ms "
        f"({t_plain[0]:.3f}, {t_plain[1]:.3f}) on {card}")
    return {"max_abs_err": bench["max_abs_err"], "ms": ms, "plain_ms": plain_ms}


def time_pair(kern, plain, reps_kern=20, reps_plain=3):
    """(kernel ms, plain ms, their single calls): the two in turns, plain,
    kernel, kernel, plain, each a CUDA-event mean."""
    import numpy as np

    t_plain = [time_cuda(plain, reps_plain)]
    t_kern = [time_cuda(kern, reps_kern), time_cuda(kern, reps_kern)]
    t_plain.append(time_cuda(plain, reps_plain))
    return float(np.mean(t_kern)), float(np.mean(t_plain)), t_kern, t_plain


def compare_candidates(base, qp, per_bin, label):
    """K2 vs its plain version on the same device tensors: the share of
    (query, bin) winners naming the same row, and the largest value
    difference."""
    import torch

    from clann_tpu_torch.ops import scan_topk as st

    vals, ids = st.scan_candidates(base, qp, per_bin=per_bin)
    sync()
    rv, ri = st.candidates_plain(base, qp, per_bin=per_bin)
    sync()
    if vals.shape != rv.shape or ids.dtype != torch.int32 or vals.dtype != torch.float32:
        fail(f"{label}: kernel output {tuple(vals.shape)} {vals.dtype} {ids.dtype}, "
             f"plain {tuple(rv.shape)}")
    same = (ids == ri).float().mean().item()
    err = (vals - rv).abs().max().item() if vals.numel() else 0.0
    log(f"[kernel-vs-plain] {label}: same row {same:.6f}, max |value diff| {err:.3e} "
        f"(tolerance: same row >= {SAME_WINNER_GATE}, |diff| <= {K2_VALUE_TOL})")
    if not same >= SAME_WINNER_GATE or not err <= K2_VALUE_TOL:
        fail(f"{label}: K2 disagrees with its plain version")
    return err


def phase_k2(train, test, card):
    """K2 against its plain version at pallas_scan_topk's defaults on the
    bench data and at small ragged shapes; then both timed."""
    import torch

    from clann_tpu_torch.data.synthetic import random_unit_vectors
    from clann_tpu_torch.ops import scan_topk as st

    dev = torch.device(DEVICE)
    block_n, per_bin, q_tile = 16384, 16384 // 128, 256  # pallas_scan_topk defaults
    n, d = train.shape
    dpad = ((d + 127) // 128) * 128
    base = torch.zeros((((n + block_n - 1) // block_n) * block_n, dpad),
                       dtype=torch.bfloat16, device=dev)
    base[:n, :d] = _norm(torch.from_numpy(train).to(dev)).to(torch.bfloat16)
    qp = st.pad_queries(_norm(torch.from_numpy(test[:KERNEL_QUERIES]).to(dev)), dpad,
                        q_tile, biased=False)
    err = compare_candidates(base, qp, per_bin,
                             f"K2 main path: base {tuple(base.shape)}, queries "
                             f"{tuple(qp.shape)}, per_bin {per_bin}")
    # ragged: n_real not a multiple of the bin, q_pad not a multiple of the
    # kernel's 128-query tile, dpad 128 and 256, per_bin 1 .. 2048
    for per_bin_s, d_s in ((1, 37), (16, 130), (128, 37), (2048, 37)):
        v = _norm(torch.from_numpy(random_unit_vectors(3001, d_s, seed=per_bin_s)).to(dev))
        dp = ((d_s + 127) // 128) * 128
        b = torch.zeros((4096, dp), dtype=torch.bfloat16, device=dev)
        b[:3001, :d_s] = v.to(torch.bfloat16)
        q = st.pad_queries(_norm(torch.from_numpy(random_unit_vectors(77, d_s, seed=7)).to(dev)),
                           dp, 32, biased=False)
        compare_candidates(b, q, per_bin_s, f"K2 ragged n_real=3001 n_pad=4096 d={d_s} "
                                            f"dpad={dp} q_pad={q.shape[0]} per_bin={per_bin_s}")
        tv, ti = st.fused_scan_candidates(b, q, n_real=3001, num_bins=4096 // per_bin_s,
                                          block_n=4096, q_tile=32)
        if int(ti.max()) >= 3001 or not bool(torch.isfinite(tv[ti >= 0]).all()):
            fail("K2: decoded candidates past n_real or non-finite")

    ms, plain_ms, tk, tp = time_pair(
        lambda: st.scan_candidates(base, qp, per_bin=per_bin),
        lambda: st.candidates_plain(base, qp, per_bin=per_bin))
    flop = 2.0 * base.shape[0] * base.shape[1] * qp.shape[0]
    log(f"[kernel-time] K2 at base {tuple(base.shape)} x queries {tuple(qp.shape)}: "
        f"kernel {ms:.3f} ms ({tk[0]:.3f}, {tk[1]:.3f}; {flop / ms / 1e9:.1f} TFLOP/s), "
        f"plain {plain_ms:.3f} ms ({tp[0]:.3f}, {tp[1]:.3f}) on {card}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def k3_operands(layout, queries, B, q_tile):
    """K3's operands for `queries` at budget B, made by the block path's
    own ranking and pair bookkeeping."""
    from clann_tpu_torch.ops import block_scan as bs

    qn = _norm(queries)
    wants, _ = bs.rank_blocks(layout, qn, B)
    _, tile_block, qg = bs.pair_tiles(wants, qn, n_blocks=layout.n_blocks,
                                      q_tile=q_tile, dpad=layout.base_bf16.shape[1])
    return tile_block, qg


def compare_k3(layout, tile_block, qg, q_tile, per_bin, label):
    from clann_tpu_torch.ops import block_scan as bs

    kw = dict(block_n=layout.block_n, q_tile=q_tile, per_bin=per_bin)
    got = bs.block_scan_candidates_packed(layout.base_bf16, qg, tile_block, **kw)
    sync()
    ref = bs.block_candidates_plain(layout.base_bf16, qg, tile_block, **kw)
    sync()
    return check_packed(got, ref, per_bin, label, live_only=True)


def phase_k3_ragged():
    """K3 against its plain version on small layouts: pad rows in the last
    block, dead slots, tiles past the last live slot, block ids out of
    range, per_bin 1, 16, 512 and 2048, dpad 128 and 256."""
    import numpy as np
    import torch

    from clann_tpu_torch.data.synthetic import random_unit_vectors
    from clann_tpu_torch.ops import block_scan as bs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(0)
    for per_bin, block_n, d, B, q_tile in ((1, 128, 37, 3, 32), (16, 1024, 130, 2, 64),
                                           (512, 4096, 37, 1, 32), (2048, 4096, 37, 1, 128)):
        v = torch.from_numpy(random_unit_vectors(3001, d, seed=per_bin)).to(dev)
        assign = rng.integers(0, 7, size=3001)
        lay = bs.build_block_layout(v, assign, block_n, device=dev)
        q = torch.from_numpy(random_unit_vectors(77, d, seed=7)).to(dev)
        tile_block, qg = k3_operands(lay, q, B, q_tile)
        # two more tiles of live queries, on block ids outside the base
        tile_block = torch.cat([tile_block, tile_block.new_tensor([-1, lay.n_blocks + 3])])
        qg = torch.cat([qg, qg[:q_tile], qg[:q_tile]])
        compare_k3(lay, tile_block, qg, q_tile, per_bin,
                   f"K3 ragged n_real=3001 n_pad={lay.base_bf16.shape[0]} d={d} "
                   f"dpad={lay.base_bf16.shape[1]} block_n={block_n} per_bin={per_bin} "
                   f"B={B} q_tile={q_tile} T={tile_block.shape[0]}")


def phase_k3_bench(index, test, card):
    """K3 against its plain version at the bench shape: the index's block
    layout, 4,096 queries at the auto budget; then both timed."""
    import torch

    from clann_tpu_torch.ops import block_scan as bs
    from clann_tpu_torch.ops.ivf import pallas_scan_plan

    block_n, num_bins, _, q_tile = pallas_scan_plan(N_TRAIN, K, d=DIMS)
    per_bin = block_n // num_bins
    layout = bs.get_block_layout(index, block_n)
    B = bs.auto_block_probe(layout.n_blocks)
    tile_block, qg = k3_operands(
        layout, torch.from_numpy(test[:BLOCK_QUERIES]).to(DEVICE), B, q_tile)
    label = (f"K3 main path: {layout.n_blocks} blocks of {block_n}, B={B}, "
             f"{BLOCK_QUERIES} queries -> T={tile_block.shape[0]} tiles of {q_tile}, "
             f"per_bin {per_bin}")
    agree = compare_k3(layout, tile_block, qg, q_tile, per_bin, label)
    kw = dict(block_n=block_n, q_tile=q_tile, per_bin=per_bin)
    ms, plain_ms, tk, tp = time_pair(
        lambda: bs.block_scan_candidates_packed(layout.base_bf16, qg, tile_block, **kw),
        lambda: bs.block_candidates_plain(layout.base_bf16, qg, tile_block, **kw))
    flop = 2.0 * block_n * qg.shape[1] * qg.shape[0]
    log(f"[kernel-time] K3 at {tile_block.shape[0]} tiles x ({block_n} rows x {q_tile} "
        f"slots x dpad {qg.shape[1]}): kernel {ms:.3f} ms ({tk[0]:.3f}, {tk[1]:.3f}; "
        f"{flop / ms / 1e9:.1f} TFLOP/s incl. dead slots), plain {plain_ms:.3f} ms "
        f"({tp[0]:.3f}, {tp[1]:.3f}) on {card}")
    return {"max_abs_err": agree["max_abs_err"], "ms": ms, "plain_ms": plain_ms}


def check_result(d, i, label, n_queries=N_QUERIES):
    import numpy as np

    if d.shape != (n_queries, K) or i.shape != (n_queries, K):
        fail(f"{label}: result shapes {d.shape} {i.shape}")
    if not np.isfinite(d).all() or i.min() < 0 or i.max() >= N_TRAIN:
        fail(f"{label}: non-finite distances or ids out of range")
    if not (np.diff(d, axis=1) >= -1e-6).all():
        fail(f"{label}: distances not ascending")


def qps(fn, reps=5, n_queries=N_QUERIES):
    """(queries per second of the median call, the calls' seconds)."""
    import numpy as np

    times = []
    for _ in range(reps):
        sync()
        t = time.perf_counter()
        fn()
        sync()
        times.append(time.perf_counter() - t)
    return n_queries / float(np.median(times)), times


def phase_pallas_scan_topk(train, test, gt_d, gt_i, card):
    """pallas_scan_topk (the K2 path) end to end, gated like scan-pallas."""
    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import scan_topk as st

    st.CANDIDATES_LAUNCHES = 0
    sims, ids = st.pallas_scan_topk(train, test, k=K, device=DEVICE)
    sync()
    launches = st.CANDIDATES_LAUNCHES
    d = 1.0 - sims
    check_result(d, ids, "pallas_scan_topk")
    rec, idr = recall_values(gt_d, d, K)[0], recall_by_ids(gt_i, ids, K)
    q, times = qps(lambda: st.pallas_scan_topk(train, test, k=K, device=DEVICE), reps=1)
    log(f"[main] pallas_scan_topk (K2) recall@10 {rec:.4f} (gate {RECALL_GATE}), id-recall "
        f"{idr:.4f} (gate {ID_RECALL_GATE}); K2 launches {launches}; {q:.0f} QPS "
        f"({times[0]:.4f} s per call of {N_QUERIES}, base staging included) on {card}")
    if launches < 1:
        fail("pallas_scan_topk did not launch the K2 kernel")
    if rec < RECALL_GATE or idr < ID_RECALL_GATE:
        fail("pallas_scan_topk recall below the gate")
    return launches


def phase_block_modes(handle, test, gt_d, gt_i, card):
    """The block modes through the facade: scan-block at the auto budget
    (printed, not gated), at every block, and scan-block-adaptive (gated)."""
    import numpy as np

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import block_scan as bs
    from clann_tpu_torch.ops.ivf import pallas_scan_plan

    n_blocks = bs.get_block_layout(handle.index, pallas_scan_plan(N_TRAIN, K, d=DIMS)[0]).n_blocks
    total = 0
    for label, mode, n_probe, gated in (
        (f"scan-block auto B={bs.auto_block_probe(n_blocks)}/{n_blocks}", "scan-block", None, False),
        (f"scan-block B={n_blocks}/{n_blocks}", "scan-block", n_blocks, True),
        ("scan-block-adaptive", "scan-block-adaptive", None, True),
    ):
        bs.KERNEL_LAUNCHES = 0
        d, i, stats = handle.search_batch(test, mode=mode, n_probe=n_probe)
        sync()
        launches = bs.KERNEL_LAUNCHES
        total += launches
        check_result(d, i, label)
        rec, idr = recall_values(gt_d, d, K)[0], recall_by_ids(gt_i, i, K)
        q, times = qps(lambda: handle.search_batch(test, mode=mode, n_probe=n_probe),
                       reps=5 if gated else 1)
        unc = np.asarray(stats.uncertified)
        log(f"[main] {label}: recall@10 {rec:.4f}, id-recall {idr:.4f}"
            f"{f' (gates {RECALL_GATE} / {ID_RECALL_GATE})' if gated else ' (no gate)'}; "
            f"dc/query {float(np.mean(stats.distance_computations)):.0f}; blocks/query "
            f"{float(np.mean(stats.clusters_visited)):.2f}; uncertified queries "
            f"{int((unc > 0).sum())}; K3 launches {launches}; {q:.0f} QPS "
            f"({'median of 5' if gated else 'one call'}: s/call "
            f"{', '.join(f'{x:.4f}' for x in times)}) on {card}")
        if launches < 1:
            fail(f"{label} did not launch the K3 kernel")
        if gated and (rec < RECALL_GATE or idr < ID_RECALL_GATE):
            fail(f"{label}: recall below the gate")
    return total


def phase_main_path(train, test, card):
    import numpy as np
    import torch

    import clann_tpu_torch
    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import scan_topk as st
    from clann_tpu_torch.ops.distances import brute_force_topk
    from clann_tpu_torch.ops.ivf import scan_search

    t0 = time.perf_counter()
    gt_d, gt_i = brute_force_topk(train, test, k=K, block_q=1024, device=DEVICE)
    gt_d, gt_i = gt_d.cpu().numpy(), gt_i.cpu().numpy()
    log(f"[main] exact ground truth on the card in {time.perf_counter() - t0:.2f} s")

    cfg = clann_tpu_torch.Config(
        num_tables=50, num_clusters_factor=0.4, k=K, delta=0.9, seed=0,
        dataset_name=f"glove-{DIMS}-angular-synthetic",
    )
    cuda = torch.device(DEVICE).type == "cuda"
    sync()
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    st.KERNEL_LAUNCHES = 0
    handle = clann_tpu_torch.init_with_config(train, cfg, device=DEVICE)
    t0 = time.perf_counter()
    with traced() as spans:
        handle.build()
        sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    d, i, stats = handle.search_batch(test, mode="scan-pallas")
    first_s = time.perf_counter() - t0
    launches = st.KERNEL_LAUNCHES
    idx = handle.index
    log(f"[main] build {build_s:.3f} s ({idx.n_clusters} GMM clusters, L={cfg.num_tables} "
        f"LSH tables; index {idx.memory_usage() / 1e9:.3f} GB; spans (s, synchronized): "
        f"{spans()}); first scan-pallas search {first_s:.3f} s; K1 launches in it: {launches}")
    if launches < 1:
        fail("scan-pallas did not launch the K1 kernel")
    check_result(d, i, "scan-pallas")
    rec = recall_values(gt_d, d, K)[0]
    idr = recall_by_ids(gt_i, i, K)
    log(f"[main] scan-pallas recall@10 {rec:.4f} (gate {RECALL_GATE}), "
        f"id-recall {idr:.4f} (gate {ID_RECALL_GATE}); dc/query "
        f"{float(np.mean(stats.distance_computations)):.0f}")
    if rec < RECALL_GATE or idr < ID_RECALL_GATE:
        fail("scan-pallas recall below the gate")

    qps_p, reps_p = qps(lambda: handle.search_batch(test, mode="scan-pallas"))
    ds, is_, _ = handle.search_batch(test, mode="scan")
    rec_s, idr_s = recall_values(gt_d, ds, K)[0], recall_by_ids(gt_i, is_, K)
    qps_s, reps_s = qps(lambda: handle.search_batch(test, mode="scan"))
    t0 = time.perf_counter()
    de, ie, ste = scan_search(idx, test, exact=True)
    exact_s = time.perf_counter() - t0
    rec_e, idr_e = recall_values(gt_d, de, K)[0], recall_by_ids(gt_i, ie, K)
    peak = torch.cuda.max_memory_allocated() / 1e9 if cuda else float("nan")
    log(f"[main] scan recall@10 {rec_s:.4f} id-recall {idr_s:.4f}; exact "
        f"(certified) recall@10 {rec_e:.4f} id-recall {idr_e:.4f}, "
        f"{int(ste.uncertified.sum())} uncertified queries re-sorted, "
        f"{exact_s:.3f} s")
    log(f"[main] QPS (median of 5, {N_QUERIES} queries per call, synchronized) "
        f"on {card}: scan-pallas {qps_p:.0f} "
        f"(s/call {', '.join(f'{x:.4f}' for x in reps_p)}), scan {qps_s:.0f} "
        f"(s/call {', '.join(f'{x:.4f}' for x in reps_s)}); build {build_s:.3f} s; "
        f"peak device memory {peak:.3f} GB")
    if rec_s < RECALL_GATE or rec_e < RECALL_GATE:
        fail("scan / exact recall below the gate")
    return handle, gt_d, gt_i, launches


def profile_search(handle, test, mode):
    """Device time by kernel for one search_batch call in `mode`."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):  # the first session pays the profiler's start-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            handle.search_batch(test, mode=mode)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    # device-side events only (kernels, copies), so nothing is counted twice
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    log(f"[profile] {mode} search_batch of {len(test)} queries: wall "
        f"{wall * 1e3:.2f} ms under the profiler, device busy {busy:.2f} ms "
        f"(idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f})")
    for e in rows[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


def check_gather(label, kern, plain):
    """A gather kernel against its plain version: bit-identical words."""
    import torch

    got = kern()
    sync()
    ref = plain()
    sync()
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
        fail(f"{label}: kernel output differs from its plain version")
    err = (got.long() - ref.long()).abs().max().item() if got.numel() else 0
    log(f"[gather] {label}: bit-identical to the plain version ({got.numel()} words)")
    return float(err)


def phase_gather(card):
    """K4-K7 against their plain versions at the probe's shapes, K7 at the
    engine's, at ragged shapes and at 12-byte rows; then both timed, each
    iteration on its own rotated index vector (the probe's protocol)."""
    import torch

    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.probes import gather_rate as gr

    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    rows, W = gr.ROWS, gr.TAKE_G * gr.R
    T = gr.L_PROBE * (gr.TAKE_SLOTS // gr.TAKE_G)  # the (T, 128) word table

    def idx_in(n, count=rows):
        return torch.randint(0, n, (count,), dtype=torch.int32, generator=gen, device=dev)

    def ragged(n, count):
        """count indices with the first and the last row and two outside"""
        i = idx_in(n, count)
        i[:4] = torch.tensor([0, n - 1, -1, n], dtype=torch.int32, device=dev)
        return i

    table = gr.random_words((T, W), gen, dev)
    pages = gr.random_words((T // 8, 8, 128), gen, dev)
    nb = gr.TAKE_SLOTS // gr.ENGINE_G
    rec = gr.random_words((gr.ENGINE_L * nb, gr.ENGINE_G * gr.R), gen, dev)
    flat = table.view(-1)
    # name, kernel(i, inflight), plain(i), source rows, moved / useful bytes per index
    cases = [
        ("K4 gather_pages", lambda i, f=8: tg.gather_pages(pages, i, inflight=f),
         lambda i: tg.pages_plain(pages, i), T // 8, 4096, 4096, f"pages {tuple(pages.shape)}"),
        ("K5 gather_group8", lambda i, f=8: tg.gather_group8(table, i, inflight=f),
         lambda i: tg.group8_plain(table, i), T // 8, 8 * W * 4, W * 4,
         f"8-row groups of {tuple(table.shape)}"),
        ("K6 gather_flat1d", lambda i, f=8: tg.gather_flat1d(flat, i, width=W, inflight=f),
         lambda i: tg.flat1d_plain(flat, i, width=W), T, W * 4, W * 4,
         f"{W}-word slices of ({flat.shape[0]},)"),
        ("K7 gather_rows", lambda i, f=8: tg.gather_rows(rec, i, inflight=f),
         lambda i: tg.rows_plain(rec, i), rec.shape[0], rec.shape[1] * 4, rec.shape[1] * 4,
         f"engine records {tuple(rec.shape)} (L={gr.ENGINE_L}, G={gr.ENGINE_G})"),
    ]
    out = {}
    for name, kern, plain, n_src, moved, useful, shape in cases:
        i0 = idx_in(n_src)
        err = 0.0
        for f in gr.NSEMS:
            err = max(err, check_gather(f"{name} at {rows} rows of {shape}, inflight {f}",
                                        lambda: kern(i0, f), lambda: plain(i0)))
        for count in (rows + 37, 1001):  # not a multiple of a CTA's rows
            ir = ragged(n_src, count)
            err = max(err, check_gather(f"{name} ragged: {count} rows, indices 0, last, -1, "
                                        f"{n_src}", lambda: kern(ir), lambda: plain(ir)))
        sets = [(i,) for i in gr.rotated(i0, n_src, 20)]
        t_plain = [gr.time_iters(plain, sets, 3)]
        t_kern = [gr.time_iters(kern, sets, 3), gr.time_iters(kern, sets, 3)]
        t_plain.append(gr.time_iters(plain, sets, 3))
        ms, plain_ms = sum(t_kern) / 2, sum(t_plain) / 2
        log(f"[gather-time] {name} at {rows} rows of {shape}: kernel {ms:.4f} ms "
            f"({t_kern[0]:.4f}, {t_kern[1]:.4f}; {rows * moved / ms / 1e6:.1f} GB/s moved, "
            f"{rows * useful / ms / 1e6:.1f} useful), plain {plain_ms:.4f} ms "
            f"({t_plain[0]:.4f}, {t_plain[1]:.4f}; {rows * moved / plain_ms / 1e6:.1f} GB/s "
            f"moved) on {card}")
        out[name.split()[0]] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
    # the 4-byte-lane instance: 12-byte records (G = 1, R = 3)
    small = gr.random_words((5003, 3), gen, dev)
    ir = ragged(5003, 4099)
    check_gather("K7 gather_rows, 12-byte rows (4-byte lanes), 4,099 rows",
                 lambda: tg.gather_rows(small, ir), lambda: tg.rows_plain(small, ir))
    del table, pages, rec, flat
    return out


def phase_gather_probe(card):
    """The gather-rate probe's entry point as a path: counts set to 0 just
    before it, read just after; every kernel row must be correct."""
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.probes import gather_rate as gr

    tg.reset_launches()
    t0 = time.perf_counter()
    res = gr.run(DEVICE, iters=2, reps=1)
    sync()
    counts = {"K4": tg.PAGES_LAUNCHES, "K5": tg.GROUP8_LAUNCHES, "K6": tg.FLAT1D_LAUNCHES,
              "K7": tg.ROWS_LAUNCHES}
    bad = [t for t, r in res.items() if r.get("correct") is False]
    log(f"[gather-probe] probes.gather_rate.run (2 iterations per row, best of 1): "
        f"{len(res)} rows in {time.perf_counter() - t0:.1f} s; launches {counts}")
    for tag in ("torch_take_G32", "page4k_s8", "group8_s8", "flat1d_s8",
                f"torch_engine_L{gr.ENGINE_L}_G{gr.ENGINE_G}",
                f"k7_engine_L{gr.ENGINE_L}_G{gr.ENGINE_G}_s8"):
        r = res[tag]
        log(f"[gather-probe]   {tag}: {r['ms_per_iter']:.4f} ms/iter, {r['ns_per_row']:.3f} "
            f"ns/row, {r['gbps']:.1f} GB/s moved, {r['useful_gbps']:.1f} useful on {card}")
    if bad:
        fail(f"gather-rate probe rows not bit-identical to the plain gather: {bad}")
    if min(counts.values()) < 1:
        fail(f"the gather-rate probe did not launch every kernel: {counts}")
    return counts


def lsh_config():
    """bench.py's lsh_at_0.9 row with LSH_AT_09.json's chosen knobs."""
    import clann_tpu_torch

    return clann_tpu_torch.Config(
        num_tables=128, num_clusters_factor=0.4, k=K, delta=0.95, seed=0,
        gather_block=32, candidate_chunk=2048, filter_expand=8, lsh_engine="global",
        dense_layout=False, pack_slot_records=False,
        dataset_name=f"glove-{DIMS}-angular-synthetic",
    )


def phase_lsh_build(train, card):
    import torch

    import clann_tpu_torch

    cfg = lsh_config()
    sync()
    torch.cuda.reset_peak_memory_stats()
    handle = clann_tpu_torch.init_with_config(train, cfg, device=DEVICE)
    t0 = time.perf_counter()
    with traced() as spans:
        handle.build()
        sync()
    build_s = time.perf_counter() - t0
    idx = handle.index
    log(f"[lsh-build] L={cfg.num_tables} G={cfg.gather_block} on {N_TRAIN} x {DIMS}: "
        f"build {build_s:.3f} s; spans (s, synchronized): {spans()}; {idx.n_clusters} "
        f"clusters, g_dir_iters {idx.g_dir_iters}, dir_iters {idx.dir_iters}")
    nbytes = idx.array_bytes()
    log(f"[lsh-build] bytes: " + ", ".join(
        f"{f} {tuple(getattr(idx, f).shape)} {nbytes[f] / 1e6:.1f} MB"
        for f in ("g_records", "g_sorted_hash", "sorted_hash", "sorted_idx", "sketches",
                  "prefix_dir", "g_dir", "vectors")))
    log(f"[lsh-build] index {idx.memory_usage() / 1e9:.3f} GB; peak device memory of the "
        f"build {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    for f in ("g_records", "g_sorted_hash", "g_dir", "sketches", "sorted_hash", "prefix_dir"):
        if getattr(idx, f) is None:
            fail(f"the LSH build made no {f}")
    return handle


def phase_lsh(handle, test, gt_d, gt_i, card):
    """mode="lsh" through the facade at each delta, gated; the loop's
    iterations and syncs from a second call of the engine."""
    import numpy as np

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops.global_query import LoopStats, global_search

    q, gd, gi = test[:LSH_QUERIES], gt_d[:LSH_QUERIES], gt_i[:LSH_QUERIES]
    launches = 0
    for delta in LSH_DELTAS:
        tg.reset_launches()
        d, i, st = handle.search_batch(q, mode="lsh", delta=delta)
        sync()
        launches_d = tg.ROWS_LAUNCHES
        launches += launches_d
        check_result(d, i, f"lsh delta={delta}", LSH_QUERIES)
        rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
        rate, times = qps(lambda: handle.search_batch(q, mode="lsh", delta=delta),
                          reps=3 if delta == LSH_DELTAS[0] else 1, n_queries=LSH_QUERIES)
        ls = LoopStats()
        global_search(handle.index, q, delta=delta, loop_stats=ls)
        log(f"[lsh] delta={delta}: recall@10 {rec:.4f} (gate {0.8 * delta:.2f}), id-recall "
            f"{idr:.4f}; dc/query {float(np.mean(st.distance_computations)):.1f}, "
            f"candidates/query {float(np.mean(st.candidates)):.1f}, feasible clusters/query "
            f"{float(np.mean(st.clusters_visited)):.1f}; K7 launches {launches_d}; "
            f"{ls.batches} batches of 256: {ls.iterations / ls.batches:.1f} loop iterations "
            f"and {ls.syncs / ls.batches:.2f} host syncs per batch; {rate:.1f} QPS "
            f"(s/call of {LSH_QUERIES}: {', '.join(f'{x:.4f}' for x in times)}) on {card}")
        if launches_d < 1:
            fail(f"lsh delta={delta} did not launch the K7 kernel")
        if rec < 0.8 * delta:
            fail(f"lsh delta={delta}: recall@10 {rec:.4f} below 0.8 * delta")

    # the engine is batch-invariant: one batch of 1,024 against batches of 256
    delta = LSH_DELTAS[0]
    _, i0, s0 = global_search(handle.index, q, delta=delta)
    global_search(handle.index, q[:LSH_BIG_BATCH], delta=delta, batch_size=LSH_BIG_BATCH)
    sync()
    t0 = time.perf_counter()
    _, i1, s1 = global_search(handle.index, q, delta=delta, batch_size=LSH_BIG_BATCH)
    sync()
    big_s = time.perf_counter() - t0
    same_ids = float(np.mean(np.sort(i0, 1) == np.sort(i1, 1)))
    same_dc = float(np.mean(s0.distance_computations == s1.distance_computations))
    log(f"[lsh] delta={delta} batch {LSH_BIG_BATCH}: {LSH_QUERIES / big_s:.1f} QPS "
        f"({big_s:.4f} s per call of {LSH_QUERIES}); against batch 256: same ids "
        f"{same_ids:.5f}, same dc {same_dc:.5f} on {card}")
    return launches


def profile_lsh(handle, test):
    """Device time by kernel for one 256-query batch of mode "lsh"."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = test[:256]
    for _ in range(2):  # the first session pays the profiler's start-up
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            handle.search_batch(q, mode="lsh")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    log(f"[profile] lsh search_batch of 256 queries: wall {wall * 1e3:.2f} ms under the "
        f"profiler, device busy {busy:.2f} ms (idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}), "
        f"{launches} device kernels / copies")
    for e in rows[:15]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of one scan-pallas call, one "
                         "scan-block call and one 256-query lsh batch")
    args = ap.parse_args()

    import_port()
    card, smi = phase_device()
    import torch

    phase_build()

    from clann_tpu_torch.data.synthetic import clustered_unit_vectors

    t0 = time.perf_counter()
    train = clustered_unit_vectors(N_TRAIN, DIMS, n_modes=1024, spread=0.7, seed=0)
    test = clustered_unit_vectors(N_QUERIES, DIMS, n_modes=1024, spread=0.7, seed=1)
    log(f"[data] train {train.shape} test {test.shape} in {time.perf_counter() - t0:.1f} s")

    label = f"{card} ({smi})"
    k1 = phase_kernel(train, test, label)
    k2 = phase_k2(train, test, label)
    phase_k3_ragged()
    handle, gt_d, gt_i, launches_k1 = phase_main_path(train, test, label)
    launches_k2 = phase_pallas_scan_topk(train, test, gt_d, gt_i, label)
    k3 = phase_k3_bench(handle.index, test, label)
    launches_k3 = phase_block_modes(handle, test, gt_d, gt_i, label)
    log(f"[main] peak device memory over the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if args.profile:
        for mode in ("scan-pallas", "scan-block"):
            profile_search(handle, test, mode)
    del handle
    torch.cuda.empty_cache()

    gather = phase_gather(label)
    probe_launches = phase_gather_probe(label)
    lsh = phase_lsh_build(train, label)
    launches_k7 = phase_lsh(lsh, test, gt_d, gt_i, label)
    if args.profile:
        profile_lsh(lsh, test)
    log(f"[main] peak device memory over the whole run, all paths "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    kernels = [
        ("scan_topk_packed (K1)", "clann_tpu_torch/csrc/scan_topk.cu",
         "clann_tpu/ops/pallas/scan_topk.py:83", launches_k1, k1),
        ("scan_candidates (K2)", "clann_tpu_torch/csrc/scan_topk.cu",
         "clann_tpu/ops/pallas/scan_topk.py:50", launches_k2, k2),
        ("block_scan_packed (K3)", "clann_tpu_torch/csrc/block_scan.cu",
         "clann_tpu/ops/pallas/block_scan.py:276", launches_k3, k3),
        ("gather_pages (K4)", "clann_tpu_torch/csrc/gather.cu",
         "scripts/exp_pallas_gather.py:87", probe_launches["K4"], gather["K4"]),
        ("gather_group8 (K5)", "clann_tpu_torch/csrc/gather.cu",
         "scripts/exp_pallas_gather.py:146", probe_launches["K5"], gather["K5"]),
        ("gather_flat1d (K6)", "clann_tpu_torch/csrc/gather.cu",
         "scripts/exp_pallas_gather.py:200", probe_launches["K6"], gather["K6"]),
        ("gather_rows (K7)", "clann_tpu_torch/csrc/gather.cu",
         "scripts/exp_gather_rate.py:154", launches_k7, gather["K7"]),
    ]
    log(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "max_abs_err": m["max_abs_err"],
        "ms": m["ms"],
        "plain_ms": m["plain_ms"],
    } for name, source, replaces, launches, m in kernels]}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
