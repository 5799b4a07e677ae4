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
   shared-memory / spill summary (failing if ptxas serialised a wgmma),
   then checks with cuobjdump -sass that every instance of the scan
   kernels K1, K2 and K3 (one Hopper loop, hopper_scan_kernel; K2's found
   by its ArgmaxKey epilogue) issues HGMMA and no HMMA, that no other
   (mma.sync) scan kernel is in the library, that every instance of the
   bulk gather (K4, K5) issues bulk copies (UBLKCP), and that the warp
   gather warp_gather_kernel (K6, K7) is there in the 11 instances its plan
   launches (4-byte units at each inflight, 16-byte units up to 16), each
   taking its rows' indices by shuffle (SHFL.IDX), and no other kernel.
3. kernels vs plain, each against its plain PyTorch version on the card, at
   the main paths' shapes and at small ragged ones, then CUDA-event times of
   both at the main paths' shapes, beside the kernel's bound (the larger of
   its FLOP at 989 TFLOP/s and its bytes at 3.35 TB/s) and its library
   yardstick (K1, K2: a cuBLAS bf16 torch.matmul of the same product;
   K3: one cuBLAS bf16 torch.bmm of its live (query tile, block)
   products; K4-K7: one torch.index_select of the same rows):
   K1 (packed scan; 1,183,514 x 100 -> dpad 128, block_n 32768, 64 bins,
   2,048 queries), K2 (unpacked scan; pallas_scan_topk's block_n 16384,
   128 bins, 2,048 queries, and timed again at its own batch of 4,096;
   its ragged shapes include exact-integer operands with negative and
   +-0.0 scores and exact ties, held to identical rows and values), K3
   (block scan; ragged shapes here, the bench
   layout with 4,096 queries at B = 9 and at all 37 blocks after the
   build).
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
5. gather: K4-K7 against their plain versions on the card, bit-exact at
   every inflight, at the gather-rate probe's shapes (131,072 rows: 4 KB
   pages, 8-row groups and 128-word slices of the (1,849,250, 128) word
   table), K7 at the global engine's record table (L = 128, G = 32,
   512-byte rows), at ragged row counts (131,109 and 1,001) with the first
   and last rows and out-of-range indices (zeros); K7 also at widths of 1,
   3, 12, 48, 100 and 128 words on a 16-byte aligned source and on one 4
   bytes off (16- and 4-byte units); K5 also at W = 4 and W = 300 (group
   rows of 128 B and 9,600 B), and K5 must refuse a source that is not
   16-byte aligned. Then each kernel, its plain version and one
   index_select of the same rows timed two ways on 20 rotated index
   vectors: device ms, by CUDA events around the replay of a CUDA graph of
   the 20 calls (the device's time alone; the share of the bound is taken
   on it), and call ms, around a Python loop of the same calls (what a
   caller waits, the host's work included); each kernel also at every
   inflight, beside the card's copy ceiling (one contiguous copy_ of the
   same 537 MB). Then the gather-rate probe's entry point
   (clann_tpu_torch.probes.gather_rate.run) as a path of its own, which
   must launch K4-K7.
6. lsh-build: the LSH configuration of bench.py's lsh_at_0.9 row
   (LSH_AT_09.json "chosen": L = 128, gather_block 32, chunk 2048,
   filter_expand 8, global engine, no dense layout) built with
   init_with_config -> build on the same data: seconds per build span,
   bytes of each LSH array, peak device memory.
7. lsh: search_batch(mode="lsh") over the first 2,048 queries at delta 0.95
   and 0.9, gated recall@10 >= 0.8 * delta, failing if K7 was not launched;
   recall, id-recall, dc and candidates per query, QPS, loop iterations and
   host syncs per batch; batch 256 against one batch of 1,024.
8. dense (on the main-path index, whose default build also makes the dense
   IVF layout): the layout's rows, seg_cap, bytes and build span; the
   default mode ("auto" -> "dense" at auto_n_probe(R)) on 10,000 queries,
   printed and not gated (IVF at a fixed budget promises no recall);
   bench.py's n_probe sweep (8 ... 128 on 2,000 queries, the smallest
   n_probe with recall >= 0.9, the stop at 48 below 0.75) and the QPS of
   the chosen n_probe on 10,000 queries; "dense" at n_probe = R (every row,
   an exact search) gated recall@10 >= 0.9, id-recall >= 0.8 and no dropped
   probe.
9. adaptive: search_batch(mode="adaptive") on 10,000 queries, run to
   completion, gated like the exact modes.
10. walk-build: the README quickstart's L = 50 with the reference-faithful
   engine (lsh_engine="clustered", no dense layout, every other knob at its
   default: slot records in blocks of 16, chunk 512, filter_expand 8) on the
   same data: build spans, bytes of the walk's arrays, peak memory.
11. walk: search_batch(mode="lsh") -> "lsh-clustered" on the first 512
   queries in batches of 256 at delta 0.9, gated recall@10 >= 0.8 * delta,
   failing if K7 was not launched; the loop's outer steps, inner
   iterations and host syncs per batch; K7 against its plain version at the
   walk's shape (the built slot records viewed as block rows, one batch's
   65,536 indices, and ragged counts), bit-exact at every inflight, and
   timed as in phase 5 (device ms and call ms); the ball-overlap stop's
   bound recomputed in numpy from the built index (radii, center distances),
   which must agree with the clusters each query visited; then search_by_id
   on 256 indexed points, which must agree with search on those vectors at
   k + 1.

It prints the kernels as one JSON line (launches on the main paths, error
against the plain version, ms, plain_ms, bound_ms / bound_by, library_ms),
the nvidia-smi name / power limit line, and last {"ok": true, "device":
{...}}. Imports only torch, numpy and
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
# one H100 SXM's published dense peaks (NVIDIA's data sheet, at 700 W): the
# least time a kernel's work could take is the larger of its operations over
# PEAK_BF16_FLOPS and its bytes (each input read once, each output written
# once) over PEAK_BYTES_PER_S
PEAK_BF16_FLOPS, PEAK_BYTES_PER_S = 989e12, 3.35e12
LSH_QUERIES = 2_048  # the lsh path's query count (first queries of the set)
LSH_DELTAS = (0.95, 0.9)
LSH_BIG_BATCH = 1_024  # compared with the engine's default batch of 256
IVF_SWEEP = (8, 12, 16, 24, 32, 48, 64, 96, 128)  # bench.py's n_probe sweep
IVF_SWEEP_QUERIES, IVF_BATCH = 2_000, 2_048  # bench.py's sub-sample and BATCH
WALK_QUERIES, WALK_DELTA = 512, 0.9
BY_ID_POINTS = 256
DEVICE = "cuda"


def sync():
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


# device-memory peaks of the phases before each reset (reset_peak)
PEAKS = []


def reset_peak():
    """Start a phase's own device-memory peak, keeping the run's."""
    import torch

    PEAKS.append(torch.cuda.max_memory_allocated())
    torch.cuda.reset_peak_memory_stats()


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
    if any("serialized" in line for line in _build.PTXAS_INFO):
        fail("ptxas serialised the wgmma of a packed scan kernel")
    check_sass(path)


def check_sass(lib_path):
    """cuobjdump -sass of the built library: every instance of the scan
    kernels K1, K2 and K3 (hopper_scan_kernel: K2's by its ArgmaxKey
    epilogue, K3's by its source) must issue HGMMA (wgmma) and no HMMA
    (mma.sync), and no other scan kernel may be in the library; every
    instance of bulk_gather_kernel (K4, K5) must issue bulk copies (UBLKCP,
    cp.async.bulk); warp_gather_kernel (K6, K7) must be there in every
    instance its plan launches (4-byte units at each inflight, 16-byte
    units up to WARP_VEC16_INFLIGHT), each shuffling its rows' indices
    (SHFL.IDX); no other kernel may be there."""
    from clann_tpu_torch.ops import gather as tg

    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    if not os.path.exists(tool):
        log("[build] cuobjdump not found: SASS not checked")
        return
    sass = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, bulk = {}, {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name = part.split("\n", 1)[0].strip()
        if "hopper_scan_kernel" in name:
            key = ("K2 hopper_scan_kernel<ArgmaxKey>" if "ArgmaxKey" in name else
                   "K3 hopper_scan_kernel<PackedKey> (block_scan.cu)" if "block_scan_cu" in name
                   else "K1 hopper_scan_kernel<PackedKey> (scan_topk.cu)")
        elif "scan_kernel" in name:
            key = f"other scan kernel {name}"
        elif "bulk_gather_kernel" in name:
            key = "K4/K5 bulk_gather_kernel"
            for op in re.findall(r"\b(UBLK\w*(?:\.\w+)*)", part):
                bulk[op] = bulk.get(op, 0) + 1
        elif "warp_gather_kernel" in name:
            key = "K6/K7 warp_gather_kernel"
        elif "gather_kernel" in name:
            key = f"other gather kernel {name}"
        else:
            key = f"other kernel {name}"
        counts.setdefault(key, []).append((len(re.findall(r"\bHGMMA\.", part)),
                                           len(re.findall(r"\bHMMA\.", part)),
                                           len(re.findall(r"\bUBLKCP\b", part)),
                                           len(re.findall(r"\bSHFL\.IDX\b", part))))
    for key, ns in sorted(counts.items()):
        log(f"[build] SASS {key}: {len(ns)} instance(s), (HGMMA, HMMA, UBLKCP, SHFL.IDX) per "
            f"instance {ns}")
    log(f"[build] SASS bulk-copy instructions of bulk_gather_kernel: {bulk}")
    scans = {k: ns for k, ns in counts.items() if k[:2] in ("K1", "K2", "K3")}
    if (len(scans) != 3 or any(k.startswith("other scan") for k in counts)
            or min(g for ns in scans.values() for g, _, _, _ in ns) == 0
            or max(h for ns in scans.values() for _, h, _, _ in ns) > 0):
        fail("every instance of K1, K2 and K3 must issue HGMMA and no HMMA, and no "
             "other (mma.sync) scan kernel may remain")
    warp = counts.get("K6/K7 warp_gather_kernel", [])
    n_warp = len(tg.INFLIGHT_CHOICES) + sum(f <= tg.WARP_VEC16_INFLIGHT
                                            for f in tg.INFLIGHT_CHOICES)
    if (min((c for _, _, c, _ in counts.get("K4/K5 bulk_gather_kernel", [])), default=0) < 2
            or len(warp) != n_warp or min(x for *_, x in warp) < 1
            or any(k.startswith("other") for k in counts)):
        fail("bulk_gather_kernel (K4, K5) must issue its bulk load and store (UBLKCP) in every "
             "instance, warp_gather_kernel (K6, K7) must be there in every instance with its "
             "index shuffle (SHFL.IDX), and no other kernel may be in the library")


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


def bound(flop, nbytes):
    """(least ms on the card, "operations" or "bytes") for the work."""
    t_ops, t_bytes = flop / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


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
    # multiple of the kernel's 256-query group, dpad 64 to 256 (every
    # instance of the resident loop: the register operand at 64 and 128,
    # shared memory at 192 and 256), both shifts
    rng_rows = 3001
    for per_bin_s, biased, d, dpad in ((1, False, 37, 128), (4, True, 37, 128),
                                       (16, False, 130, 256), (64, True, 37, 128),
                                       (2048, True, 37, 128), (16, True, 37, 64),
                                       (512, False, 130, 192)):
        v = _norm(torch.from_numpy(random_unit_vectors(rng_rows, d, seed=per_bin_s)).to(dev))
        b = make_pallas_base(v, 4096)[:, :dpad].contiguous()
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
    out_bytes = 4.0 * (base.shape[0] // per_bin) * qp.shape[0]
    b_ms, b_by = bound(flop, 2.0 * (base.numel() + qp.numel()) + out_bytes)
    lib_ms = library_gemm_ms(base, qp)
    log(f"[kernel-time] K1 at base {tuple(base.shape)} x queries {tuple(qp.shape)}: "
        f"kernel {ms:.3f} ms ({t_kern[0]:.3f}, {t_kern[1]:.3f}; "
        f"{flop / ms / 1e9:.1f} TFLOP/s, {b_ms / ms:.3f} of the {b_ms:.3f} ms bound by "
        f"{b_by}), plain {plain_ms:.3f} ms ({t_plain[0]:.3f}, {t_plain[1]:.3f}), library "
        f"{lib_ms:.3f} ms (cuBLAS bf16 torch.matmul, GEMM only: writes the "
        f"{2.0 * base.shape[0] * qp.shape[0] / 1e9:.2f} GB of scores the kernel never "
        f"writes) on {card}")
    return {"max_abs_err": bench["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def library_gemm_ms(base, qp):
    """ms of one cuBLAS bf16 torch.matmul of the same product (every score
    written as bf16), the scan kernels' library yardstick."""
    import torch

    ms = time_cuda(lambda: torch.matmul(base, qp.T), 5)
    torch.cuda.empty_cache()
    return ms


def time_pair(kern, plain, reps_kern=20, reps_plain=3):
    """(kernel ms, plain ms, their single calls): the two in turns, plain,
    kernel, kernel, plain, each a CUDA-event mean."""
    import numpy as np

    t_plain = [time_cuda(plain, reps_plain)]
    t_kern = [time_cuda(kern, reps_kern), time_cuda(kern, reps_kern)]
    t_plain.append(time_cuda(plain, reps_plain))
    return float(np.mean(t_kern)), float(np.mean(t_plain)), t_kern, t_plain


def compare_candidates(base, qp, per_bin, label, exact=False):
    """K2 vs its plain version on the same device tensors: the share of
    (query, bin) winners naming the same row, and the largest value
    difference. `exact`: operands whose scores every summation order gives
    exactly, so rows and values must be identical."""
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
    gate = (1.0, 0.0) if exact else (SAME_WINNER_GATE, K2_VALUE_TOL)
    log(f"[kernel-vs-plain] {label}: same row {same:.6f}, max |value diff| {err:.3e} "
        f"(tolerance: same row >= {gate[0]}, |diff| <= {gate[1]})")
    if not same >= gate[0] or not err <= gate[1]:
        fail(f"{label}: K2 disagrees with its plain version")
    return err


def signed_tie_operands(n, d, dpad, n_q, seed):
    """K2 operands whose scores are exact in f32 in any summation order
    (entries multiples of 1/4 in [-3/4, 3/4], so every partial sum is a
    multiple of 1/16 below 2^4): exact ties (rows 3i + 1 copy rows 3i),
    negative maxima (the first half of the rows has no negative entry,
    every third query no positive one), and a row of -0.0 at row 5 and one
    of +0.0 at row 9 of every third 64-row group (scores of -0.0 against
    the queries with no negative entry, every fourth)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    b = np.zeros((n, dpad), np.float32)
    b[:, :d] = rng.integers(-3, 4, size=(n, d)) / 4.0
    b[: n // 2] = np.abs(b[: n // 2])
    b[1::3] = b[0::3][: len(b[1::3])]
    q = np.zeros((n_q, dpad), np.float32)
    q[:, :d] = rng.integers(-3, 4, size=(n_q, d)) / 4.0
    q[0::3] = -np.abs(q[0::3])
    q[1::4] = np.abs(q[1::4])
    for g in range(0, n, 192):
        b[g + 5] = -0.0
        b[g + 9] = 0.0
    dev = torch.device(DEVICE)
    return (torch.from_numpy(b).to(dev, torch.bfloat16),
            torch.from_numpy(q).to(dev, torch.bfloat16))


def phase_k2(train, test, card):
    """K2 against its plain version at pallas_scan_topk's defaults on the
    bench data, at small ragged shapes and on exact-integer operands with
    negative, tied and +-0.0 scores (identical rows and values); then both
    timed at 2,048 queries (the kernels line) and at the path's batch of
    4,096."""
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
    # negative maxima, exact ties and +-0.0 scores: the kernel's integer
    # ordering (lowest row on ties, -0.0 == +0.0) against the plain argmax
    b, q = signed_tie_operands(4096, 37, 128, 77, seed=5)
    for per_bin_s in (1, 4, 16, 128, 2048):
        compare_candidates(b, q, per_bin_s, f"K2 negative / tied / +-0 scores n_pad=4096 d=37 "
                                            f"dpad=128 q_pad=77 per_bin={per_bin_s}", exact=True)

    out = k2_time(base, qp, per_bin, card)
    qp4 = st.pad_queries(_norm(torch.from_numpy(test[:BLOCK_QUERIES]).to(dev)), dpad,
                         q_tile, biased=False)
    compare_candidates(base, qp4, per_bin, f"K2 at pallas_scan_topk's batch: queries "
                                           f"{tuple(qp4.shape)}, per_bin {per_bin}")
    k2_time(base, qp4, per_bin, card)
    out["max_abs_err"] = err
    return out


def k2_time(base, qp, per_bin, card):
    """K2 and its plain version timed in turns, beside its bound and the
    cuBLAS GEMM of the same product."""
    from clann_tpu_torch.ops import scan_topk as st

    ms, plain_ms, tk, tp = time_pair(
        lambda: st.scan_candidates(base, qp, per_bin=per_bin),
        lambda: st.candidates_plain(base, qp, per_bin=per_bin))
    flop = 2.0 * base.shape[0] * base.shape[1] * qp.shape[0]
    out_bytes = 8.0 * (base.shape[0] // per_bin) * qp.shape[0]  # vals and ids
    b_ms, b_by = bound(flop, 2.0 * (base.numel() + qp.numel()) + out_bytes)
    lib_ms = library_gemm_ms(base, qp)
    log(f"[kernel-time] K2 at base {tuple(base.shape)} x queries {tuple(qp.shape)}: "
        f"kernel {ms:.3f} ms ({tk[0]:.3f}, {tk[1]:.3f}; {flop / ms / 1e9:.1f} TFLOP/s, "
        f"{b_ms / ms:.3f} of the {b_ms:.3f} ms bound by {b_by}), plain {plain_ms:.3f} ms "
        f"({tp[0]:.3f}, {tp[1]:.3f}), library {lib_ms:.3f} ms (cuBLAS bf16 torch.matmul, "
        f"GEMM only) on {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms}


def k3_operands(layout, queries, B, q_tile):
    """K3's operands for `queries` at budget B, made by the block path's
    own ranking and pair bookkeeping: (tile_block, qg, tile_live)."""
    from clann_tpu_torch.ops import block_scan as bs

    qn = _norm(queries)
    wants, _ = bs.rank_blocks(layout, qn, B)
    _, tile_block, qg, tile_live = bs.pair_tiles(
        wants, qn, n_blocks=layout.n_blocks, q_tile=q_tile, dpad=layout.base_bf16.shape[1])
    return tile_block, qg, tile_live


def compare_k3(layout, tile_block, qg, tile_live, q_tile, per_bin, label):
    """K3 (skipping the groups of dead slots that tile_live names) against
    its plain version, which computes every slot."""
    from clann_tpu_torch.ops import block_scan as bs

    kw = dict(block_n=layout.block_n, q_tile=q_tile, per_bin=per_bin)
    got = bs.block_scan_candidates_packed(layout.base_bf16, qg, tile_block,
                                          tile_live=tile_live, **kw)
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
        tile_block, qg, tile_live = k3_operands(lay, q, B, q_tile)
        # two more tiles of live queries, on block ids outside the base
        tile_block = torch.cat([tile_block, tile_block.new_tensor([-1, lay.n_blocks + 3])])
        tile_live = torch.cat([tile_live, tile_live.new_tensor([q_tile, q_tile])])
        qg = torch.cat([qg, qg[:q_tile], qg[:q_tile]])
        compare_k3(lay, tile_block, qg, tile_live, q_tile, per_bin,
                   f"K3 ragged n_real=3001 n_pad={lay.base_bf16.shape[0]} d={d} "
                   f"dpad={lay.base_bf16.shape[1]} block_n={block_n} per_bin={per_bin} "
                   f"B={B} q_tile={q_tile} T={tile_block.shape[0]}")


def phase_k3_bench(index, test, card):
    """K3 against its plain version at the bench shape: the index's block
    layout, 4,096 queries at the auto budget and at every block; then both
    timed at each."""
    from clann_tpu_torch.ops import block_scan as bs
    from clann_tpu_torch.ops.ivf import pallas_scan_plan

    layout = bs.get_block_layout(index, pallas_scan_plan(N_TRAIN, K, d=DIMS)[0])
    at_auto = k3_bench_at(layout, test, bs.auto_block_probe(layout.n_blocks), card)
    k3_bench_at(layout, test, layout.n_blocks, card)
    return at_auto  # the kernel line reports the auto budget


def k3_bench_at(layout, test, B, card):
    import torch

    from clann_tpu_torch.ops import block_scan as bs
    from clann_tpu_torch.ops.ivf import pallas_scan_plan

    block_n, num_bins, _, q_tile = pallas_scan_plan(N_TRAIN, K, d=DIMS)
    per_bin = block_n // num_bins
    tile_block, qg, tile_live = k3_operands(
        layout, torch.from_numpy(test[:BLOCK_QUERIES]).to(DEVICE), B, q_tile)
    T, dpad = tile_block.shape[0], qg.shape[1]
    live = int(tile_live.sum())
    label = (f"K3 main path: {layout.n_blocks} blocks of {block_n}, B={B}, "
             f"{BLOCK_QUERIES} queries -> T={T} tiles of {q_tile}, per_bin {per_bin}")
    agree = compare_k3(layout, tile_block, qg, tile_live, q_tile, per_bin, label)
    kw = dict(block_n=block_n, q_tile=q_tile, per_bin=per_bin)
    ms, plain_ms, tk, tp = time_pair(
        lambda: bs.block_scan_candidates_packed(layout.base_bf16, qg, tile_block,
                                                tile_live=tile_live, **kw),
        lambda: bs.block_candidates_plain(layout.base_bf16, qg, tile_block, **kw))
    # the work these inputs need: the live slots against their blocks, each
    # block with a live slot read once, the live query rows, every winner
    flop = 2.0 * live * block_n * dpad
    blocks = int(torch.unique(tile_block[tile_live > 0]).numel())
    nbytes = (2.0 * blocks * block_n * dpad + 2.0 * live * dpad
              + 4.0 * T * (block_n // per_bin) * q_tile + 8.0 * T)
    b_ms, b_by = bound(flop, nbytes)
    lib_ms, lib_tiles = library_k3_ms(layout, tile_block, qg, tile_live, q_tile)
    log(f"[kernel-time] K3 at B={B}: {T} tiles x ({block_n} rows x {q_tile} slots x dpad "
        f"{dpad}), {live} live slots of {T * q_tile}: kernel {ms:.3f} ms ({tk[0]:.3f}, "
        f"{tk[1]:.3f}; {flop / ms / 1e9:.1f} TFLOP/s over live slots, {b_ms / ms:.3f} of the "
        f"{b_ms:.3f} ms bound by {b_by}), plain {plain_ms:.3f} ms ({tp[0]:.3f}, {tp[1]:.3f}), "
        f"library {lib_ms:.3f} ms (one cuBLAS bf16 torch.bmm of the {lib_tiles} tiles with a "
        f"live slot, ({q_tile} x {dpad}) x ({dpad} x {block_n}) each, GEMM only: writes the "
        f"{2.0 * lib_tiles * q_tile * block_n / 1e9:.2f} GB of scores the kernel never writes) "
        f"on {card}")
    return {"max_abs_err": agree["max_abs_err"], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib_ms}


def library_k3_ms(layout, tile_block, qg, tile_live, q_tile):
    """(ms, tiles) of one cuBLAS bf16 torch.bmm of K3's live products: each
    tile with a live slot, its queries against its block; the operands are
    gathered before the timing."""
    import torch

    dpad, block_n = qg.shape[1], layout.block_n
    live = (tile_live > 0) & (tile_block >= 0) & (tile_block < layout.n_blocks)
    q = qg.view(-1, q_tile, dpad)[live]
    base = layout.base_bf16[: layout.n_blocks * block_n].view(layout.n_blocks, block_n, dpad)
    b = base[tile_block[live].long()].transpose(1, 2)
    ms = time_cuda(lambda: torch.bmm(q, b), 5)
    tiles = q.shape[0]
    del q, b
    torch.cuda.empty_cache()
    return ms, tiles


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
        reset_peak()
    st.KERNEL_LAUNCHES = 0
    handle = clann_tpu_torch.init_with_config(train, cfg, device=DEVICE)
    t0 = time.perf_counter()
    with traced() as spans:
        handle.build()
        sync()
    build_s = time.perf_counter() - t0
    from clann_tpu_torch.metrics.trace import TRACER

    build_spans = dict(TRACER.totals)
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
    return handle, gt_d, gt_i, launches, build_spans


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


def check_gather(label, kern, plain, quiet=False):
    """A gather kernel against its plain version: bit-identical words."""
    import torch

    got = kern()
    sync()
    ref = plain() if callable(plain) else plain
    sync()
    if got.shape != ref.shape or got.dtype != ref.dtype or not torch.equal(got, ref):
        fail(f"{label}: kernel output differs from its plain version")
    err = (got.long() - ref.long()).abs().max().item() if got.numel() else 0
    if not quiet:
        log(f"[gather] {label}: bit-identical to the plain version ({got.numel()} words)")
    return float(err)


def check_every(label, kern, ref):
    """check_gather of kern(inflight) at every inflight, one line for all."""
    from clann_tpu_torch.ops import gather as tg

    err = max(check_gather(f"{label}, inflight {f}", lambda: kern(f), ref, quiet=True)
              for f in tg.INFLIGHT_CHOICES)
    log(f"[gather] {label}: bit-identical to the plain version at inflight "
        f"{', '.join(map(str, tg.INFLIGHT_CHOICES))} ({ref.numel()} words)")
    return err


def gather_time_line(name, rows, shape, moved, useful, t, card):
    """The [gather-time] lines of probes.gather_rate.kernel_times' readings
    (device ms by CUDA-graph replay, call ms by a Python loop); the
    kernels-line numbers (device ms, the share of the bound taken on them)."""
    k, p, lib = t["kernel"], t["plain"], t["library"]
    ms, each = k["device_ms"], k["device_each"]
    # each picked row read once and written once, and the indices
    b_ms, b_by = bound(0.0, rows * (2.0 * moved + 4))
    log(f"[gather-time] {name} at {rows} rows of {shape}: device {ms:.4f} ms ({each[0]:.4f}, "
        f"{each[1]:.4f}; {rows * moved / ms / 1e6:.1f} GB/s moved, {rows * useful / ms / 1e6:.1f} "
        f"useful; {b_ms / ms:.3f} of the {b_ms:.4f} ms bound by {b_by}), call {k['call_ms']:.4f} "
        f"ms; plain device {p['device_ms']:.4f} / call {p['call_ms']:.4f} ms; library device "
        f"{lib['device_ms']:.4f} / call {lib['call_ms']:.4f} ms (one torch.index_select of the "
        f"same rows); device ms by CUDA-graph replay, call ms by a Python loop, 20 calls, on "
        f"{card}")
    log(f"[gather-time] {name} device ms by inflight: "
        + ", ".join(f"{f}: {ms:.4f}" for f, ms in t["inflight"].items())
        + f"; index_select {lib['device_ms']:.4f}, bound {b_ms:.4f} on {card}")
    return {"ms": ms, "plain_ms": p["device_ms"], "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib["device_ms"]}


def phase_gather(card):
    """K4-K7 against their plain versions at every inflight, at the probe's
    shapes, K7 at the engine's, at ragged shapes and K7 at widths of 1 to
    128 words, aligned and not; K5 also at group rows below and above one 4
    KB stage, and refusing an unaligned source; then each kernel, its plain
    version and one index_select timed on the device alone and per call,
    each iteration on its own rotated index vector (the probe's protocol),
    each kernel also at every inflight, beside the card's contiguous copy
    of as many bytes."""
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
    # name, kernel(i, inflight), plain(i), source rows, moved / useful bytes
    # per index, the source as the 2-D rows one index picks (for the library
    # yardstick, one torch.index_select)
    cases = [
        ("K4 gather_pages", lambda i, **kw: tg.gather_pages(pages, i, **kw),
         lambda i: tg.pages_plain(pages, i), T // 8, 4096, 4096, f"pages {tuple(pages.shape)}",
         pages.view(pages.shape[0], -1)),
        ("K5 gather_group8", lambda i, **kw: tg.gather_group8(table, i, **kw),
         lambda i: tg.group8_plain(table, i), T // 8, 8 * W * 4, W * 4,
         f"8-row groups of {tuple(table.shape)}", table[: 8 * (T // 8)].reshape(T // 8, 8 * W)),
        ("K6 gather_flat1d", lambda i, **kw: tg.gather_flat1d(flat, i, width=W, **kw),
         lambda i: tg.flat1d_plain(flat, i, width=W), T, W * 4, W * 4,
         f"{W}-word slices of ({flat.shape[0]},)", flat.view(-1, W)),
        ("K7 gather_rows", lambda i, **kw: tg.gather_rows(rec, i, **kw),
         lambda i: tg.rows_plain(rec, i), rec.shape[0], rec.shape[1] * 4, rec.shape[1] * 4,
         f"engine records {tuple(rec.shape)} (L={gr.ENGINE_L}, G={gr.ENGINE_G})", rec),
    ]
    # the card's copy ceiling: one contiguous copy of the bytes a 4 KB-row
    # gather reads and writes, timed by a loop of calls (the host's share of
    # a 0.36 ms copy is small; replayed from a CUDA graph the same copy_
    # read 0.44 ms on an H100, slower than the gathers it bounds)
    src_c = torch.empty(rows * 1024, dtype=torch.int32, device=dev)
    dst_c = torch.empty_like(src_c)
    copy_ms = gr.time_iters(lambda: dst_c.copy_(src_c), [()] * 20, 3)
    del src_c, dst_c
    log(f"[gather-time] copy ceiling: one contiguous torch copy_ of {rows * 4096 / 1e6:.1f} MB "
        f"into {rows * 4096 / 1e6:.1f} MB: {copy_ms:.4f} ms "
        f"({2 * rows * 4096 / copy_ms / 1e6:.1f} GB/s read + written) on {card}")
    out = {}
    for name, kern, plain, n_src, moved, useful, shape, src2d in cases:
        i0 = idx_in(n_src)
        err = check_every(f"{name} at {rows} rows of {shape}", lambda f: kern(i0, inflight=f),
                          plain(i0))
        for count in (rows + 37, 1001):  # not a multiple of a CTA's rows
            ir = ragged(n_src, count)
            err = max(err, check_every(f"{name} ragged: {count} rows, indices 0, last, -1, "
                                       f"{n_src}", lambda f: kern(ir, inflight=f), plain(ir)))
        sets = [(i,) for i in gr.rotated(i0, n_src, 20)]
        t = gr.kernel_times(kern, plain, lambda i: torch.index_select(src2d, 0, i), sets)
        out[name.split()[0]] = dict(max_abs_err=err, **gather_time_line(
            name, rows, shape, moved, useful, t, card))
    del table, pages, rec, flat
    # K5 at group rows below (W = 4: 128 B) and above (W = 300: 9,600 B, three
    # stages) one 4 KB stage; then an unaligned source, which must be refused
    for w, groups in ((4, 100_003), (300, 5_003)):
        t = gr.random_words((8 * groups + 5, w), gen, dev)  # 5 rows of a partial group
        for count in (rows + 37, 1001):
            ir = ragged(groups, count)
            out["K5"]["max_abs_err"] = max(out["K5"]["max_abs_err"], check_every(
                f"K5 gather_group8 at W={w} ({32 * w} B groups of {tuple(t.shape)}): "
                f"{count} rows, indices 0, last, -1, {groups}",
                lambda f: tg.gather_group8(t, ir, inflight=f), tg.group8_plain(t, ir)))
        del t
    words = gr.random_words((8 * 1000 * W + 1,), gen, dev)
    odd = words[1:].view(8 * 1000, W)  # 4 bytes past a 16-byte boundary
    try:
        tg.gather_group8(odd, idx_in(1000, 64))
    except ValueError as e:
        log(f"[gather] K5 on a source 4 bytes off 16-byte alignment refused: {e}")
    else:
        fail("K5 took a source that is not 16-byte aligned")
    # K7 at widths of 1 to 128 words: 16-byte units where the width and the
    # base allow, else 4-byte units (e.g. the 12-byte records of G = 1, R = 3)
    for w in (1, 3, 12, 48, 100, 128):
        words = gr.random_words((5003 * w + 1,), gen, dev)
        ir = ragged(5003, 4099)
        for off, where in ((0, "16-byte aligned"), (1, "4 bytes off 16-byte alignment")):
            t = words[off: off + 5003 * w].view(5003, w)
            out["K7"]["max_abs_err"] = max(out["K7"]["max_abs_err"], check_every(
                f"K7 gather_rows at W={w} ({4 * w} B rows of {tuple(t.shape)}, {where}): 4099 "
                f"rows, indices 0, last, -1, 5003", lambda f: tg.gather_rows(t, ir, inflight=f),
                tg.rows_plain(t, ir)))
        del words
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
    reset_peak()
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


def _qps_line(times):
    return ", ".join(f"{x:.4f}" for x in times)


def phase_dense(handle, test, gt_d, gt_i, build_spans, card):
    """The dense IVF layout of the main-path index through the facade: the
    default mode (ungated), bench.py's n_probe sweep, and every row (gated)."""
    import numpy as np

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops.ivf import DenseSearchStats, auto_n_probe, dense_search

    idx = handle.index
    if idx.seg_vectors is None:
        fail("the main-path build (default dense_layout) made no dense layout")
    R, cap = idx.seg_vectors.shape[:2]
    sizes = idx.seg_sizes.cpu().numpy()
    log(f"[dense] layout: R={R} rows of seg_cap {cap} for {idx.n_clusters} clusters "
        f"(largest row {int(sizes.max())}, mean {float(sizes.mean()):.0f} points, "
        f"{float(sizes.sum()) / (R * cap):.3f} of slots real); seg_vectors "
        f"{idx.array_bytes()['seg_vectors'] / 1e9:.3f} GB; build/dense_layout span "
        f"{build_spans.get('build/dense_layout', float('nan')):.3f} s (synchronized)")

    def report(label, d, i, st, times, gated, n_queries=N_QUERIES):
        check_result(d, i, label, n_queries)
        rec = recall_values(gt_d[:n_queries], d, K)[0]
        idr = recall_by_ids(gt_i[:n_queries], i, K)
        unc = np.asarray(st.uncertified)
        log(f"[dense] {label}: recall@10 {rec:.4f}, id-recall {idr:.4f}"
            f"{f' (gates {RECALL_GATE} / {ID_RECALL_GATE})' if gated else ' (no gate)'}; "
            f"dc/query {float(np.mean(st.distance_computations)):.0f}; rows visited/query "
            f"{float(np.mean(st.clusters_visited)):.2f}; dropped probes "
            f"{int(st.dropped_probes)}; uncertified queries {int((unc > 0).sum())}; "
            f"{n_queries / float(np.median(times)):.0f} QPS (median of {len(times)}, s/call "
            f"{_qps_line(times)}) on {card}")
        return rec, idr

    # the default mode: "auto" resolves to "dense" on an index with the layout
    n_probe = auto_n_probe(R)
    d, i, st = handle.search_batch(test)
    if not isinstance(st, DenseSearchStats) or st.probed_clusters.shape[1] != n_probe:
        fail("the default mode did not resolve to dense at auto_n_probe(R)")
    _, times = qps(lambda: handle.search_batch(test))
    report(f"default mode (auto -> dense, n_probe {n_probe} of {R})", d, i, st, times, False)

    # bench.py's IVF sweep (bench.py:393-424)
    sub = IVF_SWEEP_QUERIES
    chosen, r = None, 0.0
    for p in IVF_SWEEP:
        if p > R:
            break
        d_, _, st_ = dense_search(idx, test[:sub], k=K, n_probe=p, batch_size=IVF_BATCH)
        r = recall_values(gt_d[:sub], d_, K)[0]
        log(f"[dense] sweep n_probe={p}: recall@10 {r:.4f} dc/query "
            f"{float(np.mean(st_.distance_computations)):.0f} on {sub} queries")
        if r >= 0.9:
            chosen = p
            break
        if p >= 48 and r < 0.75:
            log("[dense] sweep: IVF cannot reach 0.9 at a reasonable probe depth; skipping")
            break
    if chosen is not None:
        run = lambda: dense_search(idx, test, k=K, n_probe=chosen, batch_size=IVF_BATCH)
        d, i, st = run()
        _, times = qps(run)
        report(f"ivf-p{chosen} (the sweep's choice)", d, i, st, times, False)

    # every row: an exhaustive probe is an exact search (tests/test_ivf.py:59)
    d, i, st = handle.search_batch(test, mode="dense", n_probe=R)
    _, times = qps(lambda: handle.search_batch(test, mode="dense", n_probe=R), reps=3)
    rec, idr = report(f"dense n_probe={R} (every row)", d, i, st, times, True)
    if rec < RECALL_GATE or idr < ID_RECALL_GATE or int(st.dropped_probes) != 0:
        fail("dense at every row: recall below the gate or dropped probes")


def phase_adaptive(handle, test, gt_d, gt_i, card):
    """mode="adaptive" (dense waves of 16 rows until the ball certificate
    retires each query), run to completion, gated."""
    import numpy as np

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values

    d, i, st = handle.search_batch(test, mode="adaptive")
    _, times = qps(lambda: handle.search_batch(test, mode="adaptive"), reps=3)
    check_result(d, i, "adaptive")
    rec, idr = recall_values(gt_d, d, K)[0], recall_by_ids(gt_i, i, K)
    visited = np.asarray(st.clusters_visited)
    log(f"[adaptive] recall@10 {rec:.4f}, id-recall {idr:.4f} (gates {RECALL_GATE} / "
        f"{ID_RECALL_GATE}); waves run {int(np.ceil(visited.max() / 16))} (of "
        f"{-(-handle.index.seg_centers.shape[0] // 16)}); rows visited/query "
        f"{float(visited.mean()):.1f} (max {int(visited.max())}); dc/query "
        f"{float(np.mean(st.distance_computations)):.0f}; uncertified "
        f"{int(np.sum(st.uncertified))}; {N_QUERIES / float(np.median(times)):.0f} QPS "
        f"(median of {len(times)}, s/call {_qps_line(times)}) on {card}")
    if rec < RECALL_GATE or idr < ID_RECALL_GATE:
        fail("adaptive recall below the gate")


def walk_config():
    """The README quickstart's L = 50 with the reference-faithful engine."""
    import clann_tpu_torch

    return clann_tpu_torch.Config(
        num_tables=50, num_clusters_factor=0.4, k=K, delta=WALK_DELTA, seed=0,
        lsh_engine="clustered", dense_layout=False,
        dataset_name=f"glove-{DIMS}-angular-synthetic",
    )


def phase_walk_build(train, card):
    import torch

    import clann_tpu_torch

    cfg = walk_config()
    sync()
    reset_peak()
    handle = clann_tpu_torch.init_with_config(train, cfg, device=DEVICE)
    t0 = time.perf_counter()
    with traced() as spans:
        handle.build()
        sync()
    build_s = time.perf_counter() - t0
    idx = handle.index
    log(f"[walk-build] L={cfg.num_tables} clustered engine on {N_TRAIN} x {DIMS}: build "
        f"{build_s:.3f} s; spans (s, synchronized): {spans()}; {idx.n_clusters} clusters, "
        f"max segment {idx.max_seg_len}, dir_bits {idx.dir_bits}")
    nbytes = idx.array_bytes()
    log(f"[walk-build] bytes: " + ", ".join(
        f"{f} {tuple(getattr(idx, f).shape)} {nbytes[f] / 1e6:.1f} MB"
        for f in ("slot_records", "sorted_hash", "sorted_idx", "prefix_dir", "sketches",
                  "vectors")))
    log(f"[walk-build] index {idx.memory_usage() / 1e9:.3f} GB; peak device memory of the "
        f"build {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    if idx.slot_records is None or idx.prefix_dir is None or idx.g_records is not None:
        fail("the clustered build made no slot records / prefix directory, or global tables")
    return handle


def phase_walk(handle, test, gt_d, gt_i, card):
    """mode="lsh" on a clustered build (the walk) through the facade, gated;
    its loop counts from a second call; K7 at the walk's shape; then
    search_by_id. Returns the walk's K7 launches and check_walk_gather's
    readings."""
    import numpy as np
    import torch

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops.query import LoopStats, search

    q, gd, gi = test[:WALK_QUERIES], gt_d[:WALK_QUERIES], gt_i[:WALK_QUERIES]
    tg.reset_launches()
    t0 = time.perf_counter()
    d, i, st = handle.search_batch(q, mode="lsh", delta=WALK_DELTA)
    sync()
    first_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    check_result(d, i, "walk", WALK_QUERIES)
    rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
    ls = LoopStats()
    sync()
    t0 = time.perf_counter()
    _, i2, _ = search(handle.index, q, delta=WALK_DELTA, loop_stats=ls)
    sync()
    walk_s = time.perf_counter() - t0
    nb = ls.batches
    log(f"[walk] delta={WALK_DELTA}: recall@10 {rec:.4f} (gate {0.8 * WALK_DELTA:.2f}), "
        f"id-recall {idr:.4f}; dc/query {float(np.mean(st.distance_computations)):.1f}, "
        f"candidates/query {float(np.mean(st.candidates)):.1f}, clusters visited/query "
        f"{float(np.mean(st.clusters_visited)):.2f} (max {int(np.max(st.clusters_visited))}); "
        f"K7 launches {launches}; {nb} batches of 256: {ls.outer_steps / nb:.1f} outer steps, "
        f"{ls.iterations / nb:.1f} inner iterations and {ls.syncs / nb:.1f} host syncs per "
        f"batch; {walk_s / nb:.3f} s per batch, "
        f"{WALK_QUERIES / walk_s:.1f} QPS (first call {first_s:.3f} s, "
        f"{WALK_QUERIES / first_s:.1f} QPS) on {card}")
    if launches < 1:
        fail("the walk did not launch the K7 kernel")
    if rec < 0.8 * WALK_DELTA:
        fail(f"walk: recall@10 {rec:.4f} below 0.8 * delta")
    if not np.array_equal(i, i2):
        fail("the walk is not deterministic across two calls")
    walk_k7 = check_walk_gather(handle.index, card)
    walk_ball_readings(handle.index, q, d, gd, np.asarray(st.clusters_visited))

    # search_by_id: k results, never the point itself, and search at k + 1
    pts = np.arange(BY_ID_POINTS, dtype=np.int64) * (N_TRAIN // BY_ID_POINTS)
    t0 = time.perf_counter()
    bd, bi, _ = handle.search_by_id(pts)
    by_id_s = time.perf_counter() - t0
    check_result(bd, bi, "search_by_id", BY_ID_POINTS)
    vec = handle.index.vectors[torch.as_tensor(pts, device=handle.index.device)]
    sd, si, _ = search(handle.index, vec, k=K + 1, delta=WALK_DELTA)
    agree = all(np.array_equal(bi[r], si[r][si[r] != pts[r]][:K]) for r in range(len(pts)))
    log(f"[walk] search_by_id on {BY_ID_POINTS} indexed points: {by_id_s:.3f} s; own id in a "
        f"row: {int((bi == pts[:, None]).sum())}; equal to search at k+1 without the point: "
        f"{agree}")
    if (bi == pts[:, None]).any() or not agree:
        fail("search_by_id returned a point's own id or disagrees with search at k + 1")
    return launches, walk_k7


def check_walk_gather(idx, card):
    """K7 against its plain version at the walk's shape: the built
    slot_records viewed as (L * nb, G * R) block rows (the walk's rec_view),
    one 256-query batch's 256 * WB indices, and ragged counts with indices 0,
    last, -1 and n, at every inflight; then timed as in phase_gather (device
    ms and call ms) on rotated index vectors. Returns the kernels-line
    numbers at this shape."""
    import torch

    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.probes import gather_rate as gr

    cfg = idx.config
    L, n_pad, R = idx.slot_records.shape
    G = cfg.gather_block
    view = idx.slot_records.view(L * (n_pad // G), G * R)
    n_src = view.shape[0]
    rows = 256 * max(1, cfg.candidate_chunk * cfg.filter_expand // G)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    i0 = torch.randint(0, n_src, (rows,), dtype=torch.int32, generator=gen, device=DEVICE)
    shape = f"slot records {tuple(view.shape)} (L={L}, G={G}, {G * R * 4}-byte rows)"
    kern = lambda i, **kw: tg.gather_rows(view, i, **kw)
    plain = lambda i: tg.rows_plain(view, i)
    err = check_every(f"K7 gather_rows at the walk's {rows} rows of {shape}",
                      lambda f: kern(i0, inflight=f), plain(i0))
    for count in (rows + 37, 1001):
        ir = torch.randint(0, n_src, (count,), dtype=torch.int32, generator=gen, device=DEVICE)
        ir[:4] = torch.tensor([0, n_src - 1, -1, n_src], dtype=torch.int32, device=DEVICE)
        err = max(err, check_every(f"K7 gather_rows at the walk's shape, ragged: {count} rows, "
                                   f"indices 0, last, -1, {n_src}", lambda f: kern(ir, inflight=f),
                                   plain(ir)))
    sets = [(i,) for i in gr.rotated(i0, n_src, 20)]
    t = gr.kernel_times(kern, plain, lambda i: torch.index_select(view, 0, i), sets)
    return dict(rows=rows, row_bytes=G * R * 4, max_abs_err=err, **gather_time_line(
        "K7 gather_rows (walk)", rows, shape, G * R * 4, G * R * 4, t, card))


def walk_ball_readings(idx, q, d, gt_d, visited):
    """The walk's ball-overlap stop (index.rs:342-361) against a numpy
    recomputation from the built index. It fires at a rank only where the
    cluster's bound center_dist - radius exceeds the queue's k-th distance
    at that time, which is never below the final k-th distance, nor the
    true one. So a query whose largest bound over all clusters is at most
    its final k-th distance must visit every cluster, and a query that
    stopped at rank r must have that cluster's bound above it. Radii are
    recomputed in f64 from each point's distance to its cluster's center."""
    import numpy as np
    import torch

    from clann_tpu_torch.ops.distances import exact_dot, l2_normalize

    tol = 1e-4  # f32 (the walk) against f64 (here)
    C = idx.n_clusters
    x = idx.vectors.cpu().numpy()
    a = idx.assignment.cpu().numpy().astype(np.int64)
    cen = idx.centers.cpu().numpy().astype(np.float64)
    dist = np.empty(len(x))
    for s in range(0, len(x), 1 << 18):
        xs = x[s : s + (1 << 18)].astype(np.float64)
        dist[s : s + len(xs)] = np.clip(1.0 - np.einsum("nd,nd->n", xs, cen[a[s : s + len(xs)]]),
                                        0.0, 2.0)
    radii_np = np.zeros(C)
    np.maximum.at(radii_np, a, dist)
    radii = idx.radii.cpu().numpy()
    qn = q.astype(np.float64) / np.linalg.norm(q.astype(np.float64), axis=1, keepdims=True)
    bound = np.clip(1.0 - qn @ cen.T, 0.0, 2.0) - radii_np[None, :]  # (Q, C)
    kth_walk, kth_true = d[:, K - 1].astype(np.float64), gt_d[:, K - 1].astype(np.float64)
    slack = bound.max(axis=1) - kth_walk
    slack_true = bound.max(axis=1) - kth_true

    def qs(v):
        return "/".join(f"{x:.4f}" for x in np.quantile(v, [0.0, 0.5, 0.9, 1.0]))

    log(f"[walk] radii (min/median/90%/max): port {qs(radii)}, numpy {qs(radii_np)}, max "
        f"|diff| {float(np.abs(radii - radii_np).max()):.2e}; k-th distance {qs(kth_walk)} "
        f"(true {qs(kth_true)}); largest ball bound center_dist - radius over the {C} "
        f"clusters minus the final k-th distance {qs(slack)} (against the true k-th "
        f"{qs(slack_true)}); queries whose bound can fire at some rank: "
        f"{int((slack > -tol).sum())} of {len(q)}")
    if float(np.abs(radii - radii_np).max()) > tol:
        fail("the walk index's radii differ from their numpy recomputation")
    # the walk's own cluster order (the f32 center distances, stable)
    qt = l2_normalize(torch.as_tensor(q, dtype=torch.float32, device=idx.device))
    order = torch.argsort(torch.clamp(1.0 - exact_dot(qt, idx.centers.T), 0.0, 2.0), dim=1,
                          stable=True).cpu().numpy()
    must_visit_all = slack <= -tol
    stopped = np.flatnonzero(visited < C)
    fired = np.array([bound[r, order[r, visited[r]]] > kth_walk[r] - tol for r in stopped],
                     bool)
    ranks = sorted(visited[stopped].tolist())
    log(f"[walk] numpy witness: {int(must_visit_all.sum())} queries cannot stop (largest "
        f"bound below the final k-th distance), of which {int((visited[must_visit_all] == C).sum())} "
        f"visited all {C} clusters; {len(stopped)} stopped early (at ranks "
        f"{ranks[:20]}{' ...' if len(ranks) > 20 else ''}), {int(fired.sum())} of them where "
        f"the numpy bound of that rank's cluster exceeds the final k-th distance")
    if (visited[must_visit_all] != C).any() or not fired.all():
        fail("the walk's ball-overlap stops disagree with the numpy recomputation")


def profile_lsh(handle, test, label="lsh", sessions=2, host_ops=True):
    """Device time by kernel for one 256-query batch of mode "lsh" (the
    global engine or the walk, whichever the index was built for). The
    first of two sessions pays the profiler's start-up; `host_ops=False`
    records device events only (the walk's batch launches ~10^6 ops)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    q = test[:256]
    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=acts) as prof:
            t0 = time.perf_counter()
            handle.search_batch(q, mode="lsh")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    rows.sort(key=lambda e: -e.self_device_time_total)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    launches = sum(e.count for e in rows)
    log(f"[profile] {label} search_batch of 256 queries: wall {wall * 1e3:.2f} ms under the "
        f"profiler, device busy {busy:.2f} ms (idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}), "
        f"{launches} device kernels / copies")
    for e in rows[:15]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} {e.key[:90]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="add torch.profiler breakdowns of one scan-pallas call, one "
                         "scan-block call, one dense call and one 256-query batch of "
                         "the lsh engine and of the walk")
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
    handle, gt_d, gt_i, launches_k1, build_spans = phase_main_path(train, test, label)
    launches_k2 = phase_pallas_scan_topk(train, test, gt_d, gt_i, label)
    k3 = phase_k3_bench(handle.index, test, label)
    launches_k3 = phase_block_modes(handle, test, gt_d, gt_i, label)
    phase_dense(handle, test, gt_d, gt_i, build_spans, label)
    phase_adaptive(handle, test, gt_d, gt_i, label)
    log(f"[main] peak device memory over the whole run "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if args.profile:
        for mode in ("scan-pallas", "scan-block", "dense"):
            profile_search(handle, test, mode)
    del handle
    torch.cuda.empty_cache()

    gather = phase_gather(label)
    probe_launches = phase_gather_probe(label)
    lsh = phase_lsh_build(train, label)
    launches_lsh = phase_lsh(lsh, test, gt_d, gt_i, label)
    if args.profile:
        profile_lsh(lsh, test)
    del lsh
    torch.cuda.empty_cache()
    walk = phase_walk_build(train, label)
    launches_walk, walk_k7 = phase_walk(walk, test, gt_d, gt_i, label)
    if args.profile:
        profile_lsh(walk, test, "walk (lsh -> lsh-clustered)", sessions=1, host_ops=False)
    launches_k7 = launches_lsh + launches_walk
    log(f"[main] K7 launches: {launches_k7} = lsh {launches_lsh} + walk {launches_walk}")
    log(f"[main] peak device memory over the whole run, all paths "
        f"{max(PEAKS + [torch.cuda.max_memory_allocated()]) / 1e9:.3f} GB")

    kernels = [
        ("scan_topk_packed (K1)", "clann_tpu_torch/csrc/scan_topk.cu",
         "clann_tpu/ops/pallas/scan_topk.py:209", launches_k1, k1),
        ("scan_candidates (K2)", "clann_tpu_torch/csrc/scan_topk.cu",
         "clann_tpu/ops/pallas/scan_topk.py:287", launches_k2, k2),
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
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    entries = [{"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, **{k: m[k] for k in keys}}
               for name, source, replaces, launches, m in kernels]
    # K7's numbers above are at the engine's 512 B records; the walk, which
    # makes most of its launches, gathers 192 B records
    entries[-1]["walk"] = walk_k7
    log(json.dumps({"kernels": entries}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
