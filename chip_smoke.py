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

Phases 7b, 7c, 11b, 11c and 12 drive the continuous driver, the int8
rescore, the reference's index files and the Jaccard set index:

7b. lsh-continuous (right after phase 7, on its index, so that the walk's
   build sees the device as before): global_search_continuous (256 lanes,
   8 iterations per step) on the 2,048 lsh queries at delta 0.95, held per
   query to global_search at batch 256 (ids and dc identical, sims within
   1e-6), gated recall@10 >= 0.8 * delta; QPS of both (median of 3), its
   steps, refills and K7 launches, and global_search at batch 1,024 (not
   gated).
7c. lsh-int8: the same index under rescore_dtype="int8" (derived from the
   f32 build by core.index.with_rescore_dtype, the function the build
   calls) and queries, gated recall@10 >= 0.8 * delta; QPS, dc/query and
   peak device memory beside the f32 run; whether torch.bmm takes int8
   CUDA operands (not relied on).
11b. walk-int8: one 256-query batch of the walk under int8, gated like
   the walk.
11c. interop (right after phase 11b, on the walk's index; the card has no
   HDF5 library, so io/interop's in-memory halves run, not its file
   wrappers): the codec built with g++ from clann_tpu_torch/native/codec.cpp;
   the index exported to the Rust reference's per-cluster streams
   (seconds, bytes); the faithful import with data=train, whose
   per-cluster hash and sketch params must have a leading C axis and whose
   tables, ids and sketches must equal the source's bit for bit over the
   non-brute clusters (radii and center ids equal); the re-export, every
   stream byte-identical to the export; one 256-query batch of the walk
   on the import through ops.query.search, the per-cluster branch, gated
   recall@10 >= 0.8 * delta and the source walk's id sets on >= 0.95 of
   the queries, failing if K7 was not launched (the per-cluster hashing
   seconds, dc and batch seconds beside the source walk's). After phase
   12, on its corpus and configuration with the tabulation functions the
   format needs: a flat build, the reference Jaccard stream, its import
   (arrays equal, re-stream byte-identical) and one 128-query batch on
   both with equal ids (K7).
12. jaccard: scripts/jaccard_baseline.py's corpus (clustered_sets of
   200,000 sets over a universe of 50,000, mean size 64, 1024 modes) and
   512 queries, ground truth by brute_force_jaccard_topk on the card; the
   flat and the clustered build (L = 50, gather_block 16, chunk 512,
   filter_expand 8, JACCARD_KNOBS.json's best row); jaccard_search in
   batches of 128 (256 queries if the first batch projects 512 past 120
   s), gated threshold recall@10 >= 0.8 * delta, the clustered ids equal
   to the flat ones; jaccard_scan, whose ids must equal the ground truth
   up to ties; K7 bit-exact at the engine's 256-byte rows (32,768 per
   128-query iteration) at every inflight and ragged, and timed as in
   phase 5.

Phases 7d, 13, 13b and 14 drive closest pairs, insert / rebuild, the
SQLite metrics sink and the upstream PUFFINN surface on the same data:

7d. join (right after phase 7c, on the lsh index: L = 128, 435 clusters):
   Clann.closest_pairs(k=100, delta=0.9); the pairs must be canonical
   (i < j) and unique, their sims non-increasing and within 1e-4 of the
   exact f32 (x_i . x_j + 1) / 2, and they must be the top 100 of the
   pairs that sit within the sweep's final window in some table (JAX's
   windowed join, recomputed table by table apart from ops.join). The
   exact top 100 pairs of the data are the script's own oracle
   (pair_oracle: every pair i < j by f32 products in blocks of 1,024
   rows); the share of the returned pairs that reach the true 100th
   similarity - 1e-6 and the recall of the true top 100 are readings, not
   gated: JAX's window model stops at window 4 here and finds 0.39 of
   them (PERF.md, PR 10), below the 0.5 its compat test reaches at 600
   points; JAX's own join falls below half on one dense mode
   (tests/test_torch_join.py), and the script prints how often a true
   pair sits within the final window against the rule's model. The
   windows of the sweep with their seconds and the peak memory are
   printed.
13. update (after phase 12): the lsh configuration with the SQLite sink on
   (metrics_output=DB), built on the first 1,083,514 points; the last
   100,000 inserted through Clann.insert in 4 calls; 100,000 pending, every
   inserted point inside its (possibly grown) ball within 1e-5 and no
   radius shrunk; mode="lsh" on 2,048 queries returns no pending id;
   scan-pallas (K1, which reads the vectors and sees pending points) on the
   10,000 queries gated recall@10 >= 0.9 and id-recall >= 0.8 against the
   ground truth over all 1,183,514 points; rebuild(); the old points'
   hashes and sketches unchanged bit for bit, mode="lsh" (K7) gated
   recall@10 >= 0.8 * delta over all points, and 256 inserted points as
   queries finding an inserted point at distance < 1e-5 at a rate >= 0.9
   (JAX's bar). Seconds of each insert, the rebuild and the build, peak
   memory.
13b. metrics-db: save_metrics of that run to build/chip_smoke_metrics.db
   (QUERY granularity), read back: one build row whose memory_used_bytes
   is the build's memory_usage(), one cluster row per cluster, one query
   row per query searched since reset_metrics.
14. puffinn: puffinn.Index("angular", 100, 5,335,185,152), a budget the
   byte model (parallel/capacity.py, the JAX package's) turns into L =
   128, checked; the 1,183,514 points inserted one call each, rebuild();
   256 single-query search(q, 10, 0.9) calls gated by the compat contract
   (correct ids >= 0.8 * recall * k * queries), failing if K7 was not
   launched; search_from_index on 3 ids excludes each; closest_pairs(10,
   0.9) (ids only) equal to ops.join.closest_pairs on the same index,
   whose pairs and sims are held to the windowed join as in 7d, its share
   in range of the oracle's 10th pair a reading; a pickle round trip (its
   second build lazy, on the first query) answers 2 queries identically.

Phases 9b, 7e, 11d, 12b, 15 and 16 drive the sharded paths (a 4-shard
mesh on the one card, make_mesh(4, devices=["cuda:0"] * 4): the shard
bodies run one after another), the CLI and the benchmark harness:

9b. sharded (right after phase 9, on the main-path index): shard_index
   over 4 shards, assert_balanced and shard_report printed;
   sharded_scan_search(use_pallas=True) on the 10,000 queries, failing
   unless K1 launched once per shard, gated recall@10 >= 0.9 and
   id-recall >= 0.8, its QPS (median of 3) beside the single-device
   scan-pallas; exact=True, its ids equal to the single-device exact scan
   up to ties; build_sharded with the main path's config, equal on every
   real slot to the shards of the built index (seconds and peak memory of
   each step).
7e. sharded lsh (right after phase 7d, on the lsh index):
   sharded_global_search on the 2,048 lsh queries at delta 0.95, gated
   recall@10 >= 0.8 * delta, failing if K7 was not launched; a 2 x 2
   make_mesh_2d equal to its 1-D 2-shard mesh on 256 queries;
   sharded_closest_pairs(k=100, delta=0.9) equal to ops.join.closest_pairs.
11d. sharded walk (right after phase 11c, on the walk index, whose shards
   keep slot records): one 256-query sharded_search batch at delta 0.9,
   gated recall@10 >= 0.8 * delta, failing if K7 was not launched.
12b. sharded jaccard (after phase 12's round trip, on its corpus):
   shard_jaccard_index of the flat build and build_jaccard_sharded, equal
   shard for shard; sharded_jaccard_search of the 512 queries in batches
   of 128, gated threshold recall@10 >= 0.8 * delta, failing if K7 was not
   launched.
15. cli (after phase 14): clann_tpu_torch.__main__.main in-process on a
   1,183,514 x 100 synthetic set, 10,000 queries, L = 50, mode
   scan-pallas, --no-cache, --save build/cli_metrics.db: its printed
   recall@10 gated >= 0.9, failing if K1 was not launched, the saved query
   rows counted; then python -m clann_tpu_torch --plan as a subprocess.
16. bench (on the main-path data): minibench; run_benchmark_config_puffinn
   (the flat L = 50 walk with slot records, 256 queries: a cut of the
   10,000, printed) into build/bench_metrics.db, gated recall@10 >= 0.8 *
   delta and failing if K7 was not launched; compare_implementations_time
   (10 sampled queries, 3 repetitions: a cut of the reference's 15,
   printed); the ann-benchmarks adapter ClannTPU: fit, batch_query of the
   10,000 queries and one query.

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
# [interop]: one walk batch on the faithful import; the share of its queries
# whose id set equals the source walk's (JAX on the CPU reads 1.0)
INTEROP_QUERIES, INTEROP_SAME_IDS = 256, 0.95
CONT_LANES, CONT_STEP_ITERS = 256, 8  # global_search_continuous's defaults
# scripts/jaccard_baseline.py's set corpus, queries and batches
JACCARD_N, JACCARD_UNIVERSE, JACCARD_QUERIES, JACCARD_BATCH = 200_000, 50_000, 512, 128
JACCARD_DELTA = 0.9
JACCARD_CUT_S, JACCARD_CUT_QUERIES = 120.0, 256  # a slower variant runs 256 queries
BY_ID_POINTS = 256
# [join]: Clann.closest_pairs on the lsh index, held to the exact top pairs
JOIN_K, JOIN_DELTA, ORACLE_ROWS = 100, 0.9, 1024
# [update]: build on the first N_UPDATE_OLD points, insert the rest in
# UPDATE_CALLS calls, UPDATE_SELF inserted points searched as queries
N_UPDATE_OLD, UPDATE_CALLS, UPDATE_SELF = 1_083_514, 4, 256
# [puffinn]: the byte budget that the JAX package's model turns into L = 128
# at 1,183,514 x 100 (1,088,035,072 B fixed + 33,180,860 B per table)
PUFFINN_BUDGET, PUFFINN_QUERIES, PUFFINN_RECALL = 5_335_185_152, 256, 0.9
# the sharded paths: a mesh of SHARDS shards on the one card; the walk's
# sharded batch
SHARDS, SHARD_WALK_QUERIES, MESH_2D_QUERIES = 4, 256, 256
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
    from clann_tpu_torch.parallel.capacity import HBM_H100

    log(f"[device] {name}; count={torch.cuda.device_count()}; total_memory "
        f"{torch.cuda.get_device_properties(0).total_memory} B (plan_capacity's default "
        f"{HBM_H100}); torch {torch.__version__} cuda {torch.version.cuda}; "
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
    search_by_id. Returns the walk's K7 launches, check_walk_gather's
    readings and its first 256 queries' ids and dc with the seconds per
    batch (for [interop])."""
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
    # the first batch of 256 as [interop] compares it (batches are independent)
    source = dict(ids=i[:INTEROP_QUERIES], dc=np.asarray(st.distance_computations)[:INTEROP_QUERIES],
                  batch_s=walk_s / nb)
    return launches, walk_k7, source


def check_walk_gather(idx, card):
    """K7 against its plain version at the walk's shape: the built
    slot_records viewed as (L * nb, G * R) block rows (the walk's rec_view),
    one 256-query batch's 256 * WB indices, and ragged counts with indices 0,
    last, -1 and n, at every inflight; then timed as in phase_gather (device
    ms and call ms) on rotated index vectors. Returns the kernels-line
    numbers at this shape."""
    return check_record_gather(idx.slot_records, idx.config, 256, "walk", "slot records", 2,
                               card)


def check_record_gather(records, cfg, batch, path, what, seed, card):
    """K7 at the shape a record engine gives it (check_walk_gather): the
    (L, n_pad, R) `records` of `path` as block rows, one `batch`-query
    iteration's indices (batch * WB, from its config's G and window)."""
    import torch

    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.probes import gather_rate as gr

    L, n_pad, R = records.shape
    G = cfg.gather_block
    view = records.view(L * (n_pad // G), G * R)
    n_src = view.shape[0]
    rows = batch * max(1, cfg.candidate_chunk * cfg.filter_expand // G)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    i0 = torch.randint(0, n_src, (rows,), dtype=torch.int32, generator=gen, device=DEVICE)
    shape = f"{what} {tuple(view.shape)} (L={L}, G={G}, {G * R * 4}-byte rows)"
    kern = lambda i, **kw: tg.gather_rows(view, i, **kw)
    plain = lambda i: tg.rows_plain(view, i)
    err = check_every(f"K7 gather_rows at the {path}'s {rows} rows of {shape}",
                      lambda f: kern(i0, inflight=f), plain(i0))
    for count in (rows + 37, 1001):
        ir = torch.randint(0, n_src, (count,), dtype=torch.int32, generator=gen, device=DEVICE)
        ir[:4] = torch.tensor([0, n_src - 1, -1, n_src], dtype=torch.int32, device=DEVICE)
        err = max(err, check_every(f"K7 gather_rows at the {path}'s shape, ragged: {count} rows, "
                                   f"indices 0, last, -1, {n_src}", lambda f: kern(ir, inflight=f),
                                   plain(ir)))
    sets = [(i,) for i in gr.rotated(i0, n_src, 20)]
    t = gr.kernel_times(kern, plain, lambda i: torch.index_select(view, 0, i), sets)
    return dict(rows=rows, row_bytes=G * R * 4, max_abs_err=err, **gather_time_line(
        f"K7 gather_rows ({path})", rows, shape, G * R * 4, G * R * 4, t, card))


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


def phase_lsh_continuous(handle, test, gt_d, gt_i, card):
    """global_search_continuous (lanes 256, 8 iterations per step) on the
    lsh phase's index and queries at delta 0.95, held per query to
    global_search at batch 256 (ids and dc identical, sims within 1e-6),
    gated recall@10 >= 0.8 * delta; QPS of both drivers (median of 3) and
    of global_search at batch 1,024 (not gated)."""
    import numpy as np

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops.global_query import (LoopStats, global_search,
                                                  global_search_continuous)

    q, gd, gi = test[:LSH_QUERIES], gt_d[:LSH_QUERIES], gt_i[:LSH_QUERIES]
    delta, idx = LSH_DELTAS[0], handle.index
    run = lambda: global_search_continuous(idx, q, delta=delta, lanes=CONT_LANES,  # noqa: E731
                                           step_iters=CONT_STEP_ITERS, loop_stats=ls)
    ls = LoopStats()
    tg.reset_launches()
    cd, ci, cst = run()
    sync()
    launches = tg.ROWS_LAUNCHES
    steps, iters, syncs = ls.outer_steps, ls.iterations, ls.syncs
    bd, bi, bst = global_search(idx, q, delta=delta, batch_size=CONT_LANES)
    check_result(cd, ci, "lsh-continuous", LSH_QUERIES)
    rec, idr = recall_values(gd, cd, K)[0], recall_by_ids(gi, ci, K)
    same_ids = float(np.mean(np.all(ci == bi, axis=1)))
    same_dc = float(np.mean(cst.distance_computations == bst.distance_computations))
    sim_err = float(np.max(np.abs(cd - bd))) / 2.0  # distances are 2 (1 - sim)
    rate_c, times_c = qps(run, reps=3, n_queries=LSH_QUERIES)
    rate_b, times_b = qps(lambda: global_search(idx, q, delta=delta, batch_size=CONT_LANES),
                          reps=3, n_queries=LSH_QUERIES)
    global_search(idx, q[:LSH_BIG_BATCH], delta=delta, batch_size=LSH_BIG_BATCH)
    rate_big, times_big = qps(lambda: global_search(idx, q, delta=delta,
                                                    batch_size=LSH_BIG_BATCH),
                              reps=1, n_queries=LSH_QUERIES)
    log(f"[lsh-continuous] delta={delta}, {LSH_QUERIES} queries, {CONT_LANES} lanes, "
        f"{CONT_STEP_ITERS} iterations per step: recall@10 {rec:.4f} (gate "
        f"{0.8 * delta:.2f}), id-recall {idr:.4f}; against global_search at batch "
        f"{CONT_LANES}: same ids {same_ids:.5f}, same dc {same_dc:.5f}, largest sim difference "
        f"{sim_err:.3g}; {steps} steps, {LSH_QUERIES - CONT_LANES} refills, {iters} loop "
        f"iterations, {syncs} host syncs; K7 launches {launches}; dc/query "
        f"{float(np.mean(cst.distance_computations)):.1f} on {card}")
    log(f"[lsh-continuous] QPS (median of 3): continuous {rate_c:.1f} (s/call "
        f"{_qps_line(times_c)}), global_search batch {CONT_LANES} {rate_b:.1f} (s/call "
        f"{_qps_line(times_b)}); global_search batch {LSH_BIG_BATCH} {rate_big:.1f} (one call, "
        f"{_qps_line(times_big)}; not gated) on {card}")
    if launches < 1:
        fail("global_search_continuous did not launch the K7 kernel")
    if same_ids < 1.0 or same_dc < 1.0 or sim_err > 1e-6:
        fail("global_search_continuous differs from global_search per query")
    if rec < 0.8 * delta:
        fail(f"lsh-continuous: recall@10 {rec:.4f} below 0.8 * delta")
    return launches


def int8_handle(handle):
    """The handle's index under rescore_dtype="int8", derived from the f32
    build by the function the build calls (core.index.with_rescore_dtype)."""
    import copy

    from clann_tpu_torch.core.index import with_rescore_dtype

    h8 = copy.copy(handle)
    h8.index = with_rescore_dtype(handle.index, "int8")
    h8.config = h8.index.config
    return h8


def int8_bmm_probe():
    """Whether torch.bmm takes int8 CUDA operands (the port does not rely
    on it: its int8 dots are an exact f32 bmm of the int8 values)."""
    import torch

    a = torch.randint(-127, 128, (4, 8, 100), dtype=torch.int8, device=DEVICE)
    b = torch.randint(-127, 128, (4, 100, 1), dtype=torch.int8, device=DEVICE)
    want = torch.bmm(a.float(), b.float())
    try:
        got = torch.bmm(a, b)
    except RuntimeError as e:
        return f"refused ({str(e).splitlines()[0][:80]})"
    return f"accepted, dtype {got.dtype}, equal to the f32 dots: {torch.equal(got.float(), want)}"


def phase_lsh_int8(handle, test, gt_d, gt_i, card):
    """mode="lsh" on the lsh phase's index and queries at delta 0.95 with
    rescore_dtype="int8" (the index derived from the f32 build), gated
    recall@10 >= 0.8 * delta; QPS, dc/query and peak device memory beside
    the f32 run (printed, neither judged)."""
    import numpy as np
    import torch

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg

    q, gd, gi = test[:LSH_QUERIES], gt_d[:LSH_QUERIES], gt_i[:LSH_QUERIES]
    delta = LSH_DELTAS[0]
    h8 = int8_handle(handle)
    log(f"[lsh-int8] vectors_q8 {tuple(h8.index.vectors_q8.shape)} "
        f"{h8.index.vectors_q8.numel() / 1e6:.1f} MB; torch.bmm on int8 CUDA operands: "
        f"{int8_bmm_probe()}")
    launches = 0
    for label, h in (("float32", handle), ("int8", h8)):
        sync()
        reset_peak()
        tg.reset_launches()
        d, i, st = h.search_batch(q, mode="lsh", delta=delta)
        sync()
        peak = torch.cuda.max_memory_allocated()
        launches_d = tg.ROWS_LAUNCHES
        check_result(d, i, f"lsh-int8 {label}", LSH_QUERIES)
        rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
        rate, times = qps(lambda: h.search_batch(q, mode="lsh", delta=delta), reps=3,
                          n_queries=LSH_QUERIES)
        log(f"[lsh-int8] rescore {label}, delta={delta}: recall@10 {rec:.4f}"
            f"{f' (gate {0.8 * delta:.2f})' if label == 'int8' else ''}, id-recall {idr:.4f}; "
            f"dc/query {float(np.mean(st.distance_computations)):.1f}; {rate:.1f} QPS (median "
            f"of 3: {_qps_line(times)}); peak device memory of the search {peak / 1e9:.3f} GB "
            f"(index resident); K7 launches {launches_d} on {card}")
        if label == "int8":
            launches = launches_d
            if launches_d < 1:
                fail("the int8 lsh search did not launch the K7 kernel")
            if rec < 0.8 * delta:
                fail(f"lsh-int8: recall@10 {rec:.4f} below 0.8 * delta")
    return launches


def phase_walk_int8(handle, test, gt_d, gt_i, card):
    """One 256-query batch of the walk with rescore_dtype="int8" (the walk
    index derived from its f32 build), gated recall@10 >= 0.8 * delta."""
    import numpy as np

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg

    q, gd, gi = test[:256], gt_d[:256], gt_i[:256]
    h8 = int8_handle(handle)
    tg.reset_launches()
    sync()
    t0 = time.perf_counter()
    d, i, st = h8.search_batch(q, mode="lsh", delta=WALK_DELTA)
    sync()
    walk_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    check_result(d, i, "walk int8", 256)
    rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
    log(f"[walk-int8] one 256-query batch, delta={WALK_DELTA}: recall@10 {rec:.4f} (gate "
        f"{0.8 * WALK_DELTA:.2f}), id-recall {idr:.4f}; dc/query "
        f"{float(np.mean(st.distance_computations)):.1f}, clusters visited/query "
        f"{float(np.mean(st.clusters_visited)):.2f}; {walk_s:.3f} s; K7 launches {launches} "
        f"on {card}")
    if launches < 1:
        fail("the int8 walk did not launch the K7 kernel")
    if rec < 0.8 * WALK_DELTA:
        fail(f"walk-int8: recall@10 {rec:.4f} below 0.8 * delta")
    return launches


def phase_interop(handle, train, test, gt_d, gt_i, source, card):
    """The Rust reference's index files on the walk's index, in memory (the
    card has no HDF5 library; io/interop's file functions are thin wrappers
    around these halves): export to reference streams through the port's
    g++-built codec, the faithful import with data=train, checked bit for
    bit against the source, the re-export byte-identical to the export,
    and one 256-query batch of the walk through its per-cluster branch
    (K7), gated recall@10 >= 0.8 * delta and the source's id sets on >=
    INTEROP_SAME_IDS of the queries. Returns its K7 launches."""
    import numpy as np
    import torch

    from clann_tpu_torch.io import interop, refcodec
    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops.distances import as_device_f32, l2_normalize
    from clann_tpu_torch.ops.query import search
    from clann_tpu_torch.ops.sources import hash_per_cluster

    t_phase = time.perf_counter()
    src = handle.index
    t0 = time.perf_counter()
    lib = refcodec.build()
    log(f"[interop] codec {os.path.relpath(lib, HERE)} (g++ from "
        f"{os.path.relpath(refcodec.CODEC_SOURCE, HERE)}) ready in "
        f"{time.perf_counter() - t0:.3f} s")
    sync()
    reset_peak()
    t0 = time.perf_counter()
    streams = interop._reference_datasets(src)
    export_s = time.perf_counter() - t0
    blobs = sorted(k for k in streams if k.startswith("index_"))
    blob_bytes = sum(len(streams[k]) for k in blobs)
    n_brute = int(src.brute.sum())
    log(f"[interop] export of the walk index ({src.n_clusters} clusters, {n_brute} brute, "
        f"{src.config.hash_family}): {len(blobs)} reference streams, {blob_bytes} bytes "
        f"({blob_bytes / 1e9:.3f} GB; clusters JSON {len(streams['clusters']) / 1e6:.1f} MB) "
        f"in {export_s:.3f} s")
    if len(blobs) != src.n_clusters - n_brute:
        fail("[interop] the export wrote a stream count other than the non-brute clusters")

    sync()
    t0 = time.perf_counter()
    imp = interop._index_from_reference(streams, data=train, device=DEVICE)
    sync()
    import_s = time.perf_counter() - t0
    C = src.n_clusters
    pc_dims = {f"{f}.{k}": tuple(v.shape) for f in ("pc_hash_params", "pc_sketch_params")
               for k, v in (getattr(imp, f) or {}).items()}
    live_pt = ~src.brute[src.assignment.long()]
    slot_cluster = torch.repeat_interleave(
        torch.arange(C, device=src.device),
        (src.cluster_starts[1:] - src.cluster_starts[:-1]).long())
    live_slot = ~src.brute[slot_cluster]
    same = {
        "sorted_hash": torch.equal(imp.sorted_hash[:, live_slot], src.sorted_hash[:, live_slot]),
        "sorted_idx": torch.equal(imp.sorted_idx[:, live_slot], src.sorted_idx[:, live_slot]),
        "sketches": torch.equal(imp.sketches[live_pt], src.sketches[live_pt]),
        "radii": torch.equal(imp.radii, src.radii),
        "center_ids": torch.equal(imp.center_ids, src.center_ids),
    }
    log(f"[interop] faithful import (data=train) in {import_s:.3f} s: {imp.config.hash_family} "
        f"/ {imp.config.hash_source}, {imp.max_hashbits} bits; per-cluster params {pc_dims}; "
        f"equal to the source over the {int(live_slot.sum())} slots of non-brute clusters: "
        f"{same}")
    if (not pc_dims or any(v[0] != C for v in pc_dims.values())
            or imp.pc_sketch_params is None):
        fail("[interop] the import's per-cluster params lack a leading C axis")
    if not all(same.values()):
        fail(f"[interop] the import differs from the source: {same}")

    t0 = time.perf_counter()
    again = interop._reference_datasets(imp)
    reexport_s = time.perf_counter() - t0
    differ = [k for k in blobs if again.get(k) != streams[k]]
    log(f"[interop] re-export of the import in {reexport_s:.3f} s: {len(blobs) - len(differ)} of "
        f"{len(blobs)} streams byte-identical, clusters JSON "
        f"{'equal' if again['clusters'] == streams['clusters'] else 'DIFFERENT'}")
    if differ or sorted(again) != sorted(streams) or again["clusters"] != streams["clusters"]:
        fail(f"[interop] re-export is not byte-identical ({differ[:5]})")
    del streams, again

    q, gd, gi = test[:INTEROP_QUERIES], gt_d[:INTEROP_QUERIES], gt_i[:INTEROP_QUERIES]
    hsrc, filterer = imp.rebuild_objects()
    qn = l2_normalize(as_device_f32(q, imp.device))
    sync()
    t0 = time.perf_counter()
    qh = hash_per_cluster(hsrc, imp.pc_hash_params, qn)
    qs = hash_per_cluster(filterer, imp.pc_sketch_params, qn)
    sync()
    hash_s = time.perf_counter() - t0
    tg.reset_launches()
    sync()
    t0 = time.perf_counter()
    d, i, st = search(imp, q, delta=WALK_DELTA)
    sync()
    batch_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    check_result(d, i, "interop walk", INTEROP_QUERIES)
    rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
    same_ids = float(np.mean([set(a.tolist()) == set(b.tolist())
                              for a, b in zip(i, source["ids"])]))
    dc = float(np.mean(st.distance_computations))
    log(f"[interop] walk on the import, one {INTEROP_QUERIES}-query batch, delta={WALK_DELTA}: "
        f"recall@10 {rec:.4f} (gate {0.8 * WALK_DELTA:.2f}), id-recall {idr:.4f}; id sets equal to the source "
        f"walk's on {same_ids:.4f} of the queries (gate {INTEROP_SAME_IDS}); dc/query {dc:.1f}, "
        f"{dc / float(np.mean(source['dc'])):.5f} x the source's; per-cluster hashing and "
        f"sketching of the batch (qh {tuple(qh.shape)}, qs {tuple(qs.shape)}) {hash_s:.4f} s; "
        f"{batch_s:.3f} s per batch against the source walk's {source['batch_s']:.3f} s; K7 "
        f"launches {launches}; peak device memory of the phase "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; phase {time.perf_counter() - t_phase:.1f} "
        f"s on {card}")
    if launches < 1:
        fail("[interop] the walk on the import did not launch the K7 kernel")
    if rec < 0.8 * WALK_DELTA:
        fail(f"[interop] walk: recall@10 {rec:.4f} below 0.8 * delta")
    if same_ids < INTEROP_SAME_IDS:
        fail(f"[interop] walk: id sets equal to the source's on {same_ids:.4f} < "
             f"{INTEROP_SAME_IDS} of the queries")
    return launches


def phase_interop_jaccard(data, queries, card):
    """The reference Jaccard round trip on [jaccard]'s corpus and
    configuration with the tabulation functions the format needs (a
    flat build): stream, import, re-stream byte-identical, and one
    128-query batch on both with equal ids. Returns its K7 launches."""
    import numpy as np

    from clann_tpu_torch.core import jaccard as tj
    from clann_tpu_torch.io import interop, refcodec
    from clann_tpu_torch.ops import gather as tg

    t_phase = time.perf_counter()
    cfg = jaccard_config()
    sync()
    t0 = time.perf_counter()
    src = tj.build_jaccard_index(data, cfg, table_hash="tabulation_minhash", device=DEVICE)
    sync()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    buf = interop.jaccard_to_reference_stream(src)
    stream_s = time.perf_counter() - t0
    sync()
    t0 = time.perf_counter()
    imp = interop.jaccard_index_from_parsed(
        refcodec.parse_reference_stream(buf, family=refcodec.FAMILY_MINHASH), cfg, device=DEVICE)
    sync()
    import_s = time.perf_counter() - t0
    stable = interop.jaccard_to_reference_stream(imp) == buf
    same = {f: bool((getattr(imp, f) == getattr(src, f)).all())
            for f in ("sorted_hash", "sorted_idx", "sketches", "set_sizes", "g_records")}
    q = queries[:JACCARD_BATCH]
    launches, res = 0, []
    for idx in (src, imp):
        tg.reset_launches()
        sync()
        t0 = time.perf_counter()
        res.append((*tj.jaccard_search(idx, q), time.perf_counter() - t0))
        sync()
        launches += tg.ROWS_LAUNCHES
    log(f"[interop] jaccard: tabulation build of the {data.num_points()} sets {build_s:.3f} s; "
        f"reference stream {len(buf)} bytes in {stream_s:.3f} s; import {import_s:.3f} s, "
        f"arrays equal {same}; re-stream byte-identical {stable}; one {JACCARD_BATCH}-query batch "
        f"{res[0][3]:.3f} s (source) / {res[1][3]:.3f} s (import), ids equal "
        f"{np.array_equal(res[0][1], res[1][1])}, dc equal "
        f"{np.array_equal(res[0][2].distance_computations, res[1][2].distance_computations)}; "
        f"K7 launches {launches}; {time.perf_counter() - t_phase:.1f} s on {card}")
    if not (stable and all(same.values())):
        fail("[interop] jaccard: the import or its re-stream differs from the source")
    if not np.array_equal(res[0][1], res[1][1]):
        fail("[interop] jaccard: the import's ids differ from the source's")
    if launches < 2:
        fail("[interop] jaccard: a search did not launch the K7 kernel")
    return launches


def jaccard_config():
    """scripts/jaccard_baseline.py's configuration with JACCARD_KNOBS.json's
    best row (gather_block 16, chunk 512, filter_expand 8)."""
    import clann_tpu_torch

    return clann_tpu_torch.Config(
        num_tables=50, k=K, delta=JACCARD_DELTA, num_clusters_factor=0.4, seed=0,
        gather_block=16, candidate_chunk=512, filter_expand=8,
        dataset_name=f"jaccard-{JACCARD_N}",
    )


def jaccard_exact_sims(data, queries, ids):
    """Exact Jaccard of each returned id against its query (-1 for none)."""
    import numpy as np

    from clann_tpu_torch.data.setdata import jaccard_similarity_rowwise

    rows = data.tokens[np.maximum(ids, 0).reshape(-1)]
    s = jaccard_similarity_rowwise(rows, np.repeat(queries[: len(ids)], K, axis=0),
                                   device=DEVICE).cpu().numpy().reshape(ids.shape)
    return np.where(ids < 0, -1.0, s)


def jaccard_threshold_recall(data, queries, gt_s, ids):
    """scripts/jaccard_baseline.py's: J >= the true 10th - 1e-3"""
    import numpy as np

    return float(np.mean(jaccard_exact_sims(data, queries, ids)
                         >= gt_s[: len(ids), K - 1 : K] - 1e-3))


def phase_jaccard(card):
    """The Jaccard set index on scripts/jaccard_baseline.py's data: ground
    truth by the port's brute force on the card; builds flat and clustered;
    jaccard_search in batches of 128, gated threshold recall@10 >= 0.8 *
    delta, clustered ids equal to flat; jaccard_scan held to the ground
    truth; K7 at the engine's 256-byte record rows. Returns (K7 launches,
    K7's kernels-line numbers at this shape, (the corpus, the queries)) for
    [interop]'s Jaccard round trip."""
    import numpy as np
    import torch

    from clann_tpu_torch.core import jaccard as tj
    from clann_tpu_torch.data.setdata import JaccardData, brute_force_jaccard_topk
    from clann_tpu_torch.data.synthetic import clustered_sets
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.testing import assert_topk_match

    t0 = time.perf_counter()
    kw = dict(avg_size=64, n_modes=1024, core_share=0.8, pool_factor=1.25)
    data = JaccardData(clustered_sets(JACCARD_N, JACCARD_UNIVERSE, seed=0, **kw),
                       JACCARD_UNIVERSE)
    queries = JaccardData(clustered_sets(JACCARD_QUERIES, JACCARD_UNIVERSE, seed=1, **kw),
                          JACCARD_UNIVERSE, t_max=data.tokens.shape[1]).tokens
    log(f"[jaccard] clustered_sets: {JACCARD_N} sets and {JACCARD_QUERIES} queries over a "
        f"universe of {JACCARD_UNIVERSE}, t_max {data.tokens.shape[1]}, mean size "
        f"{float((data.tokens >= 0).sum(axis=1).mean()):.1f}, in "
        f"{time.perf_counter() - t0:.1f} s (host)")
    sync()
    t0 = time.perf_counter()
    gt_s, gt_i = brute_force_jaccard_topk(data, queries, K, device=DEVICE)
    sync()
    log(f"[jaccard] ground truth (brute_force_jaccard_topk on the card) in "
        f"{time.perf_counter() - t0:.3f} s; true 10th similarity min/median "
        f"{float(gt_s[:, K - 1].min()):.4f}/{float(np.median(gt_s[:, K - 1])):.4f}")

    cfg = jaccard_config()
    B, nq = JACCARD_BATCH, JACCARD_QUERIES
    out, launches = {}, 0
    for variant, clustered in (("flat", False), ("clustered", True)):
        sync()
        reset_peak()
        t0 = time.perf_counter()
        idx = tj.build_jaccard_index(data, cfg, clustered=clustered, device=DEVICE)
        sync()
        build_s = time.perf_counter() - t0
        build_peak = torch.cuda.max_memory_allocated()
        reset_peak()
        tg.reset_launches()
        res, t0 = [], time.perf_counter()
        while len(res) * B < nq:
            res.append(tj.jaccard_search(idx, queries[len(res) * B : (len(res) + 1) * B]))
            sync()
            if (variant == "flat" and len(res) == 1
                    and (time.perf_counter() - t0) * nq / B > JACCARD_CUT_S):
                log(f"[jaccard] the first batch projects {nq} queries past {JACCARD_CUT_S} s: "
                    f"both variants run {JACCARD_CUT_QUERIES} queries")
                nq = JACCARD_CUT_QUERIES
        first_s = time.perf_counter() - t0
        launches_v = tg.ROWS_LAUNCHES
        launches += launches_v
        search_peak = torch.cuda.max_memory_allocated()
        sims = np.concatenate([r[0] for r in res])
        ids = np.concatenate([r[1] for r in res])
        st = [np.concatenate([getattr(r[2], f) for r in res]) for f in
              ("distance_computations", "candidates", "clusters_visited")]
        rate, times = qps(lambda: [tj.jaccard_search(idx, queries[s : s + B])
                                   for s in range(0, nq, B)], reps=1, n_queries=nq)
        rec = jaccard_threshold_recall(data, queries, gt_s, ids)
        log(f"[jaccard] {variant}: build {build_s:.3f} s (peak device memory "
            f"{build_peak / 1e9:.3f} GB{f', {idx.center_ids.shape[0]} clusters' if clustered else ''}); "
            f"{nq} queries in batches of {B}: threshold recall@10 {rec:.4f} (gate "
            f"{0.8 * JACCARD_DELTA:.2f}); dc/query {float(st[0].mean()):.1f}, candidates/query "
            f"{float(st[1].mean()):.1f}, visited clusters/query {float(st[2].mean()):.2f}; "
            f"{rate:.2f} QPS (second pass, s {_qps_line(times)}; first pass {first_s:.3f} s); "
            f"peak device memory of the search {search_peak / 1e9:.3f} GB; K7 launches "
            f"{launches_v} on {card}")
        if launches_v < 1:
            fail(f"jaccard {variant} did not launch the K7 kernel")
        if rec < 0.8 * JACCARD_DELTA:
            fail(f"jaccard {variant}: threshold recall@10 {rec:.4f} below 0.8 * delta")
        if not np.allclose(sims, np.where(ids >= 0, jaccard_exact_sims(data, queries, ids), 0.0),
                           atol=0, rtol=0):
            fail(f"jaccard {variant}: returned similarities are not the exact Jaccard")
        out[variant] = (idx, ids)
    if not np.array_equal(out["clustered"][1], out["flat"][1]):
        fail("jaccard: the clustered index's ids differ from the flat index's")
    log(f"[jaccard] clustered ids equal to flat ids on all {nq} queries")

    flat = out["flat"][0]
    del out
    sync()
    t0 = time.perf_counter()
    ss, si, _ = tj.jaccard_scan(flat, queries)
    sync()
    first_s = time.perf_counter() - t0
    assert_topk_match(gt_i, gt_s, si, ss, atol=0.0)
    scan_rec = jaccard_threshold_recall(data, queries, gt_s, si)
    rate, times = qps(lambda: tj.jaccard_scan(flat, queries), reps=3,
                      n_queries=JACCARD_QUERIES)
    log(f"[jaccard] jaccard_scan of {JACCARD_QUERIES} queries: ids equal to the ground truth "
        f"up to ties ({float(np.mean(si == gt_i)):.5f} identical), threshold recall@10 "
        f"{scan_rec:.4f}; {rate:.1f} QPS (median of 3: {_qps_line(times)}; first call "
        f"{first_s:.3f} s) on {card}")
    if scan_rec < 1.0:
        fail("jaccard_scan is not exact")
    k7 = check_record_gather(flat.g_records, cfg, JACCARD_BATCH, "jaccard", "set records", 3,
                             card)
    return launches, k7, (data, queries, gt_s)


def pair_oracle(x, k):
    """The exact top-k pairs i < j of the unit rows x (a card tensor): every
    pair scored by the f32 product (TF32 off) in blocks of ORACLE_ROWS rows
    against the rows after them. The first block keeps its best k pairs
    (row-wise top-k, then the best k of those); a later block keeps only
    the pairs above the running k-th, merged into the running best k. These
    are the top k pairs over each point's k nearest other points (a top-k
    pair (i, j) has j among i's k nearest), for half the products. Returns
    numpy (pairs (k, 2), sims (k,) descending)."""
    import torch

    n = x.shape[0]
    best_s = torch.zeros((0,), device=x.device)
    best_p = torch.zeros((0, 2), dtype=torch.int64, device=x.device)
    for r0 in range(0, n - 1, ORACLE_ROWS):
        r1 = min(n, r0 + ORACLE_ROWS)
        b, m = r1 - r0, n - r0
        dots = x[r0:r1] @ x[r0:].T  # (b, m): column c is row r0 + c
        dots[:, :b].masked_fill_(torch.ones(b, b, dtype=torch.bool, device=x.device).tril(),
                                 -2.0)
        if best_s.numel() < k:
            v, j = torch.topk(dots, min(k, m), dim=1)
            flat = (j + torch.arange(b, device=x.device)[:, None] * m).reshape(-1)
        else:
            flat = torch.nonzero(dots.reshape(-1) > best_s[-1]).flatten()
        vals = dots.reshape(-1)[flat]
        del dots
        pairs = torch.stack([flat // m + r0, flat % m + r0], dim=1)
        best_s, sel = torch.topk(torch.cat([best_s, vals]), min(k, best_s.numel() + vals.numel()))
        best_p = torch.cat([best_p, pairs])[sel]
    return best_p.cpu().numpy(), ((best_s + 1.0) * 0.5).cpu().numpy()


def pair_sims(x, pairs):
    """Exact f32 (x_i . x_j + 1) / 2 of (m, 2) numpy pairs, on the card."""
    import torch

    p = torch.as_tensor(pairs, dtype=torch.int64, device=x.device)
    return ((torch.sum(x[p[:, 0]] * x[p[:, 1]], dim=1) + 1.0) * 0.5).cpu().numpy()


def timed_join(call):
    """call() with ops.join's per-window function timed (the module's own
    function, restored after). Returns (call's result, [(window, s)],
    seconds, peak device bytes)."""
    import torch

    from clann_tpu_torch.ops import join as tjoin

    windows = []
    inner = tjoin._windowed_pairs

    def timed(*args, window, **kw):
        sync()
        t = time.perf_counter()
        out = inner(*args, window=window, **kw)
        sync()
        windows.append((window, time.perf_counter() - t))
        return out

    tjoin._windowed_pairs = timed
    try:
        sync()
        reset_peak()
        t0 = time.perf_counter()
        out = call()
        sync()
        return out, windows, time.perf_counter() - t0, torch.cuda.max_memory_allocated()
    finally:
        tjoin._windowed_pairs = inner


def window_pairs_above(index, window, floor):
    """Every distinct pair (i < j) that sits within `window` positions of
    one table (index.sorted_idx) with f32 similarity (x_i . x_j + 1) / 2 >=
    floor: a plain pass over the tables, apart from ops.join. Returns
    {(i, j): sim}."""
    import torch

    x, out = index.vectors, {}
    for t in range(index.sorted_idx.shape[0]):
        order = index.sorted_idx[t].to(torch.int64)
        rows = x[order]
        for w in range(1, window + 1):
            s = (torch.sum(rows[:-w] * rows[w:], dim=1) + 1.0) * 0.5
            hit = torch.nonzero(s >= floor).flatten()
            a, b = order[hit], order[hit + w]
            for i, j, v in zip(torch.minimum(a, b).tolist(), torch.maximum(a, b).tolist(),
                               s[hit].tolist()):
                out[(i, j)] = v
    return out


def check_join(index, pairs, sims, window, k, label):
    """The pairs must be canonical (i < j), unique, sims non-increasing and
    within 1e-4 of the exact f32 ones, and they must be the top k of the
    pairs within the final window of some table (JAX's windowed join,
    independent of ops.join; a differing pair only where it ties the k-th
    within 1e-6). Returns (max |sim - exact f32|, pairs of the window set
    above the k-th)."""
    import numpy as np

    if pairs.shape != (k, 2) or sims.shape != (k,) or (pairs < 0).any():
        fail(f"{label} result shapes {pairs.shape} {sims.shape} or missing pairs")
    if not (pairs[:, 0] < pairs[:, 1]).all() or len({tuple(p) for p in pairs.tolist()}) != k:
        fail(f"{label} pairs not canonical (i < j) or not unique")
    if not (np.diff(sims) <= 0).all():
        fail(f"{label} sims not non-increasing")
    err = float(np.max(np.abs(pair_sims(index.vectors, pairs) - sims)))
    if err > 1e-4:
        fail(f"{label} sims differ from the exact f32 ones by {err:.2e}")
    want = window_pairs_above(index, window, float(sims[-1]) - 1e-6)
    got = {tuple(p) for p in pairs.tolist()}
    stray = [p for p in got if p not in want]
    missed = [v for p, v in want.items() if p not in got and v > sims[-1] + 1e-6]
    if stray or missed:
        fail(f"{label} is not the top {k} of the window-{window} pairs: {len(stray)} returned "
             f"pairs outside the windows, {len(missed)} window pairs above the k-th missing")
    return err, len(want)


def phase_join(handle, card):
    """Clann.closest_pairs(k=100, delta=0.9) on the lsh phase's index (L =
    128, 435 clusters), held by check_join to JAX's windowed join at the
    final window. The exact top 100 pairs (pair_oracle) give two readings,
    not gated: the share of the returned pairs that reach the true 100th
    similarity - 1e-6 (the JAX compat test's bar is half, at 600 points)
    and the recall of the true top 100; beside them, how often a true pair
    sits within the final window of a table against the probability the
    window rule assumed (tests/test_torch_join.py pins the same trap in
    JAX's join and the port's on one dense mode). Returns the oracle's
    pairs and sims."""
    import numpy as np
    import torch

    x = handle.index.vectors
    sync()
    reset_peak()
    t0 = time.perf_counter()
    o_pairs, o_sims = pair_oracle(x, JOIN_K)
    sync()
    oracle_s = time.perf_counter() - t0
    log(f"[join] oracle: exact top {JOIN_K} pairs of {N_TRAIN} points ({N_TRAIN * (N_TRAIN - 1) // 2:,} "
        f"pairs by f32 products in blocks of {ORACLE_ROWS} rows) in {oracle_s:.2f} s; true pair "
        f"sims: 1st {o_sims[0]:.6f}, 10th {o_sims[9]:.6f}, 100th {o_sims[-1]:.6f} on {card}")

    (pairs, sims), windows, join_s, peak = timed_join(
        lambda: handle.closest_pairs(k=JOIN_K, delta=JOIN_DELTA))
    t0 = time.perf_counter()
    err, n_window = check_join(handle.index, pairs, sims, windows[-1][0], JOIN_K, "[join]")
    check_s = time.perf_counter() - t0
    in_range = float(np.mean(sims >= o_sims[-1] - 1e-6))
    found = {tuple(p) for p in pairs.tolist()}
    recall = len(found & {tuple(p) for p in o_pairs.tolist()}) / JOIN_K
    # the windows pair points of one cluster segment: the true pairs whose
    # points share a cluster, and how many of those the join found
    assign = handle.index.assignment.cpu().numpy()
    same = assign[o_pairs[:, 0]] == assign[o_pairs[:, 1]]
    same_found = sum(tuple(p) in found for p in o_pairs[same].tolist())
    # how often a true pair sits within the final window of a table, beside
    # the rule's modelled probability of a shared prefix at the depth it took
    idx, w_final = handle.index, windows[-1][0]
    ids = idx.sorted_idx.to(torch.int64)
    pos = torch.empty_like(ids).scatter_(
        1, ids, torch.arange(ids.shape[1], device=ids.device).expand_as(ids))
    op = torch.as_tensor(o_pairs, dtype=torch.int64, device=ids.device)
    near = float(((pos[:, op[:, 0]] - pos[:, op[:, 1]]).abs() <= w_final).float().mean())
    del ids, pos
    depth = int(np.clip(np.log2(N_TRAIN / w_final), 1, idx.config.max_hashbits))
    probs = idx.probs_table.cpu().numpy()
    p_model = float(probs[depth, int(np.clip(o_sims[-1] / idx.sim_eps, 0, probs.shape[1] - 1))])
    log(f"[join] closest_pairs(k={JOIN_K}, delta={JOIN_DELTA}) on L={handle.index.num_tables}, "
        f"{handle.index.n_clusters} clusters: {join_s:.3f} s, windows "
        f"{', '.join(f'{w} ({s:.3f} s)' for w, s in windows)}, final window {windows[-1][0]}; "
        f"peak device memory {peak / 1e9:.3f} GB (index resident); max |sim - exact f32| "
        f"{err:.2e} (gate 1e-4); the top {JOIN_K} of the {n_window} window pairs at or above "
        f"the k-th (checked in {check_s:.2f} s) on {card}")
    log(f"[join] readings: pairs >= true 100th - 1e-6: {in_range:.2f} (the JAX compat test's "
        f"0.5 at 600 points; not gated here); recall of the true top {JOIN_K}: {recall:.2f}; "
        f"true pairs inside one cluster {int(same.sum())}, of those found {same_found}; a true "
        f"pair within window {w_final} in {near:.4f} of the tables, the rule's model "
        f"{p_model:.4f} (a shared {depth}-bit prefix at the true 100th similarity)")
    return o_pairs, o_sims


def phase_update(train, test, gt_d, gt_i, card):
    """insert / rebuild through the facade on the lsh configuration (with
    the SQLite sink on): build on the first N_UPDATE_OLD points, insert the
    rest in UPDATE_CALLS calls; the balls cover the new points; mode="lsh"
    sees none of them, scan-pallas (K1) sees all; after rebuild the old
    points' hashes and sketches are unchanged, mode="lsh" (K7) meets the
    recall gate over all points and inserted points find themselves.
    Returns (handle, K1 launches, K7 launches, queries searched since
    reset_metrics, the build's memory_usage)."""
    import numpy as np
    import torch

    import clann_tpu_torch
    from clann_tpu_torch.config import MetricsOutput
    from clann_tpu_torch.core.index import unsort_hashes
    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops import scan_topk as st

    cfg = lsh_config().replace(metrics_output=MetricsOutput.DB)
    delta = cfg.delta
    n_old = N_UPDATE_OLD
    sync()
    reset_peak()
    h = clann_tpu_torch.init_with_config(train[:n_old], cfg, device=DEVICE)
    t0 = time.perf_counter()
    h.build()
    sync()
    build_s = time.perf_counter() - t0
    idx0 = h.index
    build_bytes = idx0.memory_usage()
    insert_s = []
    for s in range(n_old, N_TRAIN, (N_TRAIN - n_old) // UPDATE_CALLS):
        t0 = time.perf_counter()
        h.insert(train[s:s + (N_TRAIN - n_old) // UPDATE_CALLS])
        sync()
        insert_s.append(time.perf_counter() - t0)
    idx = h.index
    if idx.num_pending != N_TRAIN - n_old or idx.n != N_TRAIN or h.data.num_points() != N_TRAIN:
        fail(f"[update] {idx.num_pending} pending of {idx.n} after {len(insert_s)} inserts")
    a = idx.assignment[n_old:].to(torch.int64)
    cd = 1.0 - torch.sum(idx.vectors[n_old:] * idx.centers[a], dim=1)
    over = float(torch.max(cd - idx.radii[a]))
    grown = int((idx.radii > idx0.radii).sum())
    shrank = bool((idx.radii < idx0.radii).any())
    log(f"[update] L={cfg.num_tables}, {idx0.n_clusters} clusters: build on {n_old} points "
        f"{build_s:.3f} s; {len(insert_s)} inserts of {(N_TRAIN - n_old) // UPDATE_CALLS} "
        f"points: {', '.join(f'{s:.3f}' for s in insert_s)} s; {idx.num_pending} pending; "
        f"largest distance beyond a ball {over:.2e} (gate 1e-5); {grown} radii grew, none "
        f"shrank: {not shrank} on {card}")
    if over > 1e-5 or shrank:
        fail("[update] an inserted point lies outside its ball, or a radius shrank")

    q, gd, gi = test[:LSH_QUERIES], gt_d[:LSH_QUERIES], gt_i[:LSH_QUERIES]
    tg.reset_launches()
    d, i, _ = h.search_batch(q, mode="lsh")
    sync()
    k7 = tg.ROWS_LAUNCHES
    check_result(d, i, "update lsh before rebuild", LSH_QUERIES)
    if i.max() >= n_old:
        fail("[update] mode=lsh returned a pending point before rebuild")
    st.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    d, i, _ = h.search_batch(test, mode="scan-pallas")
    sync()
    scan_s = time.perf_counter() - t0
    k1 = st.KERNEL_LAUNCHES
    check_result(d, i, "update scan-pallas", len(test))
    rec, idr = recall_values(gt_d, d, K)[0], recall_by_ids(gt_i, i, K)
    log(f"[update] before rebuild: lsh on {LSH_QUERIES} queries returns no pending id (largest "
        f"{int(i.max())}); scan-pallas on {N_QUERIES} queries over all {N_TRAIN} points: "
        f"recall@10 {rec:.4f} (gate {RECALL_GATE}), id-recall {idr:.4f} (gate "
        f"{ID_RECALL_GATE}), {scan_s:.3f} s with the base re-staged, K1 launches {k1}, "
        f"pending ids returned {int((i >= n_old).sum())}")
    if k1 < 1:
        fail("[update] scan-pallas did not launch the K1 kernel")
    if rec < RECALL_GATE or idr < ID_RECALL_GATE:
        fail("[update] scan-pallas recall below the gate")

    sync()
    t0 = time.perf_counter()
    h.rebuild()
    sync()
    rebuild_s = time.perf_counter() - t0
    idx = h.index
    same_h = torch.equal(unsort_hashes(idx.sorted_hash, idx.sorted_idx)[:, :n_old],
                         unsort_hashes(idx0.sorted_hash, idx0.sorted_idx))
    same_sk = torch.equal(idx.sketches[:n_old], idx0.sketches)
    del idx0
    h.reset_metrics()
    tg.reset_launches()
    d, i, stats = h.search_batch(q, mode="lsh")
    sync()
    k7_after = tg.ROWS_LAUNCHES
    check_result(d, i, "update lsh after rebuild", LSH_QUERIES)
    rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
    ids = n_old + np.arange(UPDATE_SELF) * ((N_TRAIN - n_old) // UPDATE_SELF)
    tg.reset_launches()
    sd, si, _ = h.search_batch(train[ids], mode="lsh")
    sync()
    k7_after += tg.ROWS_LAUNCHES
    self_rate = float(np.mean((si[:, 0] >= n_old) & (sd[:, 0] < 1e-5)))
    peak = torch.cuda.max_memory_allocated()
    log(f"[update] rebuild {rebuild_s:.3f} s (build of {n_old} points {build_s:.3f} s); "
        f"{idx.num_pending} pending; old hashes identical {same_h}, old sketches identical "
        f"{same_sk}; lsh delta={delta} over all points: recall@10 {rec:.4f} (gate "
        f"{0.8 * delta:.2f}), id-recall {idr:.4f}, dc/query "
        f"{float(np.mean(stats.distance_computations)):.1f}, returned inserted ids "
        f"{int((i >= n_old).sum())}, K7 launches {k7_after}; {UPDATE_SELF} inserted points "
        f"as queries find themselves at < 1e-5: {self_rate:.4f} (gate 0.9); peak device memory "
        f"{peak / 1e9:.3f} GB on {card}")
    if idx.num_pending or not (same_h and same_sk):
        fail("[update] rebuild left points pending or changed the old points' tables")
    if k7_after < 1:
        fail("[update] lsh after rebuild did not launch the K7 kernel")
    if rec < 0.8 * delta:
        fail(f"[update] lsh recall@10 {rec:.4f} below 0.8 * delta")
    if self_rate < 0.9:
        fail(f"[update] inserted points found themselves at a rate of {self_rate:.4f}")
    return h, k1, k7 + k7_after, LSH_QUERIES + UPDATE_SELF, build_bytes, (gd, d)


def phase_metrics_db(h, n_searched, build_bytes, gd, d, card):
    """save_metrics of the update phase's run (metrics_output=DB) to a
    SQLite file under build/, read back: one build row whose
    memory_used_bytes is the build's memory_usage(), one cluster row per
    cluster, one query row per query searched since reset_metrics."""
    import sqlite3

    from clann_tpu_torch.config import MetricsGranularity

    db = os.path.join(HERE, "build", "chip_smoke_metrics.db")
    os.makedirs(os.path.dirname(db), exist_ok=True)
    if os.path.exists(db):
        os.remove(db)
    t0 = time.perf_counter()
    h.save_metrics(db, MetricsGranularity.QUERY, ground_truth_distances=gd, run_distances=d)
    save_s = time.perf_counter() - t0
    conn = sqlite3.connect(db)
    builds = conn.execute("SELECT memory_used_bytes, num_clusters, num_tables, dataset_len "
                          "FROM build_metrics").fetchall()
    n_cl = conn.execute("SELECT COUNT(*) FROM build_metrics_cluster").fetchone()[0]
    n_q = conn.execute("SELECT COUNT(*) FROM search_metrics_query").fetchone()[0]
    recall, qps_ = conn.execute(
        "SELECT recall_mean, queries_per_second FROM search_metrics").fetchone()
    mode = conn.execute("SELECT timing_mode FROM clann_timing_mode").fetchone()[0]
    conn.close()
    log(f"[metrics-db] {os.path.relpath(db, HERE)} ({os.path.getsize(db)} bytes) in "
        f"{save_s:.3f} s: build rows {builds}, build memory_usage {build_bytes}; cluster rows "
        f"{n_cl} of {h.index.n_clusters} clusters; query rows {n_q} of {n_searched} queries "
        f"searched since reset_metrics; recall_mean {recall:.4f}, {qps_:.1f} QPS ({mode}) on "
        f"{card}")
    if len(builds) != 1 or builds[0][0] != build_bytes:
        fail("[metrics-db] build row missing or memory_used_bytes != the build's memory_usage()")
    if n_cl != h.index.n_clusters or n_q != n_searched:
        fail("[metrics-db] cluster or query rows do not match the run")


def phase_puffinn(train, test, gt_d, o_pairs, o_sims, card):
    """The upstream PUFFINN surface at the glove shape: the budget derives L
    = 128 from the byte model; every point inserted one call each, then
    rebuild; single-query searches gated by the compat contract (correct ids
    >= 0.8 * recall * k * queries), search_from_index, closest_pairs equal
    to ops.join.closest_pairs on the same index, whose pairs and sims are
    held to the windowed join (check_join) and read against the join
    oracle, and a pickle round trip (a second, lazy build) giving identical
    results. Returns its K7 launches."""
    import pickle

    import numpy as np
    import torch

    from clann_tpu_torch import puffinn
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops import join as tjoin

    sync()
    reset_peak()
    pf = puffinn.Index("angular", DIMS, PUFFINN_BUDGET, device=DEVICE)
    t0 = time.perf_counter()
    for v in train:
        pf.insert(v)
    insert_s = time.perf_counter() - t0
    L = pf._derive_num_tables(len(pf))
    if L != 128:
        fail(f"[puffinn] a budget of {PUFFINN_BUDGET} B derives L = {L}, not 128")
    sync()
    t0 = time.perf_counter()
    pf.rebuild()
    sync()
    rebuild_s = time.perf_counter() - t0
    idx = pf._index
    log(f"[puffinn] Index('angular', {DIMS}, {PUFFINN_BUDGET}): L = {L} (memory_usage "
        f"{idx.memory_usage() / 1e9:.3f} GB, {idx.n_clusters} cluster); {len(pf)} inserts "
        f"{insert_s:.3f} s, rebuild {rebuild_s:.3f} s on {card}")

    q = test[:PUFFINN_QUERIES]
    kth_dot = 1.0 - gt_d[:PUFFINN_QUERIES, K - 1]
    tg.reset_launches()
    correct, times = 0, []
    for qi in range(PUFFINN_QUERIES):
        t0 = time.perf_counter()
        res = pf.search(q[qi], K, PUFFINN_RECALL)
        times.append(time.perf_counter() - t0)
        if len(res) != K:
            fail(f"[puffinn] search returned {len(res)} ids")
        correct += int(np.sum(train[res] @ q[qi] >= kth_dot[qi] - 1e-6))
    k7 = tg.ROWS_LAUNCHES
    gate = 0.8 * PUFFINN_RECALL * K * PUFFINN_QUERIES
    log(f"[puffinn] {PUFFINN_QUERIES} single-query search(q, {K}, {PUFFINN_RECALL}): correct "
        f"ids {correct} (gate {gate:.0f}); ms per call median {np.median(times) * 1e3:.2f}, "
        f"max {np.max(times) * 1e3:.2f}; K7 launches {k7}")
    if k7 < 1:
        fail("[puffinn] search did not launch the K7 kernel")
    if correct < gate:
        fail("[puffinn] the compat recall contract failed")

    for i in (0, N_TRAIN // 2, N_TRAIN - 1):
        res = pf.search_from_index(i, K, PUFFINN_RECALL)
        if i in res or len(res) != K:
            fail(f"[puffinn] search_from_index({i}) returned the point itself or {len(res)} ids")
    tg.reset_launches()
    pairs, windows, cp_s, _ = timed_join(lambda: np.asarray(pf.closest_pairs(10, PUFFINN_RECALL)))
    # the surface returns ids only: they must be ops.join's pairs on the same
    # index, in its order, and those pairs with its sims go to check_join
    j_pairs, j_sims = tjoin.closest_pairs(idx, k=10, delta=PUFFINN_RECALL)
    if not np.array_equal(pairs, j_pairs):
        fail("[puffinn] closest_pairs differs from ops.join.closest_pairs on its index")
    err, _ = check_join(idx, j_pairs, j_sims, windows[-1][0], 10, "[puffinn] closest_pairs")
    in_range = float(np.mean(j_sims >= o_sims[9] - 1e-6))
    log(f"[puffinn] search_from_index on 3 ids excludes each; closest_pairs(10, "
        f"{PUFFINN_RECALL}) {cp_s:.3f} s, final window {windows[-1][0]}: ops.join's pairs, "
        f"max |sim - exact f32| {err:.2e}, the top 10 of the window pairs; readings: >= the "
        f"true 10th pair sim {o_sims[9]:.6f} - 1e-6: "
        f"{in_range:.2f} (the JAX compat test's 0.5 at 600 points; not gated here), of the "
        f"true top 10: "
        f"{len({tuple(p) for p in pairs.tolist()} & {tuple(p) for p in o_pairs[:10].tolist()})}")
    k7 += tg.ROWS_LAUNCHES

    t0 = time.perf_counter()
    blob = pickle.dumps(pf)
    pf2 = pickle.loads(blob)
    pickle_s = time.perf_counter() - t0
    tg.reset_launches()
    t0 = time.perf_counter()
    same = all(pf2.search(q[qi], K, PUFFINN_RECALL) == pf.search(q[qi], K, PUFFINN_RECALL)
               for qi in range(2))
    sync()
    lazy_s = time.perf_counter() - t0
    k7 += tg.ROWS_LAUNCHES
    peak = torch.cuda.max_memory_allocated()
    log(f"[puffinn] pickle round trip {len(blob) / 1e6:.1f} MB in {pickle_s:.3f} s; the lazy "
        f"second build and 2 queries on each {lazy_s:.3f} s; identical results: {same}; peak "
        f"device memory {peak / 1e9:.3f} GB (two indexes) on {card}")
    if not same:
        fail("[puffinn] the pickled index answers differently")
    return k7


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


def shard_mesh(n):
    """A mesh of n shards on the one card."""
    from clann_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, devices=[f"{DEVICE}:0"] * n)


def phase_sharded_scan(handle, train, test, gt_d, gt_i, card):
    """[sharded] on the main-path index: shard_index over SHARDS shards on
    the card, the fused scan per shard (K1), the exact scan, build_sharded.
    Returns the K1 launches of the sharded scan-pallas path."""
    import numpy as np
    import torch

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import scan_topk as st
    from clann_tpu_torch.ops.ivf import scan_search
    from clann_tpu_torch.parallel import sharded as sh
    from clann_tpu_torch.testing import assert_topk_match, sharded_real_slot_mismatches

    mesh = shard_mesh(SHARDS)
    idx = handle.index
    sync()
    reset_peak()
    t0 = time.perf_counter()
    shards = sh.shard_index(idx, SHARDS, mesh=mesh)
    sync()
    shard_s = time.perf_counter() - t0
    bound_ = sh.assert_balanced(shards, np.diff(idx.cluster_starts.cpu().numpy()))
    log(f"[sharded] shard_index of the main-path index over {SHARDS} shards on "
        f"{mesh.cluster_devices()[0]}: {shard_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; balanced (spread bound {bound_}); "
        f"shard_report {json.dumps(sh.shard_report(shards, Q=N_QUERIES, k=K))}")

    def fused():
        return sh.sharded_scan_search(shards, test, k=K, use_pallas=True, mesh=mesh)

    reset_peak()
    st.KERNEL_LAUNCHES = 0
    t0 = time.perf_counter()
    d, i, stats = fused()
    sync()
    first_s = time.perf_counter() - t0
    launches = st.KERNEL_LAUNCHES
    check_result(d, i, "sharded scan-pallas")
    rec, idr = recall_values(gt_d, d, K)[0], recall_by_ids(gt_i, i, K)
    rate, times = qps(fused, reps=3)
    rate_1, times_1 = qps(lambda: handle.search_batch(test, mode="scan-pallas"), reps=3)
    log(f"[sharded] sharded_scan_search(use_pallas=True), {N_QUERIES} queries: recall@10 "
        f"{rec:.4f} (gate {RECALL_GATE}), id-recall {idr:.4f} (gate {ID_RECALL_GATE}); dc/query "
        f"{float(np.mean(stats.distance_computations)):.0f}; K1 launches {launches} "
        f"({SHARDS} shards); first call {first_s:.3f} s (the shards' bf16 bases built); "
        f"{rate:.0f} QPS (median of 3: {_qps_line(times)}) beside the single-device "
        f"scan-pallas {rate_1:.0f} QPS ({_qps_line(times_1)}); peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    if launches != SHARDS:
        fail(f"the sharded scan launched K1 {launches} times, not once per shard ({SHARDS})")
    if rec < RECALL_GATE or idr < ID_RECALL_GATE:
        fail("sharded scan-pallas recall below the gate")

    t0 = time.perf_counter()
    de, ie, _ = sh.sharded_scan_search(shards, test, k=K, exact=True, mesh=mesh)
    sync()
    exact_s = time.perf_counter() - t0
    d1, i1, _ = scan_search(idx, test, exact=True)
    assert_topk_match(ie, de, i1, d1, atol=1e-5)
    log(f"[sharded] exact=True: {exact_s:.3f} s; ids equal to the single-device exact scan "
        f"up to ties ({float(np.mean(ie == i1)):.5f} identical), recall@10 "
        f"{recall_values(gt_d, de, K)[0]:.4f}")
    del d1, i1

    sync()
    reset_peak()
    t0 = time.perf_counter()
    direct = sh.build_sharded(train, idx.config, mesh=mesh)
    sync()
    build_s = time.perf_counter() - t0
    bad = sharded_real_slot_mismatches(shards, direct)
    log(f"[sharded] build_sharded (sharded GMM, per-shard hashing, sorts, global tables) "
        f"with the main path's config: {build_s:.3f} s, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB; n_max {direct.n_max} "
        f"(shard_index's {shards.n_max}); real slots equal to shard_index(build_index): "
        f"{not bad}{'' if not bad else ' ' + str(bad[:8])}")
    if bad:
        fail(f"build_sharded differs from shard_index(build_index) in {bad[:8]}")
    del shards, direct
    sh._SHARD_BASE_CACHE.clear()
    return launches


def phase_sharded_lsh(lsh, test, gt_d, gt_i, card):
    """[sharded] on the lsh index: the global engine per shard (K7), the
    2 x 2 mesh against its 1-D mesh, the table-sharded join. Returns the
    K7 launches of the sharded paths."""
    import numpy as np
    import torch

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.ops.join import closest_pairs
    from clann_tpu_torch.parallel import sharded as sh
    from clann_tpu_torch.parallel.join import sharded_closest_pairs
    from clann_tpu_torch.parallel.mesh import make_mesh_2d

    mesh = shard_mesh(SHARDS)
    delta = LSH_DELTAS[0]
    q, gd, gi = test[:LSH_QUERIES], gt_d[:LSH_QUERIES], gt_i[:LSH_QUERIES]
    sync()
    reset_peak()
    t0 = time.perf_counter()
    shards = sh.shard_index(lsh.index, SHARDS, mesh=mesh)
    sync()
    shard_s = time.perf_counter() - t0
    tg.reset_launches()
    t0 = time.perf_counter()
    d, i, st = sh.sharded_global_search(shards, q, delta=delta, mesh=mesh)
    sync()
    search_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    check_result(d, i, "sharded global", LSH_QUERIES)
    rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
    log(f"[sharded] lsh index over {SHARDS} shards: shard_index {shard_s:.3f} s; "
        f"sharded_global_search delta={delta}, {LSH_QUERIES} queries in one batch: recall@10 "
        f"{rec:.4f} (gate {0.8 * delta:.2f}), id-recall {idr:.4f}; dc/query "
        f"{float(np.mean(st.distance_computations)):.1f} (summed over shards); K7 launches "
        f"{launches}; {search_s:.3f} s, {LSH_QUERIES / search_s:.1f} QPS; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    if launches < 1:
        fail("the sharded global engine did not launch the K7 kernel")
    if rec < 0.8 * delta:
        fail(f"sharded global: recall@10 {rec:.4f} below 0.8 * delta")
    del shards

    # a 2 x 2 (query, cluster) mesh against its 1-D cluster mesh
    mesh1 = shard_mesh(2)
    half = sh.shard_index(lsh.index, 2, mesh=mesh1)
    q2 = q[:MESH_2D_QUERIES]
    tg.reset_launches()
    a = sh.sharded_global_search(half, q2, delta=delta, mesh=mesh1)
    b = sh.sharded_global_search(half, q2, delta=delta,
                                 mesh=make_mesh_2d(2, 2, devices=[f"{DEVICE}:0"] * 4))
    sync()
    launches_2d = tg.ROWS_LAUNCHES
    same = (np.array_equal(a[1], b[1]) and np.array_equal(a[0], b[0])
            and all(np.array_equal(x, y) for x, y in zip(a[2], b[2])))
    log(f"[sharded] 2 x 2 make_mesh_2d against its 1-D 2-shard mesh, {MESH_2D_QUERIES} "
        f"queries: ids, distances and stats equal: {same}; K7 launches {launches_2d}")
    if not same:
        fail("the 2-D mesh's results differ from the 1-D mesh's")
    del half

    t0 = time.perf_counter()
    p1, s1 = closest_pairs(lsh.index, JOIN_K, delta=JOIN_DELTA)
    one_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    p2, s2 = sharded_closest_pairs(lsh.index, JOIN_K, delta=JOIN_DELTA, mesh=mesh)
    join_s = time.perf_counter() - t0
    same = np.array_equal(p1, p2) and np.array_equal(s1, s2)
    log(f"[sharded] sharded_closest_pairs(k={JOIN_K}, delta={JOIN_DELTA}) over {SHARDS} "
        f"shards: {join_s:.3f} s (unsharded {one_s:.3f} s); pairs and sims equal to "
        f"ops.join.closest_pairs: {same}")
    if not same:
        fail("the sharded join differs from ops.join.closest_pairs")
    return launches + launches_2d


def phase_sharded_walk(walk, test, gt_d, gt_i, source, card):
    """[sharded] on the walk index: one SHARD_WALK_QUERIES batch of the walk
    per shard over slot records (K7). Returns its K7 launches."""
    import numpy as np
    import torch

    from clann_tpu_torch.metrics.recall import recall_by_ids, recall_values
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.parallel import sharded as sh

    mesh = shard_mesh(SHARDS)
    q, gd, gi = test[:SHARD_WALK_QUERIES], gt_d[:SHARD_WALK_QUERIES], gt_i[:SHARD_WALK_QUERIES]
    sync()
    reset_peak()
    t0 = time.perf_counter()
    shards = sh.shard_index(walk.index, SHARDS, mesh=mesh)
    sync()
    shard_s = time.perf_counter() - t0
    if shards.slot_records is None:
        fail("the walk index's shards have no slot records")
    tg.reset_launches()
    t0 = time.perf_counter()
    d, i, st = sh.sharded_search(shards, q, delta=WALK_DELTA, mesh=mesh)
    sync()
    walk_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    check_result(d, i, "sharded walk", SHARD_WALK_QUERIES)
    rec, idr = recall_values(gd, d, K)[0], recall_by_ids(gi, i, K)
    log(f"[sharded] walk index over {SHARDS} shards ({shards.c_max} cluster slots each): "
        f"shard_index {shard_s:.3f} s; sharded_search delta={WALK_DELTA}, one batch of "
        f"{SHARD_WALK_QUERIES}: recall@10 {rec:.4f} (gate {0.8 * WALK_DELTA:.2f}), id-recall "
        f"{idr:.4f}; dc/query {float(np.mean(st.distance_computations)):.1f}, clusters "
        f"visited/query {float(np.mean(st.clusters_visited)):.2f}; K7 launches {launches}; "
        f"{walk_s:.3f} s (single-device walk {source['batch_s']:.3f} s per batch of 256); "
        f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    if launches < 1:
        fail("the sharded walk did not launch the K7 kernel")
    if rec < 0.8 * WALK_DELTA:
        fail(f"sharded walk: recall@10 {rec:.4f} below 0.8 * delta")
    return launches


def phase_sharded_jaccard(data, queries, gt_s, card):
    """[sharded] on the Jaccard corpus: shard_jaccard_index of the flat
    build against build_jaccard_sharded, then the sharded search (K7) in
    batches of JACCARD_BATCH. Returns its K7 launches."""
    import numpy as np
    import torch

    from clann_tpu_torch.core import jaccard as tj
    from clann_tpu_torch.ops import gather as tg
    from clann_tpu_torch.parallel import jaccard as pj

    mesh = shard_mesh(SHARDS)
    cfg = jaccard_config()
    sync()
    reset_peak()
    flat = tj.build_jaccard_index(data, cfg, device=DEVICE)
    t0 = time.perf_counter()
    shj = pj.shard_jaccard_index(flat, SHARDS, mesh=mesh)
    sync()
    shard_s = time.perf_counter() - t0
    del flat
    t0 = time.perf_counter()
    direct = pj.build_jaccard_sharded(data, data.universe, cfg, mesh=mesh)
    sync()
    build_s = time.perf_counter() - t0
    bad = [f"{f}[{s}]" for f in pj.SHARD_FIELDS for s in range(SHARDS)
           if not torch.equal(getattr(shj, f)[s], getattr(direct, f)[s])]
    log(f"[sharded] jaccard corpus over {SHARDS} shards: shard_jaccard_index {shard_s:.3f} s, "
        f"build_jaccard_sharded {build_s:.3f} s, equal shard for shard: {not bad}; peak "
        f"device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if bad:
        fail(f"build_jaccard_sharded differs from shard_jaccard_index in {bad[:8]}")
    del direct
    B, nq = JACCARD_BATCH, JACCARD_QUERIES
    reset_peak()
    tg.reset_launches()
    t0 = time.perf_counter()
    res = [pj.sharded_jaccard_search(shj, queries[s : s + B], mesh=mesh)
           for s in range(0, nq, B)]
    sync()
    search_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    ids = np.concatenate([r[1] for r in res])
    dc = np.concatenate([r[2].distance_computations for r in res])
    rec = jaccard_threshold_recall(data, queries, gt_s, ids)
    log(f"[sharded] sharded_jaccard_search, {nq} queries in batches of {B}: threshold "
        f"recall@10 {rec:.4f} (gate {0.8 * JACCARD_DELTA:.2f}); dc/query {float(dc.mean()):.1f}; "
        f"K7 launches {launches}; {search_s:.3f} s, {nq / search_s:.2f} QPS; peak device "
        f"memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    if launches < 1:
        fail("the sharded Jaccard search did not launch the K7 kernel")
    if rec < 0.8 * JACCARD_DELTA:
        fail(f"sharded jaccard: threshold recall@10 {rec:.4f} below 0.8 * delta")
    return launches


def phase_cli(card):
    """[cli] python -m clann_tpu_torch's main() in-process (so that K1's
    launches can be read) at the main path's shape, gated on its printed
    recall; then --plan as a subprocess. Returns the K1 launches."""
    import io
    import re
    import sqlite3

    import torch

    from clann_tpu_torch import __main__ as cli
    from clann_tpu_torch.ops import scan_topk as st

    db = os.path.join(HERE, "build", "cli_metrics.db")
    os.makedirs(os.path.dirname(db), exist_ok=True)
    if os.path.exists(db):
        os.remove(db)
    argv = ["--synthetic-n", str(N_TRAIN), "--synthetic-d", str(DIMS), "--queries",
            str(N_QUERIES), "-L", "50", "--mode", "scan-pallas", "--no-cache", "--save", db,
            "--device", DEVICE]
    sync()
    reset_peak()
    st.KERNEL_LAUNCHES = 0
    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = cli.main(argv)
    sync()
    cli_s = time.perf_counter() - t0
    launches = st.KERNEL_LAUNCHES
    text = out.getvalue()
    for line in text.splitlines():
        log(f"[cli] | {line}")
    m = re.search(r"^recall@10: ([0-9.]+)", text, re.M)
    conn = sqlite3.connect(db)
    try:
        n_q = conn.execute("SELECT COUNT(*) FROM search_metrics_query").fetchone()[0]
    finally:
        conn.close()
    log(f"[cli] main({' '.join(os.path.relpath(a, HERE) if a == db else a for a in argv)}): "
        f"rc {rc} in {cli_s:.3f} s (data, ground truth, build, search, save); K1 launches "
        f"{launches}; {n_q} query rows saved; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")
    if rc != 0 or m is None:
        fail("[cli] main failed or printed no recall")
    if float(m.group(1)) < RECALL_GATE:
        fail(f"[cli] recall@10 {m.group(1)} below {RECALL_GATE}")
    if launches < 1:
        fail("[cli] scan-pallas did not launch the K1 kernel")
    if n_q != N_QUERIES:
        fail(f"[cli] --save wrote {n_q} query rows, not {N_QUERIES}")
    env = dict(os.environ, PYTHONPATH=HERE)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "clann_tpu_torch", "--plan", "--synthetic-n",
                           str(N_TRAIN), "--synthetic-d", str(DIMS), "-L", "50"],
                          cwd=HERE, env=env, capture_output=True, text=True, timeout=300)
    for line in proc.stdout.splitlines():
        log(f"[cli] --plan | {line}")
    log(f"[cli] python -m clann_tpu_torch --plan: rc {proc.returncode} in "
        f"{time.perf_counter() - t0:.3f} s")
    if proc.returncode != 0 or "fits one chip" not in proc.stdout:
        fail(f"[cli] --plan failed: {proc.stderr[-2000:]}")
    return launches


def phase_bench(train, test, gt_d, gt_i, card):
    """[bench] the harness and the ann-benchmarks adapter on the main-path
    data (run_benchmark_config_clann caches its index in HDF5 files and is
    tested on the host). Returns the K7 launches of its LSH paths."""
    import sqlite3

    import numpy as np
    import torch

    import clann_tpu_torch
    from clann_tpu_torch.bench import harness as hb
    from clann_tpu_torch.bench.ann_adapter import ClannTPU
    from clann_tpu_torch.data.hdf5 import AnnDataset
    from clann_tpu_torch.metrics.recall import recall_by_ids
    from clann_tpu_torch.ops import gather as tg

    name = f"glove-{DIMS}-angular-synthetic"
    ds = AnnDataset(train, test, gt_d, gt_i, name=name)
    build_dir = os.path.join(HERE, "build")
    os.makedirs(build_dir, exist_ok=True)
    mini_db, db = (os.path.join(build_dir, f) for f in ("minibench.db", "bench_metrics.db"))
    for f in (mini_db, db):
        if os.path.exists(f):
            os.remove(f)

    sync()
    reset_peak()
    t0 = time.perf_counter()
    row = hb.minibench(ds, db_path=mini_db, device=DEVICE)
    log(f"[bench] minibench (L = 50, default mode, {N_QUERIES} queries): "
        f"{time.perf_counter() - t0:.3f} s; row {json.dumps(row)}; peak device memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB on {card}")

    flat_cfg = clann_tpu_torch.Config(num_tables=50, num_clusters_factor=0.4, k=K, delta=0.9,
                                      seed=0, lsh_engine="clustered", dense_layout=False,
                                      dataset_name=name)
    reset_peak()
    tg.reset_launches()
    t0 = time.perf_counter()
    res = hb.run_benchmark_config_puffinn(flat_cfg, ds, db_path=db, device=DEVICE)
    sync()
    flat_s = time.perf_counter() - t0
    launches = tg.ROWS_LAUNCHES
    conn = sqlite3.connect(db)
    try:
        rows = (conn.execute("SELECT COUNT(*) FROM puffinn_results").fetchone()[0],
                conn.execute("SELECT COUNT(*) FROM puffinn_results_query").fetchone()[0])
    finally:
        conn.close()
    log(f"[bench] run_benchmark_config_puffinn (flat C = 1, L = 50, the walk over slot "
        f"records), {N_QUERIES} queries: {flat_s:.3f} s (build "
        f"{res.build_seconds:.3f} s); recall@10 {res.recall:.4f} (gate "
        f"{0.8 * flat_cfg.delta:.2f}), dc/query {res.distance_computations:.1f}, "
        f"{res.qps:.1f} QPS; K7 launches {launches}; rows {rows[0]} run + {rows[1]} query in "
        f"{os.path.relpath(db, HERE)}; peak device memory {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    if launches < 1:
        fail("[bench] the flat baseline did not launch the K7 kernel")
    if res.recall < 0.8 * flat_cfg.delta:
        fail(f"[bench] flat baseline recall@10 {res.recall:.4f} below 0.8 * delta")
    if rows != (1, N_QUERIES):
        fail(f"[bench] the flat baseline wrote {rows} rows, not (1, {N_QUERIES})")

    cfg = clann_tpu_torch.Config(num_tables=50, num_clusters_factor=0.4, k=K, delta=0.9,
                                 seed=0, dataset_name=name)
    tg.reset_launches()
    t0 = time.perf_counter()
    times = hb.compare_implementations_time(cfg, ds, device=DEVICE)
    sync()
    launches_t = tg.ROWS_LAUNCHES
    log(f"[bench] compare_implementations_time (the reference's 10 sampled queries, 15 "
        f"repetitions): {json.dumps(times)} in "
        f"{time.perf_counter() - t0:.3f} s (two builds included); K7 launches {launches_t}")
    if launches_t < 1:
        fail("[bench] compare_implementations_time's lsh search did not launch K7")

    t0 = time.perf_counter()
    algo = ClannTPU(metric="angular", num_tables=50, num_clusters_factor=0.4, device=DEVICE)
    algo.fit(train)
    fit_s = time.perf_counter() - t0
    algo.set_query_arguments(0.9)
    t0 = time.perf_counter()
    algo.batch_query(test, K)
    batch = algo.get_batch_results()
    batch_s = time.perf_counter() - t0
    one = algo.query(test[0], K)
    ids = np.stack([r[:K] for r in batch])
    log(f"[bench] ClannTPU ({algo}): fit {fit_s:.3f} s; batch_query of {N_QUERIES} "
        f"{batch_s:.3f} s ({N_QUERIES / batch_s:.0f} QPS), id-recall "
        f"{recall_by_ids(gt_i, ids, K):.4f} (the default dense mode, not gated); query(test[0]) "
        f"equal to its batch row: {np.array_equal(one, batch[0])}; memory usage "
        f"{algo.get_memory_usage()} kB")
    if len(batch) != N_QUERIES or any(len(r) != K for r in batch):
        fail("[bench] ClannTPU batch results are not K ids per query")
    algo.done()
    return launches + launches_t


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
    sh_k1 = phase_sharded_scan(handle, train, test, gt_d, gt_i, label)
    del handle
    torch.cuda.empty_cache()

    gather = phase_gather(label)
    probe_launches = phase_gather_probe(label)
    lsh = phase_lsh_build(train, label)
    launches_lsh = phase_lsh(lsh, test, gt_d, gt_i, label)
    if args.profile:
        profile_lsh(lsh, test)
    # the new LSH paths run on this index here, so that the walk's build
    # below sees the device as before
    launches_cont = phase_lsh_continuous(lsh, test, gt_d, gt_i, label)
    launches_lsh8 = phase_lsh_int8(lsh, test, gt_d, gt_i, label)
    o_pairs, o_sims = phase_join(lsh, label)
    sh_lsh = phase_sharded_lsh(lsh, test, gt_d, gt_i, label)
    del lsh
    torch.cuda.empty_cache()
    walk = phase_walk_build(train, label)
    launches_walk, walk_k7, walk_source = phase_walk(walk, test, gt_d, gt_i, label)
    if args.profile:
        profile_lsh(walk, test, "walk (lsh -> lsh-clustered)", sessions=1, host_ops=False)
    launches_walk8 = phase_walk_int8(walk, test, gt_d, gt_i, label)
    launches_interop = phase_interop(walk, train, test, gt_d, gt_i, walk_source, label)
    sh_walk = phase_sharded_walk(walk, test, gt_d, gt_i, walk_source, label)
    del walk
    torch.cuda.empty_cache()
    launches_jac, jaccard_k7, (jac_data, jac_queries, jac_gt) = phase_jaccard(label)
    torch.cuda.empty_cache()
    launches_interop += phase_interop_jaccard(jac_data, jac_queries, label)
    sh_jac = phase_sharded_jaccard(jac_data, jac_queries, jac_gt, label)
    del jac_data, jac_queries
    torch.cuda.empty_cache()
    upd, k1_upd, k7_upd, n_searched, build_bytes, (gd_upd, d_upd) = phase_update(
        train, test, gt_d, gt_i, label)
    phase_metrics_db(upd, n_searched, build_bytes, gd_upd, d_upd, label)
    del upd
    torch.cuda.empty_cache()
    launches_pf = phase_puffinn(train, test, gt_d, o_pairs, o_sims, label)
    torch.cuda.empty_cache()
    cli_k1 = phase_cli(label)
    torch.cuda.empty_cache()
    bench_k7 = phase_bench(train, test, gt_d, gt_i, label)
    torch.cuda.empty_cache()
    counts = {"lsh": launches_lsh, "lsh-continuous": launches_cont, "lsh-int8": launches_lsh8,
              "walk": launches_walk, "walk-int8": launches_walk8, "interop": launches_interop,
              "jaccard": launches_jac,
              "update": k7_upd, "puffinn": launches_pf, "sharded lsh": sh_lsh,
              "sharded walk": sh_walk, "sharded jaccard": sh_jac, "bench": bench_k7}
    launches_k7 = sum(counts.values())
    log(f"[main] K7 launches: {launches_k7} = "
        + " + ".join(f"{k} {v}" for k, v in counts.items()))
    k1_counts = {"main": launches_k1, "update": k1_upd, "sharded": sh_k1, "cli": cli_k1}
    launches_k1 = sum(k1_counts.values())
    log(f"[main] K1 launches: {launches_k1} = "
        + " + ".join(f"{k} {v}" for k, v in k1_counts.items()))
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
    # makes many of its launches, gathers 192 B records
    entries[-1]["walk"] = walk_k7
    # and the Jaccard engine's 256 B records (G 16 x [id, 2 sketch words, cluster])
    entries[-1]["jaccard"] = jaccard_k7
    log(json.dumps({"kernels": entries}))
    log(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
