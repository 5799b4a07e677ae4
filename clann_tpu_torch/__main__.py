"""CLI / demo driver: python -m clann_tpu_torch [options] [--save]

PyTorch port of ``clann_tpu.__main__``, the reference CLI (src/main.rs):
- loads an ann-benchmarks dataset (h5py, host only), or generates a
  synthetic one when no file is given;
- builds the index or loads it from the __index_cache__/ directory under
  the reference's cache-key file name (main.rs:19-45 load-or-build logic);
- runs the test queries (main.rs:61-84);
- prints recall / QPS and, with --save, writes the metrics to SQLite
  (main.rs:96-105).

`--device` places the index (default: the card); `--plan` prints the
analytic capacity plan and touches no device.
"""

from __future__ import annotations

import argparse
import logging
import os
import sys
import time

import numpy as np

MODES = [
    "auto", "lsh", "lsh-global", "lsh-clustered", "dense",
    "scan", "scan-pallas", "scan-block", "scan-block-adaptive",
    "adaptive",
]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m clann_tpu_torch",
        description="Clustered LSH nearest-neighbor search demo (PyTorch / CUDA)",
    )
    p.add_argument("--dataset", default="", help="ann-benchmarks HDF5 file")
    p.add_argument("--synthetic-n", type=int, default=100_000,
                   help="synthetic dataset size when no --dataset is given")
    p.add_argument("--synthetic-d", type=int, default=25)
    p.add_argument("--queries", type=int, default=1000)
    # canonical demo config (reference: main.rs:22-29)
    p.add_argument("--num-tables", "-L", type=int, default=84)
    p.add_argument("--factor", type=float, default=0.4)
    p.add_argument("-k", type=int, default=10)
    p.add_argument("--delta", type=float, default=0.9)
    p.add_argument("--mode", choices=MODES, default="auto")
    p.add_argument("--hash-family", default="fht_cross_polytope",
                   choices=["fht_cross_polytope", "cross_polytope", "simhash"])
    p.add_argument("--cache-dir", default="__index_cache__",
                   help="index cache directory (main.rs:31-45)")
    p.add_argument("--no-cache", action="store_true")
    p.add_argument("--save", nargs="?", const="results.db", default=None,
                   help="save metrics to this SQLite db (main.rs:96-105)")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--plan", action="store_true",
                   help="print the device-memory capacity plan for this build and "
                        "exit (no allocation; parallel/capacity.py)")
    p.add_argument("--device", default="cuda",
                   help="device of the index and the searches (default: cuda)")
    args = p.parse_args(argv)

    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s",
    )
    log = logging.getLogger("clann_tpu_torch.cli")

    import clann_tpu_torch
    from clann_tpu_torch.io.h5 import index_file_name
    from clann_tpu_torch.metrics.recall import recall_values

    if args.dataset and args.plan:
        # planning is analytic: read only the train shape from the header
        import h5py

        with h5py.File(args.dataset, "r") as f:
            n_plan, d_plan = f["train"].shape
        ds = None
    elif args.dataset:
        from clann_tpu_torch.data.hdf5 import load_hdf5_dataset

        ds = load_hdf5_dataset(args.dataset)
        n_plan, d_plan = ds.train.shape
    elif args.plan:
        # capacity planning is analytic: no data, no devices needed
        ds = None
        n_plan, d_plan = args.synthetic_n, args.synthetic_d
    else:
        from clann_tpu_torch.data.synthetic import make_synthetic_dataset

        log.info("no dataset given; generating synthetic %dx%d",
                 args.synthetic_n, args.synthetic_d)
        ds = make_synthetic_dataset(
            n=args.synthetic_n, d=args.synthetic_d,
            n_queries=args.queries, k_gt=max(args.k, 10), seed=0,
            device=args.device,
        )

    cfg = clann_tpu_torch.Config(
        num_tables=args.num_tables,
        num_clusters_factor=args.factor,
        k=args.k,
        delta=args.delta,
        dataset_name=(
            ds.name if ds is not None
            else os.path.splitext(os.path.basename(args.dataset))[0]
            if args.dataset
            else f"synthetic-{n_plan}x{d_plan}"
        ),
        metrics_output=clann_tpu_torch.MetricsOutput.DB if args.save else
        clann_tpu_torch.MetricsOutput.NONE,
        hash_family=args.hash_family,
        search_mode=args.mode,
    )

    if args.plan:
        plan = clann_tpu_torch.plan_capacity(n_plan, d_plan, cfg)
        for name, b in sorted(plan.per_structure.items(), key=lambda kv: -kv[1]):
            print(f"  {name:<18} {b / 1e9:10.3f} GB")
        print(f"  shardable  {plan.shardable_bytes / 1e9:.3f} GB | "
              f"replicated {plan.replicated_bytes / 1e9:.3f} GB | "
              f"usable/chip {plan.usable_bytes / 1e9:.3f} GB")
        print(f"  fits one chip: {plan.fits_single_chip} | "
              f"min devices: {plan.min_devices} | "
              f"recommended: {plan.recommended_devices}")
        return 0

    cache_path = os.path.join(args.cache_dir, index_file_name(cfg))
    handle = None
    if not args.no_cache and os.path.exists(cache_path):
        log.info("loading cached index %s", cache_path)
        handle = clann_tpu_torch.init_from_file(ds.train, cache_path, device=args.device)
        handle.config = cfg
    if handle is None:
        handle = clann_tpu_torch.init_with_config(ds.train, cfg, device=args.device)
        t0 = time.perf_counter()
        clann_tpu_torch.build(handle)
        log.info("built index in %.1fs", time.perf_counter() - t0)
        if not args.no_cache:
            os.makedirs(args.cache_dir, exist_ok=True)
            path = clann_tpu_torch.serialize(handle, args.cache_dir)
            log.info("cached index at %s", path)

    queries = ds.test[: args.queries]
    log.info("searching %d queries (mode=%s)...", len(queries), args.mode)
    t0 = time.perf_counter()
    dists, ids, stats = handle.search_batch(queries, mode=args.mode)
    elapsed = time.perf_counter() - t0  # the results are host numpy
    qps = len(queries) / elapsed

    if ds.distances is not None:
        recall, recall_std, _ = recall_values(
            ds.distances[: len(queries)], dists, count=args.k
        )
        print(f"recall@{args.k}: {recall:.4f} (+-{recall_std:.4f})")
    print(f"queries:    {len(queries)}")
    print(f"total time: {elapsed:.3f}s  ({qps:.0f} QPS)")
    print(f"distance computations/query: "
          f"{float(np.mean(stats.distance_computations)):.0f}")

    if args.save:
        handle.save_metrics(
            args.save,
            clann_tpu_torch.MetricsGranularity.QUERY,
            ground_truth_distances=ds.distances[: len(queries)]
            if ds.distances is not None else None,
            run_distances=dists,
            total_search_time_s=elapsed,
        )
        print(f"metrics saved to {args.save}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
