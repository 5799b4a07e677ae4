"""Public API facade (PyTorch port of ``clann_tpu.api``).

`init` / `init_with_config` / `build` / `search` and `Clann.search_batch`,
with an explicit `device`. The reference's facade is src/lib.rs:41-264.

Ported search modes: "scan" (full dense scan), "scan-pallas" (the fused
scan whose candidate stage is the CUDA kernel K1 on a CUDA device),
"scan-block" (block-probed fused scan, kernel K3; n_probe = blocks per
query), "scan-block-adaptive" (doubling probe budget until the block
certificate holds; n_probe = starting budget), and "lsh" / "lsh-global"
(the delta-recall global LSH engine, whose record gather is kernel K7).
"auto" resolves as in the JAX facade (clann_tpu/api.py:126-132): to "lsh"
when the config builds no dense layout. Every other mode of the JAX facade
raises NotImplementedError naming the ROADMAP.md slice that brings it;
none falls back to another mode.
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from clann_tpu_torch.config import Config, MetricsOutput
from clann_tpu_torch.data.metricdata import MetricData, make_metric_data
from clann_tpu_torch.errors import DataError

log = logging.getLogger("clann_tpu_torch")

# JAX facade modes that later port slices bring (ROADMAP.md, "Port slices")
_UNPORTED_MODES = {
    "dense": "slice 4 (IVF dense layout)",
    "adaptive": "slice 4 (IVF dense layout)",
    "lsh-clustered": "slice 5 (the clustered walk)",
}


def resolve_device(device) -> torch.device:
    """torch.device for `device`; a CUDA device must exist (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run on the CPU"
        )
    return dev


class Clann:
    """Stateful handle pairing a dataset, a config, a device and a built
    index (the reference's ClusteredIndex lifecycle: construct, `build()`,
    then search)."""

    def __init__(self, data, config: Config, metric: str = "angular",
                 device="cuda"):
        self.device = resolve_device(device)
        if isinstance(data, MetricData):
            self.data = data
        else:
            self.data = make_metric_data(data, metric)
        if self.data.num_points() == 0:
            raise DataError("empty dataset")  # reference: index.rs:74-76
        if config.metrics_output == MetricsOutput.DB:
            raise NotImplementedError(
                "metrics_output=DB: the SQLite metrics sink comes with "
                "ROADMAP.md slice 10 (interop, h5 and CLI)"
            )
        self.config = config
        self.index = None

    def build(self) -> "Clann":
        """Build the index: GMM geometry, LSH tables, sketches, prefix
        directories and the global engine's tables (core/index.py); the
        dense IVF layout is not built yet (ROADMAP.md slice 4)."""
        from clann_tpu_torch.core.index import build_index

        t0 = time.perf_counter()
        self.index = build_index(
            self.data.raw, self.config, metric=self.data.metric,
            device=self.device,
        )
        log.info("build completed in %.2fs", time.perf_counter() - t0)
        return self

    def _require_built(self):
        if self.index is None:
            raise DataError("index not built; call build() first")
        return self.index

    def search(self, query) -> List[Tuple[float, int]]:
        """k-NN of one query: [(distance, index)] ascending, in the
        configured search mode (reference: src/lib.rs:183-189)."""
        dists, ids, _ = self.search_batch(np.asarray(query)[None, :])
        return [
            (float(d), int(i)) for d, i in zip(dists[0], ids[0]) if i >= 0
        ]

    def search_batch(
        self,
        queries,
        k: Optional[int] = None,
        delta: Optional[float] = None,
        mode: Optional[str] = None,
        n_probe: Optional[int] = None,
        filter_type: str = "default",
    ):
        """Batched k-NN. Returns (distances (Q, k) ascending, ids (Q, k),
        stats) as numpy arrays.

        mode: "scan", "scan-pallas", "scan-block", "scan-block-adaptive",
        "lsh" / "lsh-global" (the global delta engine, with `delta` and
        `filter_type`) or "auto" (default: config.search_mode). `n_probe`:
        blocks per query ("scan-block") or the starting budget
        ("scan-block-adaptive").
        """
        from clann_tpu_torch.ops.ivf import scan_search

        index = self._require_built()
        mode = mode or self.config.search_mode
        if mode == "auto":
            if self.config.dense_layout:
                # the JAX facade resolves to "dense" when the layout exists
                raise NotImplementedError(
                    "search mode 'auto' with config.dense_layout=True resolves to "
                    "'dense', which is not ported yet: ROADMAP.md slice 4 (IVF "
                    "dense layout); pass mode='lsh' or build with dense_layout=False"
                )
            mode = "lsh"
        if mode == "lsh":
            mode = "lsh-global" if index.g_records is not None else "lsh-clustered"
        if mode == "scan":
            dists, ids, stats = scan_search(index, queries, k=k)
        elif mode == "scan-pallas":
            dists, ids, stats = scan_search(index, queries, k=k,
                                            use_pallas=True)
        elif mode == "scan-block":
            from clann_tpu_torch.ops.block_scan import block_scan_search

            dists, ids, stats = block_scan_search(index, queries, k=k,
                                                  n_probe=n_probe)
        elif mode == "scan-block-adaptive":
            from clann_tpu_torch.ops.block_scan import block_scan_search_adaptive

            dists, ids, stats = block_scan_search_adaptive(
                index, queries, k=k, n_probe0=n_probe)
        elif mode == "lsh-global":
            from clann_tpu_torch.ops.global_query import global_search

            dists, ids, stats = global_search(index, queries, k=k, delta=delta,
                                              filter_type=filter_type)
        elif mode in _UNPORTED_MODES:
            raise NotImplementedError(
                f"search mode {mode!r} is not ported yet: ROADMAP.md "
                f"{_UNPORTED_MODES[mode]}"
            )
        else:
            raise DataError(f"unknown search mode {mode!r}")
        return dists, ids, stats


def init(data, metric: str = "angular", device="cuda") -> Clann:
    """A handle with the default Config (reference: lib.rs:76-112)."""
    return Clann(data, Config(), metric=metric, device=device)


def init_with_config(data, config: Config, metric: str = "angular",
                     device="cuda") -> Clann:
    """reference: lib.rs:118-124."""
    return Clann(data, config, metric=metric, device=device)


def build(handle: Clann) -> Clann:
    """reference: lib.rs:142-148."""
    return handle.build()


def search(handle: Clann, query) -> List[Tuple[float, int]]:
    """reference: lib.rs:183-189."""
    return handle.search(query)
