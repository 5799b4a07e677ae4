"""clann_tpu_torch — the PyTorch / CUDA port of clann_tpu.

A second package beside the JAX one (which stays the reference the port is
tested against). It imports torch and never jax. It holds the whole
index build (GMM geometry, LSH hash tables, sketches, prefix directories,
the global engine's tables, the clustered walk's slot records and the dense
IVF layout) and every search mode of the JAX facade: "auto" (the default),
"dense", "adaptive", "scan", "scan-pallas", "scan-block",
"scan-block-adaptive", "lsh", "lsh-global" and "lsh-clustered", plus
`Clann.search_by_id` and `ops.scan_topk.pallas_scan_topk`; the int8
rescore (`Config(rescore_dtype="int8")`) in every mode; and, from their
modules as in the JAX package, the global engine's continuous-batching
driver `ops.global_query.global_search_continuous` and the Jaccard set
index `core.jaccard` (`build_jaccard_index`, `jaccard_search`,
`jaccard_scan`); closest pairs (`Clann.closest_pairs`, `ops.join`),
`insert` / `rebuild` and the C = 1 index (`core.index.build_lsh_index`),
the upstream PUFFINN surface (`clann_tpu_torch.puffinn`), the SQLite
metrics sink (`Config(metrics_output=DB)`, `save_metrics`, `metrics.run`),
the capacity model (`plan_capacity`), the native h5 format
(`serialize`, `init_from_file`, `io.h5`) and the Rust reference's index
files (`io.interop`: export, and a faithful import whose per-cluster hash
functions the walk hashes queries with; `io.refcodec`, a C++ codec built
with g++ on first use), the ann-benchmarks dataset files (`data.hdf5`),
the benchmark harness and adapter (`bench.*`), the CLI (`python -m
clann_tpu_torch`) and the sharded paths (`parallel.*`: a single-controller
mesh of torch devices, several shards per device allowed). Every module of
the JAX package has its counterpart here. Their kernels are written by hand in CUDA for sm_90a
(csrc/), built with nvcc on first use: the dense scans K1-K3 share one
Hopper main loop (TMA + wgmma, csrc/scan_hopper.cuh), and K4-K7 are row
gathers (K7 is the record gather of the LSH engines, the Jaccard one
included). Entry points run on the card unless the caller asks for the
CPU.

Public facade mirrors the reference API (reference: src/lib.rs:41-264).
"""

from clann_tpu_torch.api import (
    Clann,
    build,
    init,
    init_from_file,
    init_with_config,
    insert,
    rebuild,
    save_metrics,
    search,
    serialize,
)
from clann_tpu_torch.config import Config, MetricsGranularity, MetricsOutput
from clann_tpu_torch.parallel.capacity import CapacityPlan, plan_capacity
from clann_tpu_torch.errors import (
    ClusteredIndexError,
    ConfigError,
    DataError,
    IndexCreationError,
    IndexNotFoundError,
    IndexOutOfBoundsError,
    IndexSearchError,
    MetricsError,
    ResultDBError,
    SerializeError,
)

__version__ = "0.1.0"

__all__ = [
    "Clann",
    "Config",
    "MetricsGranularity",
    "MetricsOutput",
    "CapacityPlan",
    "plan_capacity",
    "init",
    "init_with_config",
    "init_from_file",
    "build",
    "insert",
    "rebuild",
    "search",
    "serialize",
    "save_metrics",
    "ClusteredIndexError",
    "ConfigError",
    "DataError",
    "IndexCreationError",
    "IndexNotFoundError",
    "IndexOutOfBoundsError",
    "IndexSearchError",
    "MetricsError",
    "ResultDBError",
    "SerializeError",
    "__version__",
]
