"""clann_tpu_torch — the PyTorch / CUDA port of clann_tpu.

A second package beside the JAX one (which stays the reference the port is
tested against). It imports torch and never jax. Ported so far: the index
build (GMM geometry, LSH hash tables, sketches, prefix directories and the
global engine's tables), the dense scan modes "scan" and "scan-pallas", the
block-probed modes "scan-block" and "scan-block-adaptive", and the global
delta-recall LSH engine ("lsh", "lsh-global"). Their kernels are written by
hand in CUDA for sm_90a (csrc/), built with nvcc on first use: K1-K3 for the
scans, K4-K7 for row gathers (K7 is the LSH engine's record gather).

Public facade mirrors the reference API (reference: src/lib.rs:41-264).
"""

from clann_tpu_torch.api import Clann, build, init, init_with_config, search
from clann_tpu_torch.config import Config, MetricsGranularity, MetricsOutput
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
    "init",
    "init_with_config",
    "build",
    "search",
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
