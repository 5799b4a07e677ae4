"""clann_tpu_torch — the PyTorch / CUDA port of clann_tpu.

A second package beside the JAX one (which stays the reference the port is
tested against). It imports torch and never jax. Ported so far: the cluster
build (GMM geometry) and the dense scan query modes "scan" and
"scan-pallas"; the latter's candidate stage is a hand-written CUDA kernel
for sm_90a (csrc/scan_topk.cu), built with nvcc on first use.

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
