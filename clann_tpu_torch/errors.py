"""Typed error hierarchy for clann_tpu_torch.

The same classes as ``clann_tpu.errors`` (the reference's error enum,
src/core/errors.rs:5-39), defined again here so that the PyTorch port never
imports the JAX package. Each variant of the Rust ``ClusteredIndexError``
maps to an exception class so callers can catch the same failure classes.
"""


class ClusteredIndexError(Exception):
    """Base class for all clann_tpu errors (reference: src/core/errors.rs:5)."""


class ConfigError(ClusteredIndexError):
    """Invalid configuration (reference: errors.rs Config variant)."""


class DataError(ClusteredIndexError):
    """Invalid dataset, e.g. empty input (reference: errors.rs Data variant)."""


class ResultDBError(ClusteredIndexError):
    """Metrics database failure (reference: errors.rs ResultDB variant)."""


class InvalidAssignmentError(ClusteredIndexError):
    """Cluster assignment inconsistency (reference: errors.rs InvalidAssignment)."""


class IndexCreationError(ClusteredIndexError):
    """LSH index build failure (reference: errors.rs PuffinnCreation variant)."""


class IndexSearchError(ClusteredIndexError):
    """LSH index query failure (reference: errors.rs PuffinnSearch variant)."""


class IndexNotFoundError(ClusteredIndexError):
    """Missing per-cluster index (reference: errors.rs IndexNotFound variant)."""


class IndexOutOfBoundsError(ClusteredIndexError):
    """Out-of-bounds access (reference: errors.rs IndexOutOfBounds variant)."""


class IndexMappingError(ClusteredIndexError):
    """Local->global candidate remap failure (reference: errors.rs IndexMapping)."""


class SerializeError(ClusteredIndexError):
    """Index (de)serialization failure (reference: errors.rs Serialize variant)."""


class MetricsError(ClusteredIndexError):
    """Metrics collection/aggregation failure (reference: errors.rs Metrics)."""
