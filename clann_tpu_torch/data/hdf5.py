"""ann-benchmarks HDF5 dataset loading (PyTorch port of ``clann_tpu.data.hdf5``).

The reference loader (src/utils/mod.rs:25-57) reads the datasets ``train``,
``test`` and ``distances`` of an ann-benchmarks layout file. Host numpy
only: h5py is imported inside the two functions, so the package imports
without it (the card machine has none).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np

from clann_tpu_torch.errors import DataError


@dataclasses.dataclass
class AnnDataset:
    """An ann-benchmarks dataset triple (reference: src/utils/mod.rs:18-23)."""

    train: np.ndarray  # (n, d) float32
    test: np.ndarray  # (q, d) float32
    distances: Optional[np.ndarray]  # (q, k_gt) float32 ground-truth distances
    neighbors: Optional[np.ndarray]  # (q, k_gt) int32 ground-truth ids (extra)
    name: str = ""


def load_hdf5_dataset(path: str, name: str = "") -> AnnDataset:
    """Load an ann-benchmarks file (reference: src/utils/mod.rs:25-57).

    ``train`` and ``test`` are required; ``distances`` and ``neighbors``
    are read when present (ann-benchmarks files always carry both). The
    name defaults to the file's stem. A missing file or key raises
    DataError.
    """
    import h5py

    if not os.path.exists(path):
        raise DataError(f"dataset file not found: {path}")
    with h5py.File(path, "r") as f:
        for key in ("train", "test"):
            if key not in f:
                raise DataError(f"dataset {path} missing required key {key!r}")
        train = np.asarray(f["train"], dtype=np.float32)
        test = np.asarray(f["test"], dtype=np.float32)
        distances = np.asarray(f["distances"], dtype=np.float32) if "distances" in f else None
        neighbors = np.asarray(f["neighbors"], dtype=np.int32) if "neighbors" in f else None
    if not name:
        name = os.path.splitext(os.path.basename(path))[0]
    return AnnDataset(train=train, test=test, distances=distances, neighbors=neighbors,
                      name=name)


def save_hdf5_dataset(path: str, ds: AnnDataset) -> None:
    """Write an ann-benchmarks layout file (the inverse of load_hdf5_dataset)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("train", data=ds.train)
        f.create_dataset("test", data=ds.test)
        if ds.distances is not None:
            f.create_dataset("distances", data=ds.distances)
        if ds.neighbors is not None:
            f.create_dataset("neighbors", data=ds.neighbors)
