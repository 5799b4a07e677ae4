"""The control: the reference put in the program's place, one precision
below the configuration's (TF32 products where the configuration states
float32 with TF32 off). The comparison has to find it not correct."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.knn import exact_knn


def tf32_search(device, k: int):
    """A `wrap` for harness.run_cell: exact k-NN with TF32 products."""

    def wrap(_search, train: np.ndarray, _pool):
        base = torch.as_tensor(train, device=device)

        def search(queries: np.ndarray):
            d, i = exact_knn(base, torch.as_tensor(queries, device=device), k, tf32=True)
            return d.cpu().numpy(), i.cpu().numpy().astype(np.int32), None

        return search

    return wrap

