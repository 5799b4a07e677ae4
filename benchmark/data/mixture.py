"""Unit vectors from a mixture of Zipf-weighted modes, made on the card.

The shape of the repository's synthetic glove data (1,024 modes, spread
0.7, mode popularity 1 / rank^0.7): each point is a random unit mode plus
Gaussian noise of norm ~spread, re-normalised. A torch copy of the rule,
drawn with a ``torch.Generator`` on the device in a few large calls, so the
same seed gives the same vectors on any card of one kind.
"""

from __future__ import annotations

import math
import zlib

import numpy as np
import torch

CHUNK_ROWS = 1 << 20


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    ss = np.random.SeedSequence([seed % (1 << 64), zlib.crc32(stream.encode())])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def make_modes(n_modes: int, d: int, seed: int, device) -> torch.Tensor:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    modes = torch.randn(n_modes, d, generator=g, device=device)
    return modes / torch.linalg.vector_norm(modes, dim=1, keepdim=True)


def sample(modes: torch.Tensor, n: int, spread: float, zipf: float, seed: int,
           out: np.ndarray | None = None) -> torch.Tensor | np.ndarray:
    """n points around `modes`. With `out` (a host (n, d) float32 array) the
    rows are written there chunk by chunk and `out` is returned; else one
    device tensor."""
    dev = modes.device
    n_modes, d = modes.shape
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    w = 1.0 / torch.arange(1, n_modes + 1, device=dev, dtype=torch.float64) ** zipf
    cdf = torch.cumsum(w / w.sum(), 0)
    cdf[-1] = 1.0
    sigma = spread / math.sqrt(d)
    parts = []
    for lo in range(0, n, CHUNK_ROWS):
        m = min(CHUNK_ROWS, n - lo)
        u = torch.rand(m, generator=g, device=dev, dtype=torch.float64)
        which = torch.clamp(torch.searchsorted(cdf, u), max=n_modes - 1)
        x = modes[which] + sigma * torch.randn(m, d, generator=g, device=dev)
        x = x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
        if out is None:
            parts.append(x)
        else:
            out[lo:lo + m] = x.cpu().numpy()
    return out if out is not None else torch.cat(parts)


def make_dataset(shape: dict, pool: int, device):
    """(the collection, the query pool), host float32 arrays, for a
    configuration.

    Both stand for the configuration's dataset file, which is one fixed set
    in ann-benchmarks, train and test split from the same vectors: both are
    drawn from the configuration's own `data_seed`, the same for every run,
    the pool from the collection's own modes as a held-out split is. A
    run's seed only orders the pool (harness.Ring)."""
    n, d = int(shape["rows"]), int(shape["dims"])
    n_modes, spread, zipf = int(shape["modes"]), float(shape["spread"]), float(shape["zipf"])
    data_seed = int(shape["data_seed"])
    modes = make_modes(n_modes, d, sub_seed(data_seed, "data-modes"), device)
    train = sample(modes, n, spread, zipf, sub_seed(data_seed, "data"),
                   out=np.empty((n, d), np.float32))
    pool_q = sample(modes, pool, spread, zipf, sub_seed(data_seed, "queries")).cpu().numpy()
    return train, pool_q
