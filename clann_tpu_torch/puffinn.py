"""Drop-in equivalent of the upstream PUFFINN Python API (PyTorch port of
``clann_tpu.puffinn``).

The reference vendors a pybind11 wrapper exposing `puffinn.Index(metric,
dimensions, memory_limit, **kwargs)` with insert / rebuild / search /
search_from_index / closest_pairs / get and pickle support
(libpuffinn/python/wrapper/python_wrapper.cpp:243-584). This module gives
users of that API the same surface over the port's engines, so existing
PUFFINN scripts port by changing one import:

    from clann_tpu_torch import puffinn
    index = puffinn.Index("angular", 100, 4 * 1024**3)
    for v in vectors: index.insert(v)
    index.rebuild()
    ids = index.search(q, 10, 0.9)

Mapping to the port's core:

- "angular" -> a flat (single-segment) build of the vector index with the
  GLOBAL adaptive engine (ops/global_query.py) — a plain PUFFINN over the
  whole dataset, exactly the reference's standalone-index baseline
  (benches/distance_benches.rs:93-203); the delta-recall guarantee is the
  same per-point bound (independent.hpp:108-119).
- "jaccard" -> the set index (core/jaccard.py) with MinHash tables and
  1-bit MinHash sketches (similarity_measure/jaccard.hpp defaults).
- `memory_limit` reproduces the upstream contract — the TABLE COUNT is
  derived from the byte budget at rebuild() time, when the point count is
  known (upstream collection.hpp rebuild sizes tables to the budget; the
  vendored CLANN copy replaced this with an explicit rebuild(num_tables),
  collection.hpp:241-306) — using this framework's own per-structure byte
  model (parallel/capacity.py, the JAX package's), since an i16-CPU byte
  model would mis-size an f32/bf16 build.

Documented divergences (all deliberate, none observable through results):

- FilterType "simple" runs the same filtering math as "default": in the
  reference they differ only in loop implementation (prefetch ring vs
  plain loop, collection.hpp:716-765 vs 768-948), not in which candidates
  pass.
- Pickling stores the raw points and rebuilds lazily on first use after
  unpickling. Hash functions are sampled from an explicit PRNG seed
  (kwargs "seed", default 0), so the rebuilt index is identical — the
  upstream wrapper instead pickles the opaque binary stream because its
  global clock-seeded RNG makes rebuilds non-reproducible
  (typedefs.hpp:17-22).
- Unknown kwargs raise instead of being silently ignored. The port takes
  one keyword more than JAX: `device` (default "cuda", as its facade), the
  device the index is built and searched on; the pickled state carries it.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from clann_tpu_torch.config import Config
from clann_tpu_torch.errors import DataError, IndexCreationError
from clann_tpu_torch.ops.distances import resolve_device

_ANGULAR_HASHES = {
    # upstream name (python_wrapper.cpp:282-288) -> Config.hash_family
    "simhash": "simhash",
    "crosspolytope": "cross_polytope",
    "fht_crosspolytope": "fht_cross_polytope",
}
_SET_HASHES = ("minhash", "1bit_minhash")
_SOURCES = ("independent", "pool", "tensor")
_FILTERS = ("default", "none", "simple")

# Byte model for the budget -> table-count derivation (see module doc).
_SKETCH_BYTES_PER_POINT = 32 * 2 * 4  # NUM_SKETCHES x 64-bit, filterer.hpp:16


def _check_kwargs(kwargs: dict, allowed: dict, where: str) -> None:
    unknown = set(kwargs) - set(allowed)
    if unknown:
        raise TypeError(f"unknown {where} argument(s): {sorted(unknown)}")


class Index:
    """Upstream-compatible index handle (python_wrapper.cpp:243-551).

    metric: "angular" or "jaccard". dimensions: vector dimensionality,
    or the token-universe size for "jaccard" (as upstream). memory_limit:
    index byte budget; table count is derived from it at rebuild().

    kwargs (same names as upstream): hash_function, hash_source,
    hash_args {estimation_repetitions, estimation_eps, num_rotations,
    randomized_bits}, source_args {pool_size}; plus "seed" (this
    framework's explicit PRNG seed; no upstream counterpart) and "device"
    (the port's device, default "cuda").
    """

    def __init__(
        self, metric: str, dimensions: int, memory_limit: int, **kwargs
    ):
        if metric not in ("angular", "jaccard"):
            raise ValueError(f"metric {metric!r}")  # python_wrapper.cpp:261
        if dimensions <= 0:
            raise ValueError("dimensions must be positive")
        if memory_limit <= 0:
            raise ValueError("memory_limit must be positive")
        _check_kwargs(
            kwargs,
            dict.fromkeys(
                ("hash_function", "hash_source", "hash_args",
                 "source_args", "seed", "device")
            ),
            "Index()",
        )
        hash_function = kwargs.get(
            "hash_function",
            "fht_crosspolytope" if metric == "angular" else "minhash",
        )
        if metric == "angular" and hash_function not in _ANGULAR_HASHES:
            raise ValueError(f"hash_function {hash_function!r}")
        if metric == "jaccard" and hash_function not in _SET_HASHES:
            raise ValueError(f"hash_function {hash_function!r}")
        hash_source = kwargs.get("hash_source", "independent")
        if hash_source not in _SOURCES:
            raise ValueError(f"hash_source {hash_source!r}")
        if metric == "jaccard" and hash_source != "independent":
            # the set index hardcodes the independent source (the
            # reference default, collection.hpp:130-131); silently
            # running with different collision statistics than the user
            # asked for would corrupt their recall contract
            raise NotImplementedError(
                "jaccard supports hash_source='independent' only"
            )
        hash_args = dict(kwargs.get("hash_args") or {})
        _check_kwargs(
            hash_args,
            dict.fromkeys(
                ("estimation_repetitions", "estimation_eps",
                 "num_rotations", "randomized_bits")
            ),
            "hash_args",
        )
        if "randomized_bits" in hash_args:
            # MinHash::Args.randomized_bits (minhash.hpp:51-95) works
            # around partial-hash pathologies of the reference's
            # tabulation hashing; this framework's MinHash mixes with
            # fmix32 (ops/minhash.py) which has no such pathology.
            hash_args.pop("randomized_bits")
        source_args = dict(kwargs.get("source_args") or {})
        _check_kwargs(source_args, {"pool_size": None}, "source_args")

        self.metric = metric
        self.dimensions = int(dimensions)
        self.memory_limit = int(memory_limit)
        self.hash_function = hash_function
        self.hash_source = hash_source
        self.hash_args = hash_args
        self.source_args = source_args
        self.seed = int(kwargs.get("seed", 0))
        self.device = str(resolve_device(kwargs.get("device", "cuda")))
        self._points: List[np.ndarray] = []  # angular rows / token arrays
        self._index = None
        self._built_count = 0  # points covered by the current tables

    # -- data ------------------------------------------------------------

    def insert(self, value: Sequence) -> None:
        """Buffer one value; searchable after rebuild()
        (collection.hpp:218-222 insert-then-rebuild contract)."""
        if self.metric == "angular":
            v = np.asarray(value, np.float32).reshape(-1)
            if v.shape[0] != self.dimensions:
                raise ValueError(
                    f"expected {self.dimensions} dimensions, got {v.shape[0]}"
                )
            self._points.append(v)
        else:
            toks = np.unique(np.asarray(value, np.int64))
            if toks.size and (toks[0] < 0 or toks[-1] >= self.dimensions):
                raise DataError(
                    "token outside universe"  # set.hpp:30-48
                )
            self._points.append(toks.astype(np.int32))

    def get(self, idx: int) -> list:
        """The stored value (python_wrapper.cpp:300-306). Angular values
        are returned L2-normalized — the reference stores unit vectors
        too (unit_vector.hpp:26-45), it just also rounds them to Q15."""
        if not 0 <= idx < len(self._points):
            raise IndexError(idx)
        v = self._points[idx]
        if self.metric == "angular":
            n = float(np.linalg.norm(v))
            return (v / n if n > 0 else v).tolist()
        return v.tolist()

    def __len__(self) -> int:
        return len(self._points)

    # -- build -----------------------------------------------------------

    def _derive_num_tables(self, n: int) -> int:
        """Tables that fit the byte budget at the current point count.

        Upstream semantics (rebuild sizes L to the memory budget). The
        angular byte model is parallel/capacity.plan_capacity evaluated
        on the ACTUAL build config — total bytes are linear in L, so two
        plan evaluations give the fixed and per-table costs and nothing
        here can drift from the planner's (single) structure model.
        """
        if self.metric == "angular":
            from clann_tpu_torch.parallel.capacity import plan_capacity

            t1 = plan_capacity(n, self.dimensions, self._config(1)).total_bytes
            t2 = plan_capacity(n, self.dimensions, self._config(2)).total_bytes
            per_table = max(1, t2 - t1)
            fixed = t1 - per_table
        else:
            t_max = max((p.size for p in self._points), default=1)
            fixed = n * t_max * 4 + n * _SKETCH_BYTES_PER_POINT
            per_table = n * 8
        budget = self.memory_limit - fixed
        if budget < per_table:
            raise IndexCreationError(
                "insufficient memory"  # c_binder.cpp:53-60 contract
            )
        return int(min(budget // per_table, 256))

    def _config(self, num_tables: int) -> Config:
        extra = {}
        if self.metric == "angular":
            extra = {
                "hash_family": _ANGULAR_HASHES[self.hash_function],
                "hash_source": self.hash_source,
                # flat PUFFINN equivalent: global engine, no IVF layout,
                # no per-cluster walk records
                "lsh_engine": "global",
                "dense_layout": False,
                "pack_slot_records": False,
            }
            for k in ("estimation_repetitions", "estimation_eps",
                      "num_rotations"):
                if k in self.hash_args:
                    extra[k] = self.hash_args[k]
            if "pool_size" in self.source_args:
                extra["pool_size"] = int(self.source_args["pool_size"])
        return Config(num_tables=num_tables, seed=self.seed, **extra)

    def _build(self, n: int) -> None:
        """Build tables over the first n buffered points."""
        L = self._derive_num_tables(n)
        cfg = self._config(L)
        if self.metric == "angular":
            from clann_tpu_torch.core.index import build_lsh_index

            self._index = build_lsh_index(np.stack(self._points[:n]), cfg,
                                          device=self.device)
        else:
            from clann_tpu_torch.core.jaccard import build_jaccard_index
            from clann_tpu_torch.data.setdata import JaccardData

            data = JaccardData(
                [p.tolist() for p in self._points[:n]], self.dimensions
            )
            self._index = build_jaccard_index(
                data, cfg, table_hash=self.hash_function, device=self.device
            )

    def rebuild(self) -> None:
        """(Re)hash every inserted point into the tables
        (python_wrapper.cpp:308-315; table count from the byte budget)."""
        n = len(self._points)
        if n == 0:
            raise DataError("empty dataset")
        self._build(n)
        self._built_count = n

    def _require_built(self):
        if self._index is None:
            if self._built_count > 0:
                # pickled handle: restore EXACTLY the state that was
                # serialized — tables over the first _built_count points,
                # later inserts stay pending (collection.hpp:218-222
                # contract; the explicit seed makes this deterministic)
                self._build(self._built_count)
            else:
                self.rebuild()
        return self._index

    # -- queries ----------------------------------------------------------

    @staticmethod
    def _filter(name: str) -> str:
        if name not in _FILTERS:
            raise ValueError(f"filter_type {name!r}")  # python_wrapper:318
        return "default" if name == "simple" else name

    def search(
        self, value: Sequence, k: int, recall: float,
        filter_type: str = "default",
    ) -> List[int]:
        """ids of the k approximate nearest neighbors, most similar
        first, with per-point failure probability <= 1 - recall
        (python_wrapper.cpp:330-344)."""
        ft = self._filter(filter_type)
        index = self._require_built()
        if self.metric == "angular":
            from clann_tpu_torch.ops.global_query import global_search

            _, ids, _ = global_search(
                index, np.asarray(value, np.float32)[None, :],
                k=k, delta=recall, filter_type=ft,
            )
        else:
            from clann_tpu_torch.core.jaccard import jaccard_search

            _, ids, _ = jaccard_search(
                index, [list(np.asarray(value, np.int64))],
                k=k, delta=recall, filter_type=ft,
            )
        return [int(i) for i in ids[0] if i >= 0]

    def search_from_index(
        self, idx: int, k: int, recall: float,
        filter_type: str = "default",
    ) -> List[int]:
        """k-NN of an already-inserted point, the point itself removed
        (collection.hpp:335-356)."""
        self._require_built()
        if not 0 <= idx < self._built_count:
            raise IndexError(idx)
        res = self.search(
            self._points[idx], k + 1, recall, filter_type=filter_type
        )
        return [i for i in res if i != idx][:k]

    def closest_pairs(
        self, k: int, recall: float, filter_type: str = "default",
    ) -> List[Tuple[int, int]]:
        """The k most similar pairs among indexed points
        (python_wrapper.cpp:346-357 over collection.hpp:390-504)."""
        self._filter(filter_type)  # validate; joins do not sketch-filter
        index = self._require_built()
        if self.metric == "angular":
            from clann_tpu_torch.ops.join import closest_pairs

            pairs, _ = closest_pairs(index, k=k, delta=recall)
        else:
            from clann_tpu_torch.ops.join import jaccard_closest_pairs

            pairs, _ = jaccard_closest_pairs(index, k=k, delta=recall)
        return [(int(a), int(b)) for a, b in pairs if a >= 0]

    # -- pickling ----------------------------------------------------------

    def __getstate__(self):
        return {
            "metric": self.metric,
            "dimensions": self.dimensions,
            "memory_limit": self.memory_limit,
            "hash_function": self.hash_function,
            "hash_source": self.hash_source,
            "hash_args": self.hash_args,
            "source_args": self.source_args,
            "seed": self.seed,
            "device": self.device,
            "points": self._points,
            "built_count": self._built_count,
        }

    def __setstate__(self, state):
        self.metric = state["metric"]
        self.dimensions = state["dimensions"]
        self.memory_limit = state["memory_limit"]
        self.hash_function = state["hash_function"]
        self.hash_source = state["hash_source"]
        self.hash_args = state["hash_args"]
        self.source_args = state["source_args"]
        self.seed = state["seed"]
        self.device = state["device"]
        self._points = state["points"]
        self._built_count = state["built_count"]
        # rebuilt lazily on first query; identical tables by explicit seed
        self._index = None
