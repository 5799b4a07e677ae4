"""Configuration for the clustered LSH index (PyTorch port).

A copy of ``clann_tpu.config`` with the same fields and defaults, so that
``Config.to_dict()`` of one package feeds ``Config.from_dict`` of the other.
The TPU-tuned knobs below are kept verbatim for parity; the port reads only
the ones its ported modules use. Original description follows.

TPU-native equivalent of the reference Config
(reference: src/core/config.rs:16-48) with the same serde-compatible JSON
field names and defaults ``{num_tables: 10, num_clusters_factor: 1.0, k: 10,
delta: 0.9, dataset_name: "", metrics_output: None}`` plus TPU-specific
execution knobs that have no counterpart in the single-threaded CPU
reference (batch sizes, dtypes, mesh axes).
"""

from __future__ import annotations

import dataclasses
import enum
import json
from typing import Any, Optional


class MetricsOutput(enum.Enum):
    """Where run metrics are written (reference: src/core/config.rs:3-7)."""

    NONE = "None"
    DB = "DB"


class MetricsGranularity(enum.Enum):
    """Detail level of saved metrics (reference: src/core/config.rs:9-13)."""

    RUN = "Run"
    QUERY = "Query"
    CLUSTER = "Cluster"


@dataclasses.dataclass(frozen=True, eq=True)
class Config:
    """Build/search configuration.

    Fields mirror the reference ``Config`` struct
    (reference: src/core/config.rs:16-35); TPU-only fields are grouped after
    and are excluded from reference-compatible JSON unless set to
    non-default values.

    Frozen + hashable so a Config can be a static (treedef) leaf of jitted
    index pytrees — one compiled program per distinct configuration.
    """

    # --- reference-compatible fields (src/core/config.rs:37-48 defaults) ---
    num_tables: int = 10
    num_clusters_factor: float = 1.0
    k: int = 10
    delta: float = 0.9
    dataset_name: str = ""
    metrics_output: MetricsOutput = MetricsOutput.NONE

    # --- TPU-native execution knobs (no reference counterpart) ---
    # LSH hash family for tables: "fht_cross_polytope" (reference default,
    # cosine.hpp:16), "cross_polytope", or "simhash".
    hash_family: str = "fht_cross_polytope"
    # Hash source: "independent" (reference default, collection.hpp:130-131),
    # "pool", or "tensor".
    hash_source: str = "independent"
    # Pool size for hash_source="pool" (reference: HashPoolArgs pool_size,
    # upstream python wrapper source_args {"pool_size"}); 0 = the
    # 3*sqrt(L*fph) heuristic in ops/sources.PooledHashSource.
    pool_size: int = 0
    # Maximum concatenated hash length in bits (reference: typedefs.hpp:9).
    max_hashbits: int = 24
    # Sketch configuration (reference: filterer.hpp:16, typedefs.hpp:12-15).
    num_sketches: int = 32
    sketch_bits: int = 64
    # Number of pseudo-random FHT rotations (reference: crosspolytope.hpp:222).
    num_rotations: int = 3
    # Monte-Carlo collision-probability tabulation (crosspolytope.hpp:223-225).
    estimation_repetitions: int = 1000
    estimation_eps: float = 5e-3
    # Clusters with fewer points than this are brute-forced
    # (reference: src/core/index.rs:204-205 uses <100 or <k).
    brute_force_threshold: int = 100
    # Per-query candidate chunk processed per rescore step. Static shape so
    # XLA compiles one program; larger = fewer loop steps, more padding work.
    candidate_chunk: int = 512
    # Sketch-filter window = candidate_chunk * filter_expand stream
    # positions examined per step; only filter-passing candidates (up to
    # candidate_chunk of them) get their vectors gathered and rescored —
    # the batched analog of the reference's FILTER_BUFFER_SIZE=128 staging
    # buffer (collection.hpp:775-781).
    filter_expand: int = 8
    # Depth at which the adaptive query loop gives up (reference runs 24..1;
    # stopping early only increases work never decreases recall).
    min_depth: int = 1
    # Pack [id, sketch] per (table, slot) into one record array so the LSH
    # window scan needs one gather per candidate instead of two dependent
    # ones (core/index.make_slot_records). Costs (1+W)/2 extra table bytes;
    # disable under memory pressure.
    pack_slot_records: bool = True
    # LSH candidate gather block: the query window fetches records in runs
    # of `gather_block` consecutive table slots per gather lane. Measured on
    # v5e, a random gather costs ~40-50ns per INDEX regardless of element
    # size up to ~100B, and stream ranges are contiguous equal-hash runs —
    # so fetching G records per lane multiplies candidate throughput by up
    # to G at zero extra gather cost (block-edge lanes are masked; tiny
    # ranges degrade gracefully to parity). Power of two; 1 disables.
    # Swept on v5e at 200k x 100 (heavy-collision data): QPS grows through
    # G=16 (45 -> 105 with chunk=2048/filter_expand=4) and flattens by 32.
    gather_block: int = 16
    # Cluster ranks fused per outer step of the clustered walk: G members'
    # candidate streams are concatenated so one filter window can drain
    # several small clusters per iteration. Per-member delta termination
    # and ball-overlap stops are preserved (ops/query.search_batch_impl).
    # Measured on v5e at 200k x 100 (64-query batches): G=1 23.7 QPS,
    # G=4 21, G=8 18.7, G=16 14.9 — grouping LOSES because the walk is
    # bound by the per-(query, cluster, table, depth) range-search probes,
    # whose count grouping does not change, while batching G clusters'
    # bisections inflates the lockstep trip count to the group max. Kept
    # as a knob (the fused form may win on low-collision data where the
    # at-least-one-window-per-cluster floor dominates instead).
    lsh_group_ranks: int = 1
    # Prefix-directory bits per (table, cluster) segment seeding query-time
    # binary searches (the reference's PREFIX_INDEX_BITS=13 directory,
    # prefixmap.hpp:70 — smaller here because it is per cluster segment).
    # 0 disables.
    prefix_dir_bits: int = 10
    # Directory lookups in the clustered walk as MXU one-hot contractions
    # instead of per-index gathers (ops/prefixmap._dir_select_onehot):
    # the (q, cluster, table, level) bound lookups are the walk's probe
    # hot spot and gathers pay ~40-50ns per index on v5e. Bit-identical
    # to the gather path (tested). Measured at 200k x 100, bs=64:
    # 23.7 -> 27.3 QPS alone; 40.4 -> 44.7 on top of lsh_entry_cap.
    dir_onehot: bool = True
    # Enter the peel walk at the directory granularity
    # (d_entry = min(d_entry, prefix_dir_bits)) so every level bound is a
    # direct directory answer and the bisection tail disappears. Consumes
    # each table's full dir_bits-prefix bucket at entry — identical
    # delta-guarantee semantics at depth dir_bits. Measured at 200k x 100:
    # 23.7 -> 44.7 QPS (with dir_onehot), recall 0.901 -> 0.904, dc/q +1%
    # (the adaptive stop rarely fired deeper than the directory
    # granularity anyway).
    lsh_entry_cap: bool = True
    # Lazy depth-level materialization for the clustered walk: peel levels
    # are computed in windows of this many levels per (group, chunk) outer
    # step, and deeper windows are materialized ONLY when some query's
    # delta check still fails after exhausting the current window — the
    # stop state at a window edge, (1-p(d_lo))^L, depends only on the
    # query's k-th similarity, so the descend decision is one table lookup.
    # 0 = eager (materialize every level up front). Requires the prefix
    # directory + lsh_entry_cap (direct directory bounds); ignored
    # otherwise. MEASURED NEGATIVE on v5e at 200k x 100, bs=64 (default
    # stays eager): flat data 44.7 QPS eager vs 33.1/40.2/42.6 at
    # lc=2/4/6; hierarchical data 19.8 vs 17.1/18.6 at lc=2/4. The delta
    # check typically needs several levels, and one unsatisfied query per
    # 64-batch forces the descent for everyone, so per-window fixed costs
    # (stream build, at-least-one-window inner rounds) repeat without
    # skipping levels. Kept as a knob for small-batch / low-L regimes
    # where walks retire at entry.
    lsh_level_chunk: int = 0
    # LSH engine layout: "clustered" = the reference-faithful per-cluster
    # walk (ops/query.py); "global" = the ball-filtered global adaptive
    # engine (ops/global_query.py — same delta guarantee, one set of range
    # searches per query instead of per (query, cluster)); "both" builds
    # the structures for both so either mode can be forced at query time.
    # Default "global" (flipped round 3, VERDICT r2 #8): the global engine
    # dominates the clustered walk at every measured shape — 56 vs ~5 QPS
    # at 1.18M x 100, ~270 vs 23-45 at 200k (PERFORMANCE.md) — with the
    # same delta guarantee evaluated with the true global k-th best (the
    # clustered walk only approximates it via max_sim feedback). The walk
    # stays selectable for reference-faithful comparisons, and faithful
    # imports still force it (io/interop.py — per-cluster functions).
    lsh_engine: str = "global"
    # Directory bits for the global tables (full 13 like the reference:
    # one directory per table, not per cluster, so memory is tiny).
    global_dir_bits: int = 13
    # Experimental entry-depth cap for the GLOBAL engine (0 = off): enter
    # the peel walk at this depth instead of log2(n)+2. See
    # ops/global_query.global_search_batch_impl; measure dc/QPS before
    # enabling (global buckets hold n/2^cap points).
    global_entry_cap: int = 0
    # (A probe_filter_kernel flag lived here through round 3: a fused
    # Pallas window-filter kernel, bit-identical and default-off. Removed
    # in round 4 with its measured negative result — see PERFORMANCE.md
    # "Fused probe kernel: the measured dead end".)
    # Precompute the global engine's whole block-stream mapping
    # (position -> table/block/lane-mask) once per query batch instead of
    # re-deriving it per loop iteration (ops/prefixmap.stream_block_map).
    # Amortized measurement put the per-iteration bookkeeping at 8.5 of
    # 14.4 ms/iter (scripts/exp_probe_budget.py, round 3); the maps turn
    # it into three (Q, WB) row gathers. Bit-identical results; costs
    # 3 * Q * tb_pad * 4 bytes of HBM per batch (tens of MB). Applies to
    # global_search / global_search_continuous; shard_map callers keep the
    # in-loop derivation (no host sync inside a mesh program).
    stream_map: bool = True
    # Map length cap in gather blocks. The FULL stream extent is the
    # exhaustion bound (~n*L/gather_block positions — gigabytes of maps at
    # bench scale), while the failure-prob stop consumes a short prefix;
    # iterations whose live cursors overrun the cap fall back to the
    # in-loop derivation (bit-identical, lax.cond-selected). 65536 blocks
    # = ~200MB of maps at the production batch (Q=256, G=16) and covers
    # ~1M candidate slots per query.
    stream_map_blocks: int = 65536
    # Route dead blocks' gathers (done queries' lanes and fully-masked
    # edge blocks) to table-0/block-0, which stays cache-resident: the
    # batch loop runs to its slowest query, so late iterations gather
    # mostly for dead lanes, and random gathers at ~45ns/lane dominate
    # the 1.18M-scale body. Bit-identical — `valid` masks every consumer
    # of routed record data (pinned by tests/test_stream_map.py's
    # routing A/B). Off only for A/B measurement.
    dead_block_routing: bool = True
    # Window range-index computation: False = scatter+cumsum
    # (O(M + W) work but rides XLA's serialized scatter lowering), True =
    # dense compare-and-sum (O(W*M) compares that fuse into one reduction
    # pass). Bit-identical (same count_leq quantity); measured knob.
    window_index_dense: bool = False
    # In-loop candidate scoring dtype for the adaptive LSH engines.
    # "float32" (default): score in f32 directly. "int8": score candidates
    # against an int8 shadow of the dataset with a 2k internal buffer and
    # exactly re-score the final top-k in f32 — the TPU analog of the
    # reference's Q15 i16 ranking + f32 re-scoring split (math.hpp:11-34,
    # index.rs:400-416). Measured on v5e at 200k x 100 the f32 path is ~5%
    # FASTER (row gathers do not get cheaper below ~400B and the deeper
    # buffer costs merge work), so int8 is a memory knob (4x smaller score
    # rows), not a speed knob; recall is within ~1pp either way.
    rescore_dtype: str = "float32"
    # --- dense (IVF) probing mode (no reference counterpart; the TPU-native
    # fast path: probed clusters are scanned with one batched MXU matmul
    # instead of per-candidate LSH gathers, see ops/ivf.py) ---
    # Build the padded per-cluster dense layout alongside the LSH tables.
    dense_layout: bool = True
    # Max points per dense segment row; clusters larger than this are split
    # into multiple rows (bounds padding waste on ragged clusters).
    dense_seg_cap: int = 4096
    # "lsh" = reference-faithful adaptive LSH; "dense" = IVF probing;
    # "auto" = dense when the layout exists, else lsh.
    search_mode: str = "auto"
    # Number of clusters probed per query in dense mode; 0 = heuristic
    # (enough clusters to cover ~n_probe_frac of expected mass).
    n_probe: int = 0
    # Per-cluster query-slot capacity in the inverted probe layout;
    # 0 = heuristic. Overflowing probes are dropped (counted in stats).
    probe_cap: int = 0
    # PRNG seed for hash function sampling. The reference uses a global
    # clock-seeded RNG (typedefs.hpp:17-22) making builds non-reproducible;
    # we deliberately diverge with explicit seeding (documented in SURVEY §7).
    seed: int = 0

    _REFERENCE_FIELDS = (
        "num_tables",
        "num_clusters_factor",
        "k",
        "delta",
        "dataset_name",
        "metrics_output",
    )

    def __post_init__(self) -> None:
        from clann_tpu_torch.errors import ConfigError

        if self.num_tables < 1:
            raise ConfigError("num_tables must be >= 1")
        if self.k < 1:
            raise ConfigError("k must be >= 1")
        if not (0.0 < self.delta < 1.0):
            raise ConfigError("delta must be in (0, 1)")
        if self.num_clusters_factor <= 0.0:
            raise ConfigError("num_clusters_factor must be > 0")
        if self.lsh_engine not in ("clustered", "global", "both"):
            raise ConfigError(
                "lsh_engine must be 'clustered', 'global', or 'both'"
            )
        if self.gather_block < 1 or (
            self.gather_block & (self.gather_block - 1)
        ):
            raise ConfigError("gather_block must be a power of two >= 1")
        if self.rescore_dtype not in ("float32", "int8"):
            raise ConfigError("rescore_dtype must be 'float32' or 'int8'")
        if self.lsh_group_ranks < 1:
            raise ConfigError("lsh_group_ranks must be >= 1")
        if self.lsh_level_chunk < 0:
            raise ConfigError("lsh_level_chunk must be >= 0")
        if isinstance(self.metrics_output, str):
            object.__setattr__(self, "metrics_output", MetricsOutput(self.metrics_output))

    # -- JSON round-trip (reference: config.rs serde derive + tests at
    #    config.rs:70-169 assert default/round-trip behaviour) --

    def to_dict(self, reference_only: bool = False) -> dict:
        d: dict[str, Any] = {}
        for f in dataclasses.fields(self):
            if reference_only and f.name not in self._REFERENCE_FIELDS:
                continue
            v = getattr(self, f.name)
            if isinstance(v, enum.Enum):
                v = v.value
            d[f.name] = v
        return d

    def to_json(self, reference_only: bool = False) -> str:
        return json.dumps(self.to_dict(reference_only=reference_only))

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        known = {f.name for f in dataclasses.fields(cls)}
        kwargs = {k: v for k, v in d.items() if k in known}
        return cls(**kwargs)

    @classmethod
    def from_json(cls, s: str) -> "Config":
        return cls.from_dict(json.loads(s))

    @classmethod
    def from_file(cls, path: str) -> "Config":
        with open(path, "r") as f:
            return cls.from_json(f.read())

    def num_clusters(self, num_points: int) -> int:
        """k = max(1, floor(factor * sqrt(n))) (reference: index.rs:78-80)."""
        import math

        return max(1, int(self.num_clusters_factor * math.sqrt(num_points)))

    def replace(self, **kwargs) -> "Config":
        return dataclasses.replace(self, **kwargs)
