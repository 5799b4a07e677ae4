"""SQLite result-database schema (copy of ``clann_tpu.metrics.schema``).

The reference schema (reference: result_schema.sql:1-122): the same seven
tables, column names, primary keys and CHECK constraints, so analysis
tooling written against a reference results DB reads ours unchanged.
`puffinn_results{,_query}` hold the single-index (C=1) baseline
runs used for clustered-vs-flat comparisons
(reference: benches/distance_benches.rs:93-203).
"""

SCHEMA = """
CREATE TABLE IF NOT EXISTS build_metrics (
    num_clusters INTEGER NOT NULL,
    num_tables INTEGER NOT NULL,
    dataset TEXT NOT NULL,
    git_commit_hash CHAR(40) DEFAULT 'NO_COMMIT' NOT NULL,
    dataset_len INTEGER,
    total_num_clusters INTEGER NOT NULL DEFAULT 0,
    greedy_num_clusters INTEGER NOT NULL DEFAULT 0,
    memory_used_bytes INTEGER,
    build_time_s INTEGER,
    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
    PRIMARY KEY (num_clusters, num_tables, dataset, git_commit_hash),
    CONSTRAINT positive_clusters CHECK (num_clusters > 0),
    CONSTRAINT positive_L CHECK (num_tables > 0)
);

CREATE TABLE IF NOT EXISTS build_metrics_cluster (
    num_clusters INTEGER NOT NULL,
    num_tables INTEGER NOT NULL,
    dataset TEXT NOT NULL,
    git_commit_hash CHAR(40) DEFAULT 'NO_COMMIT' NOT NULL,
    cluster_idx INTEGER NOT NULL,
    center_idx INTEGER,
    greedy_flag INTEGER,
    radius REAL,
    num_points INTEGER,
    memory_used_bytes INTEGER,
    PRIMARY KEY (num_clusters, num_tables, dataset, git_commit_hash, cluster_idx),
    FOREIGN KEY (num_clusters, num_tables, dataset, git_commit_hash)
        REFERENCES build_metrics(num_clusters, num_tables, dataset, git_commit_hash)
        ON DELETE CASCADE
);

CREATE TABLE IF NOT EXISTS search_metrics (
    num_clusters INTEGER NOT NULL,
    num_tables INTEGER NOT NULL,
    k INTEGER NOT NULL,
    delta REAL NOT NULL,
    dataset TEXT NOT NULL,
    git_commit_hash CHAR(40) DEFAULT 'NO_COMMIT' NOT NULL,
    search_time_ms INTEGER,
    queries_per_second REAL,
    recall_mean REAL,
    recall_std REAL,
    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
    PRIMARY KEY (num_clusters, num_tables, k, delta, dataset, git_commit_hash),
    FOREIGN KEY (num_clusters, num_tables, dataset, git_commit_hash)
        REFERENCES build_metrics(num_clusters, num_tables, dataset, git_commit_hash)
        ON DELETE CASCADE,
    CONSTRAINT valid_recall CHECK (recall_mean >= 0 AND recall_mean <= 1),
    CONSTRAINT valid_recall_std CHECK (recall_std >= 0),
    CONSTRAINT positive_clusters CHECK (num_clusters > 0),
    CONSTRAINT positive_k CHECK (k > 0),
    CONSTRAINT positive_L CHECK (num_tables > 0)
);

CREATE TABLE IF NOT EXISTS search_metrics_query (
    num_clusters INTEGER NOT NULL,
    num_tables INTEGER NOT NULL,
    k INTEGER NOT NULL,
    delta REAL NOT NULL,
    dataset TEXT NOT NULL,
    git_commit_hash CHAR(40) NOT NULL,
    query_idx INTEGER NOT NULL,
    query_time_ms INTEGER,
    distance_computations INTEGER,
    PRIMARY KEY (num_clusters, num_tables, k, delta, dataset, git_commit_hash, query_idx),
    FOREIGN KEY (num_clusters, num_tables, k, delta, dataset, git_commit_hash)
        REFERENCES search_metrics(num_clusters, num_tables, k, delta, dataset, git_commit_hash)
        ON DELETE CASCADE,
    CONSTRAINT positive_time CHECK (query_time_ms >= 0),
    CONSTRAINT positive_computations CHECK (distance_computations >= 0)
);

CREATE TABLE IF NOT EXISTS search_metrics_cluster (
    num_clusters INTEGER NOT NULL,
    num_tables INTEGER NOT NULL,
    k INTEGER NOT NULL,
    delta REAL NOT NULL,
    dataset TEXT NOT NULL,
    git_commit_hash CHAR(40) NOT NULL,
    query_idx INTEGER NOT NULL,
    cluster_idx INTEGER NOT NULL,
    n_candidates INTEGER,
    cluster_time_ms INTEGER,
    cluster_distance_computations INTEGER,
    PRIMARY KEY (num_clusters, num_tables, k, delta, dataset, git_commit_hash,
                 query_idx, cluster_idx),
    FOREIGN KEY (num_clusters, num_tables, k, delta, dataset, git_commit_hash, query_idx)
        REFERENCES search_metrics_query(num_clusters, num_tables, k, delta, dataset,
                                        git_commit_hash, query_idx)
        ON DELETE CASCADE,
    CONSTRAINT positive_candidates CHECK (n_candidates >= 0),
    CONSTRAINT positive_cluster_time CHECK (cluster_time_ms >= 0),
    CONSTRAINT positive_cluster_computations CHECK (cluster_distance_computations >= 0)
);

CREATE TABLE IF NOT EXISTS puffinn_results (
    num_tables INTEGER NOT NULL,
    k INTEGER NOT NULL,
    delta REAL NOT NULL,
    dataset TEXT NOT NULL,
    dataset_len INTEGER,
    memory_used_bytes INTEGER,
    total_time_ms INTEGER,
    queries_per_second REAL,
    recall_mean REAL,
    recall_std REAL,
    created_at TIMESTAMP DEFAULT CURRENT_TIMESTAMP,
    PRIMARY KEY (num_tables, k, delta, dataset),
    CONSTRAINT valid_recall CHECK (recall_mean >= 0 AND recall_mean <= 1),
    CONSTRAINT valid_recall_std CHECK (recall_std >= 0)
);

CREATE TABLE IF NOT EXISTS puffinn_results_query (
    num_tables INTEGER NOT NULL,
    k INTEGER NOT NULL,
    delta REAL NOT NULL,
    dataset TEXT NOT NULL,
    query_idx INTEGER NOT NULL,
    query_time_ms INTEGER,
    distance_computations INTEGER,
    PRIMARY KEY (num_tables, k, delta, dataset, query_idx),
    FOREIGN KEY (num_tables, k, delta, dataset)
        REFERENCES puffinn_results(num_tables, k, delta, dataset)
        ON DELETE CASCADE,
    CONSTRAINT positive_time CHECK (query_time_ms >= 0),
    CONSTRAINT positive_computations CHECK (distance_computations >= 0)
);

-- ADDITIVE table (not in the reference schema; reference tooling ignores
-- unknown tables): labels how a run's per-query query_time_ms rows were
-- produced. The reference times each query's sequential search
-- (sqlite.rs:199), so its rows are true latencies; batch execution on an
-- accelerator has no per-query wall time, so rows from batched runs are
-- the batch wall-clock divided evenly ('batched-amortized') — only runs
-- whose every ingest had one query carry 'single-query' (a true latency).
CREATE TABLE IF NOT EXISTS clann_timing_mode (
    num_clusters INTEGER NOT NULL,
    num_tables INTEGER NOT NULL,
    k INTEGER NOT NULL,
    delta REAL NOT NULL,
    dataset TEXT NOT NULL,
    git_commit_hash CHAR(40) NOT NULL,
    timing_mode TEXT NOT NULL
        CHECK (timing_mode IN ('batched-amortized', 'single-query')),
    PRIMARY KEY (num_clusters, num_tables, k, delta, dataset,
                 git_commit_hash)
);
"""


def create_schema(conn) -> None:
    conn.executescript(SCHEMA)
    conn.commit()
