"""Table-sharded closest-pairs self-join over a device mesh (PyTorch port
of ``clann_tpu.parallel.join``).

The reference's `closest_pairs` splits the hash tables over OpenMP threads,
each keeping a MaxPairBuffer, then merges them (libpuffinn
collection.hpp:415-441,479-481). Here the tables are split across the
shards of a mesh: each shard runs the windowed adjacency join
(ops/join.table_pairs) over its own tables, the per-shard winner lists are
gathered, and one canonical-key dedup + top-k (ops/join.dedup_topk_pairs)
picks the pairs. The adaptive window sweep (ops/join.window_sweep) drives
the sharded evaluation exactly as it drives the single-device one.

Tables are padded to a multiple of the shard count; pad tables emit
sentinel pairs (lo = hi = n, beyond any canonical lo < hi < n pair) with
sims -1, so they can never shadow a real pair in the dedup.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from clann_tpu_torch.parallel.mesh import all_gather, make_mesh, run_shards


def _sharded_window_pairs(mesh, vec_parts, idx_parts, valid_parts, *, k: int, window: int,
                          lead):
    """One window size over the mesh: per-shard table joins + global dedup.
    vec_parts / idx_parts / valid_parts: each shard's copy of the (n, d)
    vectors, (Lp / D, n) sorted orders and (Lp / D,) real-table flags.
    Returns (sims desc (k,), pairs (k, 2))."""
    from clann_tpu_torch.ops.join import dedup_topk_pairs, table_pairs

    def shard(s):  # the cards at once (mesh.run_shards)
        n = vec_parts[s].shape[0]
        sims, lo, hi = table_pairs(vec_parts[s], idx_parts[s], k=k, window=window)
        mask = valid_parts[s][:, None]
        return torch.where(mask, sims, -1.0), torch.where(mask, lo, n), torch.where(mask, hi, n)

    parts = run_shards([None if p is None else dev
                        for p, dev in zip(idx_parts, mesh.cluster_devices())], shard)
    sims_p, lo_p, hi_p = zip(*(p or (None, None, None) for p in parts))
    # the (Lp, kk) winner lists are small; one dedup + top-k on `lead`
    return dedup_topk_pairs(all_gather(mesh, sims_p, lead).reshape(-1),
                            all_gather(mesh, lo_p, lead).reshape(-1),
                            all_gather(mesh, hi_p, lead).reshape(-1), k=k)


def sharded_closest_pairs(
    index,
    k: int,
    delta: float = 0.9,
    max_window: int = 64,
    mesh=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """k most similar pairs, hash tables sharded across the mesh.

    The contract of ops/join.closest_pairs (numpy pairs (k, 2) int32 with
    i < j, sims (k,) descending) and, window for window, the same candidate
    set: sharding only moves which shard scores which table, so the result
    equals the single-device join's. `index` is a single-device LSH index;
    its vectors are copied to every shard device (the join gathers
    arbitrary ids), its per-table sorted orders are split.
    """
    from clann_tpu_torch.ops.join import window_sweep

    if mesh is None:
        mesh = make_mesh()
    devs = mesh.cluster_devices()
    n_dev = len(devs)
    lead = devs[0]

    sorted_idx = index.sorted_idx.cpu().numpy()
    L, n = sorted_idx.shape
    Lp = -(-L // n_dev) * n_dev
    if Lp > L:
        # pad with copies of table 0; masked to sentinels per shard
        sorted_idx = np.concatenate([sorted_idx, np.tile(sorted_idx[:1], (Lp - L, 1))], axis=0)
    valid = np.arange(Lp) < L
    per = Lp // n_dev
    vec_parts, idx_parts, valid_parts = [], [], []
    copies = {}  # one copy of the vectors per shard device, made once
    for s, dev in enumerate(devs):
        if not mesh.is_local(s):
            vec_parts.append(None)
            idx_parts.append(None)
            valid_parts.append(None)
            continue
        if dev not in copies:
            copies[dev] = index.vectors.to(dev)
        vec_parts.append(copies[dev])
        idx_parts.append(torch.as_tensor(sorted_idx[s * per:(s + 1) * per], device=dev))
        valid_parts.append(torch.as_tensor(valid[s * per:(s + 1) * per], device=dev))

    def run(window):
        sims, pairs = _sharded_window_pairs(mesh, vec_parts, idx_parts, valid_parts,
                                            k=k, window=window, lead=lead)
        return sims.cpu().numpy(), pairs.cpu().numpy()

    return window_sweep(
        run,
        n=n,
        num_tables=L,
        max_hashbits=index.config.max_hashbits,
        probs_table=index.probs_table.cpu().numpy(),
        sim_eps=index.sim_eps,
        k=k,
        delta=delta,
        max_window=max_window,
    )
