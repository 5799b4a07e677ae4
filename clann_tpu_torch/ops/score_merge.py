"""The global δ engine's score-and-merge (PyTorch wrapper of ``csrc/score_merge.cu``).

One loop iteration of the cosine global engine (ops/global_query.py)
scores the window filter's compacted candidate ids of every query and
merges them into the query's running top-kk. `score_merge` computes it:

- vectors (n, d) float32 with queries (Q, d) float32 (the normalized
  queries), or the int8 shadows `vectors_q8` with the int8 queries
  (rescore_dtype "int8", kk = 2k);
- topk_sims (Q, kk) float32 and topk_ids (Q, kk) int32: the running top-kk
  (-1 ids, sim 0 in the empty slots; sims >= -1);
- compact_ids (Q, CB) int32: the window filter's ids, each in [0,
  n_sentinel) or a sentinel (>= n_sentinel), anywhere in the row.

A candidate is scored as `ops.query.score_rows` scores it (row clamp(id,
0, n - 1)). Duplicate ids count once, an id already in the top-kk and a
sentinel are dropped, and the new top-kk is the best kk of [the old
entries, the surviving candidates] by sim descending, an old entry before
a candidate among equal sims (an empty slot beats a candidate of sim 0),
old entries in position order and candidates by ascending id. Returns
(sims (Q, kk) clamped at >= 0, ids (Q, kk) int32, -1 where the selected
sim is < 0), new tensors: the inputs are left as they are. That is the
order of `ops.query._merge_topk`'s stable sort.

For CPU tensors `score_merge` runs `score_merge_plain`, the engine's
former chain (`score_rows` over every slot, then `_merge_topk`); for CUDA
tensors it launches the kernel, one CTA a query, which reads only the rows
of distinct live candidates, and raises on what the kernel does not take.
The int8 sims are the plain version's bit for bit; the f32 dots differ
from cuBLAS's only by the order of the f32 sums. The kernel takes no
negative id (the window filter writes none; the plain version would score
one as row 0).
"""

from __future__ import annotations

import collections

import torch

from clann_tpu_torch.ops import _build
from clann_tpu_torch.ops.gather import _launcher, _stream
from clann_tpu_torch.ops.query import _merge_topk, score_rows

# Launches of the kernel, in all and by card index: made by the wrapper,
# or replayed from a captured CUDA graph (a launch the wrapper records into
# a graph counts at each replay, `count_launches`). The plain version never
# counts.
SCORE_LAUNCHES = 0
SCORE_DEVICE_LAUNCHES: collections.Counter = collections.Counter()

MAX_SHARED = 227 * 1024  # a CTA's shared memory on an H100


def reset_launches() -> None:
    global SCORE_LAUNCHES
    SCORE_LAUNCHES = 0
    SCORE_DEVICE_LAUNCHES.clear()


def count_launches(device: int, n: int, loop_stats=None) -> None:
    """Count `n` launches of the kernel on card `device`, also into
    `loop_stats.score_launches` where given."""
    global SCORE_LAUNCHES
    with _build.COUNT_LOCK:
        SCORE_LAUNCHES += n
        SCORE_DEVICE_LAUNCHES[device] += n
    if loop_stats is not None:
        loop_stats.score_launches += n


def score_merge_plain(vectors, queries, topk_sims, topk_ids, compact_ids, *, n_sentinel: int,
                      loop_stats=None):
    """The score-and-merge in plain PyTorch: the global engine's former
    /score phase, every slot scored (sentinels as row n - 1), then
    `_merge_topk`. It launches nothing, so `loop_stats` is left as it is."""
    safe = torch.clamp(compact_ids, 0, vectors.shape[0] - 1)
    sims = score_rows(vectors, queries, safe)
    return _merge_topk(topk_sims, topk_ids, compact_ids, sims, n_sentinel=n_sentinel)


def _check(vectors, queries, topk_sims, topk_ids, compact_ids):
    if vectors.dim() != 2 or vectors.dtype not in (torch.float32, torch.int8) or 0 in vectors.shape:
        raise ValueError(f"vectors must be a non-empty (n, d) float32 or int8 tensor, got "
                         f"{vectors.dtype} {tuple(vectors.shape)}")
    d = vectors.shape[1]
    Q = queries.shape[0] if queries.dim() == 2 else -1
    if queries.dtype != vectors.dtype or queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be (Q, {d}) {vectors.dtype}, got {queries.dtype} "
                         f"{tuple(queries.shape)}")
    for name, t, dtype in (("topk_sims", topk_sims, torch.float32),
                           ("topk_ids", topk_ids, torch.int32),
                           ("compact_ids", compact_ids, torch.int32)):
        if t.dtype != dtype or t.dim() != 2 or t.shape[0] != Q:
            raise ValueError(f"{name} must be ({Q}, *) {dtype}, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if topk_ids.shape != topk_sims.shape or topk_sims.shape[1] < 1:
        raise ValueError(f"topk_sims {tuple(topk_sims.shape)} and topk_ids "
                         f"{tuple(topk_ids.shape)} must be one (Q, kk >= 1) shape")
    for t in (queries, topk_sims, topk_ids, compact_ids):
        if t.device != vectors.device:
            raise ValueError(f"every operand must be on {vectors.device}, got {t.device}")


def _hash_log(kk: int, cb: int) -> int:
    """log2 of the kernel's id table: a power of two of at least 2 (kk + cb)
    slots, so a probe always ends at an empty slot."""
    return max(1, (2 * (kk + cb) - 1).bit_length())


def _shared_bytes(d: int, elem: int, kk: int, cb: int) -> int:
    """csrc/score_merge.cu's dynamic shared memory: the query (rounded to 16
    bytes), a 64-bit key an entry, the id table, the owned ids and the old
    ids."""
    return -(-d * elem // 16) * 16 + 8 * (kk + cb) + 4 * ((1 << _hash_log(kk, cb)) + cb + kk)


def score_merge(vectors, queries, topk_sims, topk_ids, compact_ids, *, n_sentinel: int,
                loop_stats=None):
    """(sims, ids) of the merged top-kk (see the module docstring). A launch
    of the kernel counts one in `loop_stats.score_launches` (a LoopStats of
    the calling loop, where given) and in the module's counts; a launch
    recorded into a CUDA graph counts in `loop_stats` alone, and each
    replay of the graph counts it (`count_launches`)."""
    _check(vectors, queries, topk_sims, topk_ids, compact_ids)
    if vectors.device.type == "cpu":
        return score_merge_plain(vectors, queries, topk_sims, topk_ids, compact_ids,
                                 n_sentinel=n_sentinel, loop_stats=loop_stats)
    operands = (vectors, queries, topk_sims, topk_ids, compact_ids)
    if not all(t.is_contiguous() for t in operands):
        raise ValueError("the score-and-merge's operands must be contiguous")
    (n, d), (Q, kk), cb = vectors.shape, topk_sims.shape, compact_ids.shape[1]
    int8 = vectors.dtype == torch.int8
    smem = _shared_bytes(d, 1 if int8 else 4, kk, cb)
    if smem > MAX_SHARED:
        raise ValueError(f"d {d}, kk {kk} and {cb} candidate slots need {smem} B of shared "
                         f"memory, over {MAX_SHARED}")
    sims = torch.empty_like(topk_sims)
    ids = torch.empty_like(topk_ids)
    if Q:
        fn = _launcher("clann_score_merge", vectors)
        dev = vectors.get_device()
        code = fn(vectors.data_ptr(), n, d, int(int8), queries.data_ptr(), topk_sims.data_ptr(),
                  topk_ids.data_ptr(), compact_ids.data_ptr(), cb, kk, n_sentinel,
                  _hash_log(kk, cb), sims.data_ptr(), ids.data_ptr(), Q, smem, dev, _stream(dev))
        if code:
            _build.check(_build.load_library(), code, "score-and-merge launch")
        if torch.cuda.is_current_stream_capturing():
            # recorded into a graph: each replay counts it
            if loop_stats is not None:
                loop_stats.score_launches += 1
        else:
            count_launches(dev, 1, loop_stats)
    return sims, ids
