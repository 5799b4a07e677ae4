"""The harness's run with the timed path broken underneath: `correct`
has to come out false for each fault a cell can have, and true for the
program as it is. The look for a card is skipped; everything else of a
run happens, at a size the CPU holds."""

import numpy as np
import pytest

from benchmark import spec
from benchmark.tests.tiny import run_tiny, tiny_cell

CELLS = ["glove100-lsh.global-b256", "glove100-ivf.auto-b2048", "glove100-lsh.scan-b10000"]


def _stale():
    """Every batch after the first gets the previous batch's answer."""
    def wrap(search, *_):
        last = []

        def broken(q):
            out = search(q)
            prev = last[0] if last else out
            last[:] = [out]
            return prev
        return broken
    return wrap


def _half():
    """The second half of every batch left unanswered."""
    def wrap(search, *_):
        def broken(q):
            d, i, st = search(q[: len(q) // 2])
            return d, i, st
        return broken
    return wrap


def _altered():
    """One returned id altered where it is produced (its distance kept)."""
    def wrap(search, train, _pool):
        def broken(q):
            d, i, st = search(q)
            i = i.copy()
            i[0, 0] = (i[0, 0] + 1) % len(train)
            return d, i, st
        return broken
    return wrap


def _shuffled():
    """Each query handed the next query's ids."""
    def wrap(search, *_):
        def broken(q):
            d, i, st = search(q)
            return d, np.roll(i, 1, axis=0), st
        return broken
    return wrap


def _wrong_distances():
    """The right ids beside distances that are off by 0.01."""
    def wrap(search, *_):
        def broken(q):
            d, i, st = search(q)
            return d + 0.01, i, st
        return broken
    return wrap


def _far():
    """The k farthest rows of the collection, with their true distances, in
    order: well formed, every distance right, and no neighbour found."""
    def wrap(search, train, _pool):
        xn = train / np.linalg.norm(train, axis=1, keepdims=True)

        def broken(q):
            d, i, st = search(q)
            qn = q / np.linalg.norm(q, axis=1, keepdims=True)
            dist = 1.0 - qn.astype(np.float64) @ xn.T.astype(np.float64)
            far = np.argsort(-dist, axis=1)[:, : i.shape[1]]
            far_d = np.take_along_axis(dist, far, 1)
            o = np.argsort(far_d, axis=1)
            return (np.take_along_axis(far_d, o, 1).astype(d.dtype),
                    np.take_along_axis(far, o, 1).astype(i.dtype), st)
        return broken
    return wrap


FAULTS = {"stale": _stale, "half": _half, "altered": _altered, "shuffled": _shuffled,
          "wrong_distances": _wrong_distances, "far": _far}


@pytest.mark.parametrize("name", CELLS)
def test_the_program_as_it_is_is_correct(name):
    _, line = run_tiny(tiny_cell(name))
    assert line["correct"], line["checks"]
    assert line["failed"] == 0
    assert line["checks"]["dist_err"]["value"] < 1e-5


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_planted_fault_is_not_correct(name, fault):
    _, line = run_tiny(tiny_cell(name), wrap=FAULTS[fault]())
    assert not line["correct"], (fault, line["checks"])


@pytest.mark.parametrize("name", CELLS)
def test_far_rows_with_their_true_distances_fail_on_recall_alone(name):
    """Every cell holds its recall to a floor: an answer that is well formed
    and whose distances are right fails there and nowhere else."""
    _, line = run_tiny(tiny_cell(name), wrap=_far())
    checks = line["checks"]
    assert checks["recall"]["value"] < checks["recall"]["at_least"], checks
    assert checks["dist_err"]["value"] <= checks["dist_err"]["at_most"], checks
    assert checks["bad_rows"]["value"] == 0, checks


def test_the_exchange_between_cards_left_out_is_not_correct(monkeypatch):
    """Four CPU shards; the merge keeps shard 0's answers alone. The cell's
    files are measured and kept, though BENCHMARK.json does not run it yet."""
    import torch

    from clann_tpu_torch.parallel import sharded

    cell = spec.cell_from_files("deep96-20m.global-b256", "deep96-20m", "global-b256-pool2k",
                                4, [], [])
    cell.config = {**cell.config, "rows": 6000}
    cell.traffic = {**cell.traffic, "batch": 32, "pool": 64}
    _, good = run_tiny(cell)
    assert good["correct"], good["checks"]

    def first_shard_only(mesh, sims, ids, lead, k):
        return sims[0].to(lead), ids[0].to(lead)

    monkeypatch.setattr(sharded, "_merge_topk", first_shard_only)
    _, line = run_tiny(cell, devices=[torch.device("cpu")] * 4)
    assert not line["correct"], line["checks"]
    assert line["checks"]["recall"]["value"] < line["checks"]["recall"]["at_least"]
