"""The score-and-merge (ops/score_merge.py) on the CPU: its plain version
against the global engine's former /score phase (`_score_candidates`, then
`_merge_topk`), on seeded cases made as the engine makes them
(testing.score_merge_case): duplicates, ids already in the top-k,
sentinels anywhere, done queries, full rows, sims of exactly 0 against
empty slots, equal sims on distinct ids. Every output must be equal bit
for bit.

The kernel itself runs on the card only: `test_kernel_matches_plain_on_card`
(marked `card`) holds it to the plain version there and skips elsewhere.
The card machine has no jax, so it runs without tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_score_merge.py
"""

import types

import pytest
import torch

from clann_tpu_torch.metrics.trace import LoopStats
from clann_tpu_torch.ops import score_merge as tsm
from clann_tpu_torch.ops.query import _merge_topk, _score_candidates, score_rows
from clann_tpu_torch.testing import SCORE_MERGE_CASES as CASES
from clann_tpu_torch.testing import SCORE_MERGE_SHAPE as SHAPE
from clann_tpu_torch.testing import assert_topk_match, run_score_merge, score_merge_case

DTYPES = {"f32": (False, 10), "int8": (True, 20)}  # (int8 rows, kk)


def _case(name, dtype, device="cpu", **shape):
    int8, kk = DTYPES[dtype]
    return score_merge_case(case=name, int8=int8, kk=kk, seed=CASES.index(name),
                            device=device, **(shape or SHAPE))


def former_chain(c):
    """The loop body's /score phase as it was: every slot scored through
    `_score_candidates` (the index's f32 vectors or int8 shadows), then
    `_merge_topk`."""
    int8 = c["vectors"].dtype == torch.int8
    index = types.SimpleNamespace(vectors=None if int8 else c["vectors"],
                                  vectors_q8=c["vectors"] if int8 else None)
    n = c["vectors"].shape[0]
    sims = _score_candidates(index, None if int8 else c["queries"],
                             c["queries"] if int8 else None,
                             torch.clamp(c["compact_ids"], 0, n - 1))
    return _merge_topk(c["topk_sims"], c["topk_ids"], c["compact_ids"], sims,
                       n_sentinel=c["n_sentinel"])


def _forced(name, c, got):
    """What each case is there to force, on the merged top-kk."""
    c = {k: v.cpu() if torch.is_tensor(v) else v for k, v in c.items()}
    sims, ids = (t.cpu() for t in got)
    old_ids, cand, n = c["topk_ids"], c["compact_ids"], c["n_sentinel"]
    zero_rows = torch.arange(n - 4 * sims.shape[0], n)
    for q in range(sims.shape[0]):
        real = ids[q][ids[q] >= 0]
        assert len(real.unique()) == len(real)  # no id twice
    assert torch.all(sims[:, :-1] >= sims[:, 1:])  # descending
    if name == "all_sentinel":  # the old entries as they were
        assert torch.equal(sims, c["topk_sims"]) and torch.equal(ids, old_ids)
    if name in ("sim_zero", "empty_topk"):  # sim 0 loses to an empty slot
        assert bool((score_rows(c["vectors"], c["queries"].repeat_interleave(4, dim=0),
                                zero_rows[:, None]) == 0).all())
        assert not torch.isin(ids, zero_rows.to(torch.int32)).any()
        assert torch.all((ids >= 0) | (sims == 0))
    if name == "in_topk":
        assert torch.isin(cand, old_ids).any()
    if name == "full_row":
        assert bool((cand < n).all())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_plain_equals_former_chain(name, dtype):
    c = _case(name, dtype)
    before, ls = tsm.SCORE_LAUNCHES, LoopStats()
    got = run_score_merge(tsm.score_merge, c, loop_stats=ls)
    # CPU tensors: the plain version, no launch, none counted
    assert tsm.SCORE_LAUNCHES == before and ls == LoopStats()
    want = former_chain(c)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    _forced(name, c, got)


def test_score_merge_refuses_what_it_does_not_take():
    c = _case("random", "f32")
    args = [c["vectors"], c["queries"], c["topk_sims"], c["topk_ids"], c["compact_ids"]]
    kw = dict(n_sentinel=c["n_sentinel"])
    tsm.score_merge(*args, **kw)
    q8 = _case("random", "int8")
    for i, bad in ((0, c["vectors"][:, :1].reshape(-1)), (0, c["vectors"].to(torch.float64)),
                   (1, q8["queries"]), (1, c["queries"][:, :5]),
                   (2, c["topk_sims"][:3]), (3, c["topk_ids"].to(torch.int64)),
                   (3, c["topk_ids"][:, :4]), (4, c["compact_ids"].to(torch.int64)),
                   (4, c["compact_ids"][:5])):
        with pytest.raises(ValueError):
            tsm.score_merge(*args[:i], bad, *args[i + 1:], **kw)
    with pytest.raises(ValueError):  # an empty top-k
        tsm.score_merge(*args[:2], c["topk_sims"][:, :0], c["topk_ids"][:, :0], args[4], **kw)


def test_shared_memory_and_table_sizes():
    # the engine cells' shape: d 100 / 96, kk 10 / 20, CB 2,080
    assert tsm._hash_log(10, 2080) == 13 and 1 << 13 >= 2 * 2090
    assert tsm._shared_bytes(100, 4, 10, 2080) == 400 + 8 * 2090 + 4 * (8192 + 2080 + 10)
    assert tsm._shared_bytes(96, 1, 20, 2080) == 96 + 8 * 2100 + 4 * (8192 + 2080 + 20)
    for kk, cb in ((1, 0), (1, 1), (10, 2080), (64, 4096)):
        assert 1 << tsm._hash_log(kk, cb) >= 2 * (kk + cb)
        assert 1 << (tsm._hash_log(kk, cb) - 1) < max(2, 2 * (kk + cb))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the score-and-merge's kernel runs on the card only")
    return torch.device("cuda")


def assert_matches_plain(got, want, *, exact: bool, tol: float = 2e-6):
    """The kernel's (sims, ids) against its plain version's: equal bit for
    bit where `exact` (int8); else sims within `tol` slot by slot (f32 sums
    in another order) and the id sets equal except for ids whose sim ties
    the k-th within `tol` (testing.assert_topk_match)."""
    (gs, gi), (ws, wi) = got, want
    if exact:
        assert torch.equal(gs, ws) and torch.equal(gi, wi)
        return
    assert_topk_match(gi.cpu().numpy(), gs.cpu().numpy(), wi.cpu().numpy(), ws.cpu().numpy(),
                      atol=tol, tie_eps=0.0)


@pytest.mark.card
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name", CASES)
def test_kernel_matches_plain_on_card(card, name, dtype):
    """The kernel against its plain version on the same CUDA tensors, at
    each case, d 96 and 100 and the engine's CB (2,080), then at the
    tests' CPU shape (d 13: a row of scalar units); int8 bit for bit, f32
    up to the order of its sums."""
    for shape in (dict(q=64, n=20_000, d=96, cb=2080), dict(q=64, n=20_000, d=100, cb=2080),
                  SHAPE):
        c = _case(name, dtype, device=card, **shape)
        before, ls = tsm.SCORE_LAUNCHES, LoopStats()
        got = run_score_merge(tsm.score_merge, c, loop_stats=ls)
        want = run_score_merge(tsm.score_merge_plain, c)
        torch.cuda.synchronize()
        assert tsm.SCORE_LAUNCHES == before + 1 and ls == LoopStats(score_launches=1)
        assert_matches_plain(got, want, exact=dtype == "int8")
        _forced(name, c, got)


@pytest.mark.card
def test_kernel_refuses_what_it_does_not_take_on_card(card):
    c = _case("random", "f32", device=card)
    args = [c["vectors"], c["queries"], c["topk_sims"], c["topk_ids"], c["compact_ids"]]
    kw = dict(n_sentinel=c["n_sentinel"])
    with pytest.raises(ValueError):  # not contiguous
        tsm.score_merge(*args[:4], c["compact_ids"].t().contiguous().t(), **kw)
    with pytest.raises(ValueError):  # past a CTA's shared memory
        big = torch.full((c["compact_ids"].shape[0], 40_000), c["n_sentinel"],
                         dtype=torch.int32, device=card)
        tsm.score_merge(*args[:4], big, **kw)
