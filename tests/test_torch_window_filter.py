"""The window filter (ops/window_filter.py) on the CPU: its plain version
against the global engine's former chain of phases, on seeded random
windows made as the engine makes them (testing.window_filter_case).

The former chain is composed here from the pieces it was made of: the
record window of `_record_window` (core/jaccard.py, the Jaccard
engine's; it derives or maps the window from the streams itself,
unpacked, and gathers the records through K7's plain version), the sketch, ball and
sketch-threshold filters as the loop body wrote them, `_consumer` and
`_compact_take`. Every output is an integer and must be equal.

The kernel itself runs on the card only: `test_kernel_matches_plain_on_card`
(marked `card`) holds it to the plain version there and skips elsewhere.
The card machine has no jax, so it runs without tests/conftest.py:

    python -m pytest --noconftest -m card tests/test_torch_window_filter.py
"""

import pytest
import torch

from clann_tpu_torch.metrics.trace import LoopStats
from clann_tpu_torch.core import jaccard as tj
from clann_tpu_torch.ops import window_filter as twf
from clann_tpu_torch.ops.query import _compact_take
from clann_tpu_torch.ops.sketches import popcount32
from clann_tpu_torch.testing import WINDOW_FILTER_CASES as CASES
from clann_tpu_torch.testing import WINDOW_FILTER_SHAPE as SHAPE
from clann_tpu_torch.testing import run_window_filter, window_filter_case

L = SHAPE["tables"]


def _streams(c):
    s = {"starts": c["starts"], "sizes": c["sizes"], "bstarts": c["bstarts"], "fc": c["fc"]}
    if c["smap"] is not None:
        s["smap"] = c["smap"]
    return s


def former_chain(c, *, use_map, chunk, cap, use_filter, routing):
    """The loop body's fetch, sketch, filter and take phases as they were,
    and the /stop phase's two counts."""
    records, qsk, qdone, off = c["records"], c["qsk"], c["qdone"], c["off"]
    G, wb = 1 << c["g_log"], c["wb"]
    Q, S, Wd = qsk.shape
    C = c["feas_bound"].shape[1]
    WL = wb * G
    fetch = tj._record_window(_streams(c), records, gather_block=G, wb=wb,
                              dense_index=False, routing=routing)
    t_sel, rec, valid = fetch(qdone, off, use_map)
    q_sk = torch.gather(qsk, 1, (t_sel % S).to(torch.int64)[:, :, None].expand(Q, wb, Wd))
    ham = torch.sum(popcount32(rec[..., 1 : 1 + Wd] ^ q_sk[:, :, None, :]),
                    dim=-1, dtype=torch.int32).reshape(Q, WL)
    cand_ids = rec[..., 0].reshape(Q, WL)
    cand_cluster = torch.clamp(rec[..., 1 + Wd].reshape(Q, WL), 0, C - 1)
    ok = c["feas_bound"] <= c["kth_dist"][:, None]
    passes = valid & torch.gather(ok, 1, cand_cluster.to(torch.int64))
    if use_filter:
        passes = passes & (ham <= c["maxdiff"][:, None])
    consumed, in_window = twf._consumer(wb=wb, gather_block=G, chunk=chunk,
                                        device=records.device)(passes)
    take = passes & in_window
    compact_ids = _compact_take(take, cand_ids, cap=cap, n_sentinel=c["n_sentinel"])
    return (compact_ids, consumed, take.sum(dim=1, dtype=torch.int32),
            (valid & in_window).sum(dim=1, dtype=torch.int32))


@pytest.mark.parametrize("name,window", [
    (name, window) for name, spec in CASES.items() for window in ("map", "derived")
    if window == "derived" or spec[1] <= 32])  # the stream map holds blocks of G <= 32
def test_plain_equals_former_chain(name, window):
    case, G, wb, chunk, cap, use_filter, routing, seed = CASES[name]
    c = window_filter_case(gather_block=G, wb=wb, case=case, seed=seed, **SHAPE)
    kw = dict(use_map=window == "map", chunk=chunk, cap=min(cap, wb * G),
              use_filter=use_filter, routing=routing)
    before, ls = twf.FILTER_LAUNCHES, LoopStats()
    got = run_window_filter(twf.window_filter, c, loop_stats=ls, **kw)
    # CPU tensors: the plain version, no launch, none counted
    assert twf.FILTER_LAUNCHES == before and ls == LoopStats()
    want = former_chain(c, **kw)
    for g, w, what in zip(got, want, ("compact_ids", "consumed", "taken", "seen")):
        assert g.dtype == torch.int32 and torch.equal(g, w), what
    compact_ids, consumed, taken, seen = got
    assert compact_ids.shape == (SHAPE["q"], min(cap, wb * G))
    done = c["qdone"]
    assert torch.all(consumed[done] == wb) and torch.all(taken[done] == 0)
    assert torch.all(seen[done] == 0)
    # what each case is there to force
    if case == "all_pass":  # every valid lane is taken, up to chunk or one block
        assert torch.equal(taken, seen) and torch.any(consumed < wb)
        assert torch.all((taken <= chunk) | (consumed == 1))
    if case == "short":
        assert torch.any(consumed == wb)
    if case == "none_pass":
        assert torch.all(consumed == wb) and torch.all(taken == 0)
        assert torch.all(compact_ids == c["n_sentinel"])
    if name.startswith("chunk below G"):
        assert torch.any(consumed == 1) and torch.any(taken > cap)


def test_window_filter_refuses_what_it_does_not_take():
    c = window_filter_case(q=4, tables=L, slots=200, gather_block=8, wb=16, clusters=5)
    args = [c["records"], c["smap"], c["off"], c["qdone"], c["qsk"], c["feas_bound"],
            c["kth_dist"], c["maxdiff"]]
    kw = dict(gather_block=8, wb=16, chunk=32, cap=40, n_sentinel=200, use_filter=True)
    twf.window_filter(*args, **kw)
    for i, bad in ((1, c["smap"][:, :8]), (2, c["off"].to(torch.int64)),
                   (3, c["qdone"].to(torch.int32)), (6, c["kth_dist"][:3])):
        with pytest.raises(ValueError):
            twf.window_filter(*args[:i], bad, *args[i + 1:], **kw)
    with pytest.raises(ValueError):
        twf.window_filter(*args, **dict(kw, gather_block=16))  # the window has G = 8's words


def test_pack_window_round_trips_the_lane_masks():
    gen = torch.Generator().manual_seed(0)
    for G in (1, 8, 32, 64, 128):
        lane_valid = torch.rand((3, 5, G), generator=gen) < 0.5
        t = torch.randint(0, 9, (3, 5), generator=gen)
        blk = torch.randint(0, 99, (3, 5), generator=gen)
        w = twf.pack_window(t, blk, lane_valid)
        assert w.dtype == torch.int32 and w.shape == (3, 5, 2 + twf.mask_words(G))
        lanes = torch.arange(G)
        bits = (w[..., 2 + lanes // 32] >> (lanes % 32)) & 1
        assert torch.equal(bits != 0, lane_valid)
        assert torch.equal(w[..., 0], t.to(torch.int32))
        assert torch.equal(w[..., 1], blk.to(torch.int32))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the window filter's kernel runs on the card only")
    return torch.device("cuda")


@pytest.mark.card
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(card, name):
    """The kernel against its plain version on the card, bit for bit, at
    each case and both windows, and at the glove engine's shape (Q 256,
    G 32, WB 512, chunk 2,048, 435 clusters)."""
    case, G, wb, chunk, cap, use_filter, routing, seed = CASES[name]
    shapes = [dict(gather_block=G, wb=wb, **SHAPE),
              dict(q=256, tables=128, slots=1_183_514, gather_block=32, wb=512, clusters=435)]
    runs = [(shapes[0], chunk, min(cap, wb * G))]
    if name == "random":
        runs.append((shapes[1], 2048, 2048 + 32))
    for shape, ch, cp in runs:
        c = window_filter_case(case=case, seed=seed, device=card, **shape)
        for use_map in ((True, False) if c["smap"] is not None else (False,)):
            kw = dict(use_map=use_map, chunk=ch, cap=cp, use_filter=use_filter, routing=routing)
            before, ls = twf.FILTER_LAUNCHES, LoopStats()
            got = run_window_filter(twf.window_filter, c, loop_stats=ls, **kw)
            want = run_window_filter(twf.window_filter_plain, c, loop_stats=ls, **kw)
            torch.cuda.synchronize()
            assert twf.FILTER_LAUNCHES == before + 1 and ls == LoopStats(filter_launches=1)
            for g, w, what in zip(got, want, ("compact_ids", "consumed", "taken", "seen")):
                assert torch.equal(g, w), (what, shape, use_map)
