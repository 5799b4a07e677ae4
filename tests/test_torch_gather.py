"""The row gathers K4-K7 (ops/gather.py) against the TPU kernels they
replace, run by JAX in interpret mode on the CPU.

K4-K6 come from scripts/exp_pallas_gather.py (`make_*_dma(...,
interpret=True)`). scripts/exp_gather_rate.py runs its measurement when it
is imported, so K7's `dma_gather` is taken from its source with `ast` and
executed in a namespace whose `pl.pallas_call` runs in interpret mode;
neither script changes.

Tolerance: bit-exact (the kernels copy words). On the CPU each wrapper runs
its plain version, which is what is compared here; the CUDA kernels are held
against these plain versions on the card by chip_smoke.py.
"""

import ast
import functools
import math
import os
import types

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from clann_tpu_torch.ops import gather as tg
from clann_tpu_torch.probes import gather_rate as probe

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _words(rng, *shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint32)


def _t(a):
    """numpy uint32 words -> int32 tensor with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _u32(t):
    return t.numpy().view(np.uint32)


@pytest.fixture(scope="module")
def pallas_gather():
    """scripts/exp_pallas_gather.py (its measurement runs only as __main__)."""
    import importlib.util

    path = os.path.join(REPO, "scripts", "exp_pallas_gather.py")
    spec = importlib.util.spec_from_file_location("exp_pallas_gather", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.lru_cache(maxsize=1)
def _dma_gather():
    """exp_gather_rate.dma_gather, compiled from the script's source with
    pl.pallas_call in interpret mode (the script itself is not imported)."""
    path = os.path.join(REPO, "scripts", "exp_gather_rate.py")
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    fn = next(n for n in tree.body
              if isinstance(n, ast.FunctionDef) and n.name == "dma_gather")
    pl_interp = types.SimpleNamespace(**{k: getattr(pl, k) for k in dir(pl)
                                         if not k.startswith("__")})
    pl_interp.pallas_call = functools.partial(pl.pallas_call, interpret=True)
    ns = {"jax": jax, "jnp": jnp, "pl": pl_interp, "pltpu": pltpu}
    exec(compile(ast.Module(body=[fn], type_ignores=[]), path, "exec"), ns)
    return ns["dma_gather"]


@pytest.mark.parametrize("nsem", [1, 8, 16, 32])
def test_k4_pages_plain_matches_pallas(pallas_gather, nsem):
    rng = np.random.default_rng(nsem)
    pages = _words(rng, 300, 8, 128)
    idx = rng.integers(0, 300, size=128, dtype=np.int32)
    run = pallas_gather.make_page_dma(64, nsem, True)
    want = np.asarray(run(jnp.asarray(idx), jnp.asarray(pages)))
    got = tg.gather_pages(_t(pages), torch.from_numpy(idx), inflight=nsem)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, pages[idx])


# group rows of 128 B, 4 KB and 9,600 B: below, at and above one 4 KB stage
# of the card's bulk ring
@pytest.mark.parametrize("width,nsem", [(128, 8), (128, 32), (128, 1), (4, 1), (4, 32),
                                        (300, 1), (300, 32)])
def test_k5_group8_plain_matches_pallas(pallas_gather, width, nsem):
    rng = np.random.default_rng(nsem)
    table = _words(rng, 8 * 50, width)
    gidx = rng.integers(0, 50, size=128, dtype=np.int32)
    run = pallas_gather.make_group8_dma(width, 64, nsem, True)
    want = np.asarray(run(jnp.asarray(gidx), jnp.asarray(table)))
    got = tg.gather_group8(_t(table), torch.from_numpy(gidx), inflight=nsem)
    np.testing.assert_array_equal(_u32(got), want)
    np.testing.assert_array_equal(want, table.reshape(50, 8, width)[gidx].reshape(-1, width))


@pytest.mark.parametrize("nsem", [8, 16])
def test_k6_flat1d_plain_matches_pallas(pallas_gather, nsem):
    rng = np.random.default_rng(nsem)
    table = _words(rng, 333, 128)
    idx = rng.integers(0, 333, size=128, dtype=np.int32)
    run = pallas_gather.make_flat1d_dma(128, 64, nsem, True)
    want = np.asarray(run(jnp.asarray(idx), jnp.asarray(table.reshape(-1))))
    got = tg.gather_flat1d(_t(table.reshape(-1)), torch.from_numpy(idx), width=128,
                           inflight=nsem)
    np.testing.assert_array_equal(_u32(got), want)


# the probe's record widths (G * R words), the walk's G 16, R 3 (48), the
# 12-byte records of G 1, R 3 at the extreme inflights, and G 4, R 3
@pytest.mark.parametrize("width,inflight", [(64, 8), (128, 8), (16, 4), (48, 8), (3, 1),
                                            (3, 32), (12, 16)])
def test_k7_rows_plain_matches_pallas(width, inflight):
    """K7 at record widths of G * R words and rows_per_step 256."""
    rng = np.random.default_rng(width)
    flat = _words(rng, 300, width)
    idx = rng.integers(0, 300, size=512, dtype=np.int32)
    want = np.asarray(_dma_gather()(jnp.asarray(flat), jnp.asarray(idx), rows_per_step=256,
                                    width=width, inflight=inflight))
    got = tg.gather_rows(_t(flat), torch.from_numpy(idx), inflight=inflight)
    np.testing.assert_array_equal(_u32(got), want)


def _warp_model(src, idx, plan, inflight):
    """warp_gather_kernel's loop in Python, unit by unit, on numpy words:
    runs of plan.run rows, lane l copying units l, l + 32, ... of its run in
    waves of `inflight`, its (row, unit) pair moved on by 32 units with an
    add and a compare, the row's index taken from the run's lane that
    loaded it, the next run's indices loaded before the stores."""
    unit = 4 if plan.vec16 else 1
    units = src.reshape(src.shape[0], plan.su, unit)
    n_rows = idx.shape[0]
    out = np.full((n_rows * plan.su, unit), 0xDEADBEEF, np.uint32)  # unwritten
    dr, de = 32 // plan.su, 32 % plan.su

    def run_index(run):
        lanes = np.full(32, -1, np.int64)
        for lane in range(min(plan.run, max(0, n_rows - run * plan.run))):
            s = int(idx[run * plan.run + lane])
            lanes[lane] = s if 0 <= s < src.shape[0] else -1
        return lanes

    warps = plan.grid * 8
    for w0 in range(warps):
        nxt = run_index(w0)
        for run in range(w0, plan.n_runs, warps):
            mine = nxt
            row0 = run * plan.run
            n_units = min(plan.run, n_rows - row0) * plan.su
            for lane in range(32):
                r, e, u = lane // plan.su, lane % plan.su, lane
                for w in range(0, plan.per_lane, inflight):
                    vals = []
                    for k in range(inflight):
                        s = mine[r & 31]
                        ok = w + k < plan.per_lane and u + 32 * k < n_units
                        vals.append(units[s, e] if ok and s >= 0 else np.zeros(unit, np.uint32))
                        e += de
                        r += dr
                        if e >= plan.su:
                            e -= plan.su
                            r += 1
                    for k in range(inflight):
                        if w + k < plan.per_lane and u + 32 * k < n_units:
                            out[row0 * plan.su + u + 32 * k] = vals[k]
                    u += 32 * inflight
            nxt = run_index(run + warps)
    return out.reshape(n_rows, plan.su * unit)


@pytest.mark.parametrize("width", [1, 3, 12, 48, 100, 128])
@pytest.mark.parametrize("inflight", tg.INFLIGHT_CHOICES)
def test_warp_plan_keeps_lanes_busy_and_covers_rows(width, inflight):
    """warp_plan (K6 and K7's launch): a run's units are a multiple of 32,
    so no lane idles; a lane copies at most `inflight` units per run, and a
    run holds as many rows as that allows (up to 32, one index per lane)
    while the runs still fill a full grid's warps,
    the fewest rows that fill whole warp steps coming in waves where even
    they exceed it; the kernel instance is the smallest that holds them,
    at most WARP_VEC16_INFLIGHT 16-byte loads; the runs cover every row
    exactly once; the grid gives each run a warp, up to WARP_CTAS_PER_SM
    CTAs per SM."""
    sms = 132
    for aligned16 in (True, False):
        for n_rows in (1, 31, 1001, 65_536, 131_109):
            p = tg.warp_plan(width, n_rows, inflight, aligned16=aligned16, sms=sms)
            unit = 4 if p.vec16 else 1
            assert p.vec16 == (aligned16 and width % 4 == 0)
            assert p.su * unit == width
            assert 1 <= p.run <= 32 and p.run & (p.run - 1) == 0
            assert (p.run * p.su) % 32 == 0 and 32 * p.per_lane == p.run * p.su
            fewest = 32 // math.gcd(p.su, 32)
            fill = tg.fill_warps(sms)
            if fewest * p.su <= 32 * inflight:
                assert p.per_lane <= inflight
                # doubled as far as the loads, 32 rows and a full grid allow
                assert (p.run == 32 or 2 * p.run * p.su > 32 * inflight
                        or -(-n_rows // (2 * p.run)) < fill)
            else:
                assert p.run == fewest
            assert p.run == fewest or p.n_runs >= fill
            # the kernel instance: the fewest loads in flight that take a
            # lane's units, within the cap
            cap = min(inflight, tg.WARP_VEC16_INFLIGHT) if p.vec16 else inflight
            assert p.inflight in tg.INFLIGHT_CHOICES and p.inflight <= cap
            assert p.inflight >= min(p.per_lane, cap) > p.inflight // 2
            covered = np.zeros(n_rows, np.int64)
            for r in range(p.n_runs):
                covered[r * p.run: (r + 1) * p.run] += 1
            assert (covered == 1).all() and (p.n_runs - 1) * p.run < n_rows
            assert 1 <= p.grid <= sms * tg.WARP_CTAS_PER_SM
            assert p.grid * tg.WARP_THREADS // 32 >= min(p.n_runs, sms * tg.WARP_CTAS_PER_SM * 8)
    with pytest.raises(ValueError):
        tg.warp_plan(width, 10, 3, aligned16=True, sms=sms)


@pytest.mark.parametrize("width", [1, 3, 12, 48, 100, 128, 2**20])
def test_warp_plan_packs_into_one_word(width):
    """pack_warp_plan: the plan and its card in one 64-bit word, in the bit
    layout clann_gather_warp (csrc/gather.cu) decodes."""
    for inflight in tg.INFLIGHT_CHOICES:
        for aligned16 in (True, False):
            for n_rows, sms, dev in ((1, 132, 0), (65_536, 132, 3), (131_109, 16_383, 127)):
                p = tg.warp_plan(width, n_rows, inflight, aligned16=aligned16, sms=sms)
                w = tg.pack_warp_plan(p, dev)
                assert 0 <= w < 2**63
                assert w & (2**31 - 1) == p.su and not w >> 31 & 1
                assert 1 << (w >> 32 & 7) == p.run and 1 << (w >> 35 & 7) == p.inflight
                assert bool(w >> 38 & 1) == p.vec16
                assert w >> 39 & (2**17 - 1) == p.grid and w >> 56 == dev
    p = tg.warp_plan(width, 10, 8, aligned16=True, sms=132)
    with pytest.raises(ValueError):
        tg.pack_warp_plan(p._replace(grid=2**17), 0)
    with pytest.raises(ValueError):
        tg.pack_warp_plan(p, 128)


@pytest.mark.parametrize("width", [1, 3, 12, 48, 100, 128])
@pytest.mark.parametrize("aligned16", [True, False])
def test_warp_gather_model_matches_plain(width, aligned16):
    """The kernel's loop (_warp_model) on its plan equals the plain gather
    at every inflight, with indices 0, last, -1 and n, a ragged last run and
    a grid small enough that warps loop over several runs."""
    rng = np.random.default_rng(width)
    src = _words(rng, 57, width)
    # 75 rows take the fewest rows per run; 2,100 fill a one-SM grid with
    # runs twice to four times as long
    for n_rows in (75, 2100):
        idx = rng.integers(0, 57, size=n_rows, dtype=np.int32)
        idx[:4] = [0, 56, -1, 57]
        want = _u32(tg.rows_plain(_t(src), torch.from_numpy(idx)))
        for inflight in tg.INFLIGHT_CHOICES:
            p = tg.warp_plan(width, n_rows, inflight, aligned16=aligned16, sms=1)
            p = p._replace(grid=1)  # 8 warps over every run
            np.testing.assert_array_equal(_warp_model(src, idx, p, p.inflight), want)


def test_out_of_range_rows_read_zeros():
    """Indices outside the source give rows of zeros, in every wrapper
    (the CUDA kernels write zeros there too)."""
    rng = np.random.default_rng(1)
    table = _words(rng, 80, 12)
    idx = np.array([0, -1, 79, 80, 5, 2**31 - 1], np.int32)
    got = _u32(tg.gather_rows(_t(table), torch.from_numpy(idx)))
    np.testing.assert_array_equal(got[[0, 2, 4]], table[[0, 79, 5]])
    assert (got[[1, 3, 5]] == 0).all()
    pages = _words(rng, 4, 8, 128)
    got = _u32(tg.gather_pages(_t(pages), torch.tensor([3, 4, -2], dtype=torch.int32)))
    np.testing.assert_array_equal(got[0], pages[3])
    assert (got[1:] == 0).all()
    # K5: 83 rows hold 10 whole groups; group 10 is partial and reads zeros
    t83 = _words(rng, 83, 4)
    got = _u32(tg.gather_group8(_t(t83), torch.tensor([9, 10], dtype=torch.int32)))
    np.testing.assert_array_equal(got[:8], t83[72:80])
    assert (got[8:] == 0).all()
    got = _u32(tg.gather_flat1d(_t(t83.reshape(-1)), torch.tensor([82, 83], dtype=torch.int32),
                                width=4))
    np.testing.assert_array_equal(got[:4], t83[82])
    assert (got[4:] == 0).all()


def test_cpu_wrappers_use_plain_versions_and_count_nothing():
    tg.reset_launches()
    rng = np.random.default_rng(2)
    table = _words(rng, 40, 8)
    idx = torch.tensor([3, 1, 39], dtype=torch.int32)
    as_u32 = torch.from_numpy(table.view(np.int32)).view(torch.uint32)
    got = tg.gather_rows(as_u32, idx)
    assert got.dtype == torch.uint32
    np.testing.assert_array_equal(got.view(torch.int32).numpy().view(np.uint32),
                                  table[[3, 1, 39]])
    tg.gather_pages(_t(_words(rng, 4, 8, 128)), idx[:1])
    tg.gather_group8(_t(table), idx[:1])
    tg.gather_flat1d(_t(table.reshape(-1)), idx, width=8)
    assert (tg.PAGES_LAUNCHES, tg.GROUP8_LAUNCHES, tg.FLAT1D_LAUNCHES,
            tg.ROWS_LAUNCHES) == (0, 0, 0, 0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    table = torch.zeros((10, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        tg.gather_rows(table, torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError, match="inflight"):
        tg.gather_rows(table, torch.zeros(3, dtype=torch.int32), inflight=3)
    with pytest.raises(ValueError, match="32-bit"):
        tg.gather_rows(table.double(), torch.zeros(3, dtype=torch.int32))
    with pytest.raises(ValueError, match="pages"):
        tg.gather_pages(table, torch.zeros(3, dtype=torch.int32))


def test_bulk_gathers_refuse_unaligned_sources():
    """K4 and K5 copy with bulk (TMA) copies on the card, which need a
    16-byte aligned source: a view at an odd word offset is refused."""
    words = torch.zeros(8 * 10 * 4 + 4, dtype=torch.int32)
    assert words.data_ptr() % 16 == 0
    tg._bulk_aligned(words[4:].view(80, 4))
    for off in (1, 2, 3):
        with pytest.raises(ValueError, match="16-byte aligned"):
            tg._bulk_aligned(words[off:off + 320].view(80, 4))


def test_probe_rows_and_fields():
    """The gather-rate probe's row bookkeeping (its timings need a card)."""
    row = probe.rate_row(2.0, rows=131_072, row_bytes=512, useful_bytes=512, correct=True)
    assert row["ms_per_iter"] == 2.0 and row["correct"] is True
    assert row["ns_per_row"] == pytest.approx(2e6 / 131_072)
    assert row["gbps"] == pytest.approx(131_072 * 512 / 2e-3 / 1e9)
    assert row["useful_gbps"] == row["gbps"]
    with pytest.raises(SystemExit):
        probe.main(["--device", "cpu"])


def test_path_times_readings(monkeypatch):
    """path_times and kernel_times (the timing of chip_smoke.py's
    [gather-time] lines) at tiny shapes, the card's timers replaced by
    stand-ins that run the call: every path shape gets the wrapper's,
    the plain version's and index_select's readings, the wrapper at every
    inflight, its bound, and its default equal to the plain version."""
    calls = []
    def stand_in(ms):
        return lambda fn, sets, reps: calls.append(fn(*sets[0])) or ms

    monkeypatch.setattr(probe, "time_graph", stand_in(1.0))
    monkeypatch.setattr(probe, "time_iters", stand_in(2.0))
    for name, value in (("ROWS", 300), ("WALK_ROWS", 200), ("TAKE_SLOTS", 3200), ("ENGINE_L", 2),
                        ("L_PROBE", 2), ("WALK_POINTS", 800), ("WALK_L", 2)):
        monkeypatch.setattr(probe, name, value)
    res = probe.path_times("cpu", iters=3, reps=1)
    assert sorted(res) == ["k6_flat1d", "k7_engine_L2_G32", "k7_walk_L2_G16_R3"]
    for tag, r in res.items():
        assert r["correct"] is True and r["row_bytes"] == (192 if "walk" in tag else 512)
        assert r["bound_ms"] == pytest.approx(r["rows"] * (2 * r["row_bytes"] + 4) / 3.35e9)
        assert r["kernel"] == dict(device_ms=1.0, call_ms=2.0, device_each=[1.0, 1.0])
        assert r["plain"]["device_each"] == [1.0, 1.0] and r["library"]["call_ms"] == 2.0
        assert sorted(r["inflight"]) == sorted(tg.INFLIGHT_CHOICES)
    # per shape: plain, kernel, kernel, plain, library timed twice each, then
    # the six inflights once
    assert len(calls) == 3 * (2 * 5 + len(tg.INFLIGHT_CHOICES))
