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


@pytest.mark.parametrize("width,inflight", [(64, 8), (128, 8), (16, 4)])
def test_k7_rows_plain_matches_pallas(width, inflight):
    """K7 at the probe's record widths (G * R words) and rows_per_step 256."""
    rng = np.random.default_rng(width)
    flat = _words(rng, 300, width)
    idx = rng.integers(0, 300, size=512, dtype=np.int32)
    want = np.asarray(_dma_gather()(jnp.asarray(flat), jnp.asarray(idx), rows_per_step=256,
                                    width=width, inflight=inflight))
    got = tg.gather_rows(_t(flat), torch.from_numpy(idx), inflight=inflight)
    np.testing.assert_array_equal(_u32(got), want)


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
