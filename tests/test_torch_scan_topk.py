"""K1's plain PyTorch version and the fused-scan path against the JAX
package's fused_scan_candidates_packed / fused_scan_topk_e2e run with
interpret=True, on the CPU, at the shapes of tests/test_pallas_scan.py.

Tolerances: decoded candidate ids >= 99% identical per query (as sets),
decoded values of shared ids within one quantization step (pg * 2^-22) +
1e-6 — the two CPU products sum the same exact bf16 products in another
order, which can move a score across a step. End-to-end sims within 1e-5,
ids as sets up to boundary ties.

The CUDA kernel itself has no CPU mode; chip_smoke.py holds it against
this plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from clann_tpu.data.synthetic import clustered_unit_vectors, random_unit_vectors
from clann_tpu.ops.pallas import scan_topk as jst

from clann_tpu_torch.ops import _build
from clann_tpu_torch.ops import scan_topk as tst
from clann_tpu_torch.testing import (
    assert_topk_match,
    decode_winners,
    packed_agreement,
    quant_step,
)

torch.set_num_threads(1)

N, D, DPAD, QN = 2048, 24, 128, 32


def _operands(n=N, d=D, q=QN, seed=3, n_real=None, biased=False):
    rng = np.random.default_rng(seed)
    base = rng.normal(size=(n, d)).astype(np.float32)
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    n_real = n if n_real is None else n_real
    base[n_real:] = 0.0
    bp = np.zeros((n, DPAD), np.float32)
    bp[:, :d] = base
    qp = np.zeros((q, DPAD), np.float32)
    qp[:, :d] = qs
    if biased:
        bp[:n_real, d] = 1.0
        qp[:, d] = 3.0
    return base, qs, bp, qp, n_real


def _both_candidates(bp, qp, **kw):
    jv, ji = jst.fused_scan_candidates_packed(
        jnp.asarray(bp, jnp.bfloat16), jnp.asarray(qp, jnp.bfloat16),
        interpret=True, **kw,
    )
    tv, ti = tst.fused_scan_candidates_packed(
        torch.from_numpy(bp).to(torch.bfloat16),
        torch.from_numpy(qp).to(torch.bfloat16), **kw,
    )
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


def _assert_candidates_match(jv, ji, tv, ti, tol):
    q, nb = ji.shape
    overlap = np.mean([len(set(ji[r]) & set(ti[r])) / nb for r in range(q)])
    assert overlap >= 0.99, overlap
    for r in range(q):
        jmap = dict(zip(ji[r].tolist(), jv[r].tolist()))
        for i, v in zip(ti[r].tolist(), tv[r].tolist()):
            if i in jmap:
                jvv = jmap[i]
                assert (np.isinf(v) and np.isinf(jvv)) or abs(v - jvv) <= tol, (r, i, v, jvv)


@pytest.mark.parametrize("block_n,num_bins,biased", [
    (512, 32, False),   # per_bin 16, the test_pallas_scan shape
    (512, 32, True),    # bias column carries the +3.0
    (512, 512, False),  # per_bin 1: every row its own bin
    (512, 128, True),   # per_bin 4
    (1024, 8, False),   # per_bin 128: a bin spans a whole 128-row chunk
])
def test_candidates_plain_vs_jax(block_n, num_bins, biased):
    _, _, bp, qp, n_real = _operands(n_real=N - 17, biased=biased)
    jv, ji, tv, ti = _both_candidates(
        bp, qp, n_real=n_real, num_bins=num_bins, block_n=block_n, q_tile=32,
        biased=biased,
    )
    assert ti.max() < n_real and (ti >= 0).all()
    _assert_candidates_match(jv, ji, tv, ti, quant_step(block_n // num_bins) + 1e-6)


@pytest.mark.parametrize("group_r,acc_bf16,block_n,num_bins,biased", [
    (2, False, 512, 32, False), (4, False, 512, 32, False),
    (1, True, 512, 32, False), (4, True, 512, 32, False),
    # per_bin 512: a bin spans the kernel's 64-row tiles (its other
    # epilogue branch); groups of 8 lie inside a tile, of 32 too
    (8, False, 1024, 2, False), (8, False, 1024, 2, True),
    (8, True, 1024, 2, False), (8, True, 1024, 2, True),
    (32, False, 1024, 2, False), (32, False, 1024, 2, True),
    (32, True, 1024, 2, False), (32, True, 1024, 2, True),
])
def test_candidates_group_and_bf16_plain_vs_jax(group_r, acc_bf16, block_n, num_bins,
                                                biased):
    _, _, bp, qp, n_real = _operands(n=1024, seed=9, biased=biased)
    jv, ji, tv, ti = _both_candidates(
        bp, qp, n_real=n_real, num_bins=num_bins, block_n=block_n, q_tile=32,
        group_r=group_r, acc_bf16=acc_bf16, biased=biased,
    )
    assert (ti % group_r == 0).all()
    pg = block_n // num_bins // group_r
    # with acc_bf16 the scores round to bf16 (a step of 2^-7 in [2, 4))
    # before packing, so one step of THAT is the summation-order bound
    _assert_candidates_match(jv, ji, tv, ti,
                             (2.0 ** -7 if acc_bf16 else quant_step(pg)) + 1e-6)


def test_decode_masks_rows_beyond_n_real():
    """Bins wholly past n_real never surface; too few real bins leave
    -1 / -inf slots, as in the JAX decode."""
    _, _, bp, qp, n_real = _operands(n=512, n_real=20)
    jv, ji, tv, ti = _both_candidates(bp, qp, n_real=n_real, num_bins=64,
                                      block_n=512, q_tile=32)
    np.testing.assert_array_equal(np.sort(ti, axis=1), np.sort(ji, axis=1))
    assert ((ti == -1) == np.isinf(tv)).all()
    assert (ti < n_real).all() and (ti == -1).sum() == QN * (64 - 3)


@pytest.mark.parametrize("group_r,acc_bf16,biased", [
    (1, False, False), (1, False, True), (2, False, True), (4, True, False),
    (1, True, True), (8, True, False),
])
def test_e2e_vs_jax(group_r, acc_bf16, biased):
    base, qs, _, _, _ = _operands(n=1500, q=48, seed=11)
    bn = 512
    n_pad = ((base.shape[0] + bn - 1) // bn) * bn
    bp = np.zeros((n_pad, DPAD), np.float32)
    bp[: base.shape[0], : base.shape[1]] = base
    if biased:
        bp[: base.shape[0], base.shape[1]] = 1.0
    kw = dict(n_real=base.shape[0], k=5, rescore_m=16, num_bins=32,
              block_n=bn, q_tile=16, normalize=True, biased=biased,
              group_r=group_r, acc_bf16=acc_bf16)
    js, ji = jst.fused_scan_topk_e2e(
        jnp.asarray(bp, jnp.bfloat16), jnp.asarray(base), jnp.asarray(qs * 3.0),
        interpret=True, **kw,
    )
    ts, ti = tst.fused_scan_topk_e2e(
        torch.from_numpy(bp).to(torch.bfloat16), torch.from_numpy(base),
        torch.from_numpy(qs * 3.0), **kw,
    )
    assert ti.dtype == torch.int64 and ts.dtype == torch.float32
    assert_topk_match(np.asarray(ji), np.asarray(js), ti.numpy(), ts.numpy())


def _jax_packed(bp, qp, *, per_bin, group_r, acc_bf16, biased, q_tile=32):
    """The JAX kernel's raw (n_pad / per_bin, q_pad) packed winners (one
    block over the whole base), by the pallas_call of
    fused_scan_candidates_packed in interpret mode."""
    import functools

    import jax
    from jax.experimental import pallas as pl

    n_pad, dpad = bp.shape
    nb = n_pad // per_bin
    kernel = functools.partial(jst._scan_kernel_packed, nb=nb, block_n=n_pad,
                               biased=biased, group_r=group_r, acc_bf16=acc_bf16)
    return np.asarray(pl.pallas_call(
        kernel, grid=(qp.shape[0] // q_tile, 1),
        in_specs=[pl.BlockSpec((q_tile, dpad), lambda i, j: (i, 0)),
                  pl.BlockSpec((n_pad, dpad), lambda i, j: (j, 0))],
        out_specs=pl.BlockSpec((nb, q_tile), lambda i, j: (j, i)),
        out_shape=jax.ShapeDtypeStruct((nb, qp.shape[0]), jnp.int32),
        interpret=True,
    )(jnp.asarray(qp, jnp.bfloat16), jnp.asarray(bp, jnp.bfloat16)))


@pytest.mark.parametrize("per_bin,group_r,acc_bf16,biased", [
    (16, 4, False, False), (16, 2, True, True), (512, 8, True, True),
    (512, 32, False, False),
])
def test_decode_winners_reads_jax_groups(per_bin, group_r, acc_bf16, biased):
    """decode_winners / packed_agreement with group_r read JAX's packed
    winners as JAX's own decode does (group starts and floored values), and
    hold the plain version's winners to them."""
    _, _, bp, qp, n_real = _operands(n=1024, seed=5, biased=biased)
    kw = dict(group_r=group_r, acc_bf16=acc_bf16, biased=biased)
    packed = _jax_packed(bp, qp, per_bin=per_bin, **kw)
    # JAX's decode at one block with every bin kept: bin order, no top-k
    jv, ji = jst.fused_scan_candidates_packed(
        jnp.asarray(bp, jnp.bfloat16), jnp.asarray(qp, jnp.bfloat16), n_real=n_real,
        num_bins=1024 // per_bin, block_n=1024, q_tile=32, interpret=True, **kw)
    sub, val = decode_winners(packed, per_bin, group_r)
    rows = np.arange(packed.shape[0])[:, None] * per_bin + sub
    np.testing.assert_array_equal(rows, np.asarray(ji).T)
    np.testing.assert_array_equal(val, np.asarray(jv).T.astype(np.float64))
    assert (sub % group_r == 0).all() and sub.max() < per_bin
    assert packed_agreement(packed, packed, per_bin, group_r=group_r)["identical"] == 1.0
    plain = tst.packed_candidates_plain(
        torch.from_numpy(bp).to(torch.bfloat16), torch.from_numpy(qp).to(torch.bfloat16),
        per_bin=per_bin, **kw)
    agree = packed_agreement(packed, plain, per_bin, group_r=group_r)
    step = 2.0 ** -7 if acc_bf16 else quant_step(per_bin // group_r)
    assert agree["same_winner"] >= 0.99 and agree["max_abs_err"] <= step + 1e-6, agree


def test_plain_version_blocks_agree():
    """The block size of the plain version does not change its output."""
    _, _, bp, qp, _ = _operands(biased=True)
    b = torch.from_numpy(bp).to(torch.bfloat16)
    q = torch.from_numpy(qp).to(torch.bfloat16)
    whole = tst.packed_candidates_plain(b, q, per_bin=16, biased=True, block_rows=N)
    blocked = tst.packed_candidates_plain(b, q, per_bin=16, biased=True, block_rows=256)
    assert torch.equal(whole, blocked)
    agree = packed_agreement(whole, blocked, per_bin=16)
    assert agree == {"same_winner": 1.0, "identical": 1.0, "max_abs_err": 0.0}
    sub, val = decode_winners(whole.numpy(), 16)
    assert sub.max() < 16 and np.all((val > -1.01) & (val < 1.01))


def test_wrapper_keeps_cpu_off_the_counter():
    before = tst.KERNEL_LAUNCHES
    _, _, bp, qp, _ = _operands(n=256)
    tst.scan_candidates_packed(torch.from_numpy(bp).to(torch.bfloat16),
                               torch.from_numpy(qp).to(torch.bfloat16),
                               per_bin=16)
    assert tst.KERNEL_LAUNCHES == before


@pytest.mark.parametrize("case", ["dtype", "dpad", "per_bin", "ragged",
                                  "group", "device", "tma_base_rows", "tma_query_rows"])
def test_wrapper_rejects_bad_input(case):
    b = torch.zeros((512, DPAD), dtype=torch.bfloat16)
    q = torch.zeros((32, DPAD), dtype=torch.bfloat16)
    kw = dict(per_bin=16)
    if case == "dtype":
        b = b.float()
    elif case == "dpad":
        q = q[:, :64]
    elif case == "per_bin":
        kw["per_bin"] = 12
    elif case == "ragged":
        b = b[:500]
    elif case == "group":
        kw["group_r"] = 32
    elif case == "tma_base_rows":  # TMA row coordinates are int32
        b = torch.empty(((1 << 31) - 48, DPAD), dtype=torch.bfloat16, device="meta")
        q = q.to("meta")
    elif case == "tma_query_rows":
        q = torch.empty(((1 << 31) - 128, DPAD), dtype=torch.bfloat16, device="meta")
        b = b.to("meta")
    else:  # neither CPU nor CUDA: no silent plain-version fallback
        b, q = b.to("meta"), q.to("meta")
    with pytest.raises(ValueError, match="TMA" if case.startswith("tma") else None):
        tst.scan_candidates_packed(b, q, **kw)


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.build()
    path = _build.library_path()
    assert path.parent == tmp_path / "kernels" and path.name.endswith(".so")
    assert path == _build.library_path()  # content-addressed, stable


# ---------------------------------------------------------------- K2


def _both_unpacked(bp, qp, **kw):
    jv, ji = jst.fused_scan_candidates(
        jnp.asarray(bp, jnp.bfloat16), jnp.asarray(qp, jnp.bfloat16),
        interpret=True, **kw,
    )
    tv, ti = tst.fused_scan_candidates(
        torch.from_numpy(bp).to(torch.bfloat16),
        torch.from_numpy(qp).to(torch.bfloat16), **kw,
    )
    assert tv.dtype == torch.float32 and ti.dtype == torch.int64
    return np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()


@pytest.mark.parametrize("block_n,num_bins", [
    (512, 32),    # the test_pallas_scan shape, per_bin 16
    (512, 512),   # per_bin 1
    (512, 128),   # per_bin 4
    (1024, 8),    # per_bin 128: a bin spans a whole 128-row chunk
    (2048, 32),   # one block: the raw bin winners, no cross-block top-k
    (2048, 2048), # per_bin 1 over one block: every raw row its own winner
    (2048, 1),    # per_bin 2048: one bin spans 32 of the kernel's row tiles
])
def test_k2_candidates_plain_vs_jax(block_n, num_bins):
    _, _, bp, qp, n_real = _operands(n_real=N - 17)
    jv, ji, tv, ti = _both_unpacked(bp, qp, n_real=n_real, num_bins=num_bins,
                                    block_n=block_n, q_tile=32)
    assert ti.shape == (QN, num_bins)
    # every slot holds a real row, but for the padded rows' own bins
    assert ti.max() < n_real and ((ti >= 0).sum(axis=1) == min(num_bins, n_real)).all()
    _assert_candidates_match(jv, ji, tv, ti, 1e-5)


def test_k2_ties_take_the_lowest_row():
    """Equal scores in a bin (duplicated rows): both kernels name the
    first row reaching the max, and the raw layout matches JAX exactly."""
    _, _, bp, qp, _ = _operands(n=512, seed=4)
    bp[1::2] = bp[0::2]  # rows 2i and 2i+1 score alike
    jv, ji, tv, ti = _both_unpacked(bp, qp, n_real=512, num_bins=64,
                                    block_n=512, q_tile=32)
    assert (ti % 2 == 0).all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(tv, jv, atol=1e-6)


def _signed_tie_operands(n, per_bin, seed):
    """Operands whose scores are negative or exactly +-0, with exact ties:
    base rows in the positive orthant, rows 2i + 1 copies of rows 2i;
    queries alternately in the negative and the positive orthant (half of
    the rows score below 0 for every query); and in every third group of
    max(per_bin, 8) rows a row of -0.0 and a row of +0.0 (their scores are
    -0.0 or +0.0 by the query's sign), at rows 3 and 5 of the group or 5
    and 3, alternately. The
    expected winner of each (query, bin) is computed in numpy: the largest
    score, then the lowest row, -0.0 equal to +0.0."""
    rng = np.random.default_rng(seed)
    base = np.abs(rng.normal(size=(n, D))).astype(np.float32)
    base[n // 2:] *= -1.0
    base /= np.linalg.norm(base, axis=1, keepdims=True)
    base[1::2] = base[0::2]
    qs = np.abs(rng.normal(size=(QN, D))).astype(np.float32)
    qs[0::2] *= -1.0
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    bp = np.zeros((n, DPAD), np.float32)
    bp[:, :D] = base
    g = max(per_bin, 8)
    for b0 in range(0, n, 3 * g):
        neg, pos = (3, 5) if (b0 // (3 * g)) % 2 == 0 else (5, 3)
        bp[b0 + neg] = -0.0
        bp[b0 + pos] = 0.0
    qp = np.zeros((QN, DPAD), np.float32)
    qp[:, :D] = qs
    # the scores of the bf16 operands, exact in f64 (products of bf16 are
    # exact and 24 of them sum exactly)
    bq = torch.from_numpy(bp).to(torch.bfloat16).double().numpy()
    qq = torch.from_numpy(qp).to(torch.bfloat16).double().numpy()
    s = (bq @ qq.T).reshape(n // per_bin, per_bin, QN)
    m = s.max(axis=1)
    arg = (s == m[:, None, :]).argmax(axis=1)
    ids = np.arange(n // per_bin)[:, None] * per_bin + arg
    return bp, qp, m.T, ids.T


@pytest.mark.parametrize("per_bin", [1, 4, 16, 128, 512])
def test_k2_negative_tied_and_signed_zero_scores(per_bin):
    """Negative scores, exact ties among them (duplicated rows) and +-0.0
    products: the JAX kernel and the plain version name the same row, the
    lowest reaching the max with -0.0 == +0.0, in the raw (one block)
    layout, and both agree with the exact winners."""
    n = 1024
    bp, qp, want_v, want_i = _signed_tie_operands(n, per_bin, seed=12)
    jv, ji, tv, ti = _both_unpacked(bp, qp, n_real=n, num_bins=n // per_bin,
                                    block_n=n, q_tile=32)
    assert (want_v < 0).any() and (want_v == 0).any()
    np.testing.assert_array_equal(ji, want_i)
    np.testing.assert_array_equal(ti, want_i)
    np.testing.assert_allclose(tv, want_v, rtol=0, atol=1e-6)
    np.testing.assert_allclose(jv, want_v, rtol=0, atol=1e-6)


def test_k2_raw_layout_and_blocks_agree():
    """scan_candidates' (q_pad, n_bins) layout: id = bin * per_bin + row in
    bin, vals the bin max; the plain version's block size changes nothing."""
    _, _, bp, qp, _ = _operands(n=1024, seed=8)
    b = torch.from_numpy(bp).to(torch.bfloat16)
    q = torch.from_numpy(qp).to(torch.bfloat16)
    vals, ids = tst.scan_candidates(b, q, per_bin=16)
    assert vals.shape == ids.shape == (QN, 64) and ids.dtype == torch.int32
    s = (b.float() @ q.float().T).numpy().reshape(64, 16, QN)
    np.testing.assert_allclose(vals.numpy(), s.max(axis=1).T, atol=1e-6)
    np.testing.assert_array_equal(ids.numpy() // 16, np.arange(64)[None, :].repeat(QN, 0))
    v2, i2 = tst.candidates_plain(b, q, per_bin=16, block_rows=128)
    assert torch.equal(v2, vals) and torch.equal(i2, ids)


@pytest.mark.parametrize("shape", ["brute_force", "descending", "padding", "batched"])
def test_pallas_scan_topk_vs_jax(shape):
    if shape in ("brute_force", "batched"):
        base = clustered_unit_vectors(3000, 32, n_modes=16, seed=0)
        queries = random_unit_vectors(64, 32, seed=1)
        kw = dict(k=10, num_bins=32, block_n=512, q_tile=64)
        if shape == "batched":
            kw["batch_q"] = 24
    elif shape == "descending":
        base = random_unit_vectors(1500, 16, seed=3)
        queries = random_unit_vectors(32, 16, seed=4)
        kw = dict(k=8, num_bins=16, block_n=512, q_tile=32)
    else:  # n not a multiple of block_n: padded rows never returned
        base = random_unit_vectors(700, 16, seed=5)
        queries = random_unit_vectors(16, 16, seed=6)
        kw = dict(k=5, num_bins=16, block_n=512, q_tile=16)
    js, ji = jst.pallas_scan_topk(base, queries, interpret=True, **kw)
    before = tst.CANDIDATES_LAUNCHES
    ts, ti = tst.pallas_scan_topk(base, queries, device="cpu", **kw)
    assert tst.CANDIDATES_LAUNCHES == before  # CPU tensors: plain version
    assert ts.dtype == np.float32 and ti.dtype == np.int32
    assert_topk_match(ji, js, ti, ts)
    assert (np.diff(ts, axis=1) <= 1e-6).all()
    assert ti.min() >= 0 and ti.max() < base.shape[0]
    if shape == "brute_force":
        bn = base / np.linalg.norm(base, axis=1, keepdims=True)
        qn = queries / np.linalg.norm(queries, axis=1, keepdims=True)
        gt = np.argsort(-(qn @ bn.T), axis=1)[:, :10]
        hit = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(ti, gt)])
        assert hit >= 0.9, hit


def test_pallas_scan_topk_k_bounded_by_bins():
    base = random_unit_vectors(600, 16, seed=7)
    with pytest.raises(ValueError):
        jst.pallas_scan_topk(base, base[:4], k=20, num_bins=16, interpret=True)
    with pytest.raises(ValueError, match="num_bins"):
        tst.pallas_scan_topk(base, base[:4], k=20, num_bins=16, device="cpu")


@pytest.mark.parametrize("case", ["dtype", "dpad", "per_bin", "ragged", "device",
                                  "tma_base_rows", "tma_query_rows"])
def test_k2_wrapper_rejects_bad_input(case):
    b = torch.zeros((512, DPAD), dtype=torch.bfloat16)
    q = torch.zeros((32, DPAD), dtype=torch.bfloat16)
    per_bin = 16
    if case == "dtype":
        q = q.float()
    elif case == "dpad":
        q = q[:, :64]
    elif case == "per_bin":
        per_bin = 12
    elif case == "ragged":
        b = b[:500]
    elif case == "tma_base_rows":  # the Hopper loop's TMA rows are int32
        b = torch.empty(((1 << 31) - 48, DPAD), dtype=torch.bfloat16, device="meta")
        q = q.to("meta")
    elif case == "tma_query_rows":
        q = torch.empty(((1 << 31) - 128, DPAD), dtype=torch.bfloat16, device="meta")
        b = b.to("meta")
    else:  # neither CPU nor CUDA: no silent plain-version fallback
        b, q = b.to("meta"), q.to("meta")
    before = tst.CANDIDATES_LAUNCHES
    with pytest.raises(ValueError, match="TMA" if case.startswith("tma") else None):
        tst.scan_candidates(b, q, per_bin=per_bin)
    assert tst.CANDIDATES_LAUNCHES == before


@pytest.mark.parametrize("entry", ["pallas_scan_topk", "dense_scan_topk",
                                   "brute_force_topk", "greedy_minimum_maximum",
                                   "build_block_layout"])
def test_entry_points_default_to_the_card(entry, monkeypatch):
    """With no CUDA device the default device raises for numpy input (no
    CPU fallback); device="cpu" runs."""
    from clann_tpu_torch.ops import block_scan as tbs
    from clann_tpu_torch.ops import distances as tdist
    from clann_tpu_torch.ops import gmm as tgmm

    base = random_unit_vectors(600, 16, seed=8)
    assign = np.arange(600) % 7

    def nearest(**kw):  # each query's first id
        fn = {"pallas_scan_topk": tst.pallas_scan_topk,
              "dense_scan_topk": tdist.dense_scan_topk,
              "brute_force_topk": tdist.brute_force_topk}[entry]
        return np.asarray(fn(base, base[:4], k=5, **kw)[1])[:, 0].tolist()

    run = {"greedy_minimum_maximum":
           lambda **kw: tgmm.greedy_minimum_maximum(base, 5, **kw)[0][:1].tolist(),
           # the first block's ids (its rows are shuffled within the block)
           "build_block_layout":
           lambda **kw: sorted(tbs.build_block_layout(base, assign, 128, **kw)
                               .gids[:128].tolist())
           }.get(entry, nearest)
    want = {"greedy_minimum_maximum": [0],
            "build_block_layout": sorted(np.argsort(assign, kind="stable")[:128].tolist())
            }.get(entry, [0, 1, 2, 3])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run()
    assert run(device="cpu") == want


def test_interpret_is_accepted_and_refused_on_the_card(monkeypatch):
    """JAX's `interpret` keyword: CPU tensors run the plain version either
    way, with equal results; with a CUDA device interpret=True raises (the
    port has no interpret mode) instead of running the kernel."""
    from clann_tpu_torch.ops import block_scan as tbs
    from clann_tpu_torch.ops import distances as tdist

    base, qs, bp, qp, n_real = _operands(n=1024, q=32, seed=5)
    bpt, qpt = (torch.from_numpy(a).to(torch.bfloat16) for a in (bp, qp))
    kw = dict(n_real=n_real, num_bins=32, block_n=512, q_tile=16)
    calls = [
        lambda **i: tst.fused_scan_candidates_packed(bpt, qpt, **kw, **i),
        lambda **i: tst.fused_scan_candidates(bpt, qpt, **kw, **i),
        lambda **i: tst.fused_scan_topk_e2e(bpt, torch.from_numpy(base), torch.from_numpy(qs),
                                            k=5, rescore_m=16, **kw, **i),
        lambda **i: tuple(map(torch.as_tensor, tst.pallas_scan_topk(
            base, qs, k=5, num_bins=32, block_n=512, q_tile=16, device="cpu", **i))),
    ]
    layout = tbs.build_block_layout(base, np.arange(1024) % 5, 256, device="cpu")
    calls.append(lambda **i: tbs.block_scan_topk_e2e(
        layout, torch.from_numpy(qs), k=5, n_probe=2, rescore_m=16, num_bins=16, block_n=256,
        q_tile=16, **i))
    for call in calls:
        for a, b in zip(call(), call(interpret=True)):
            assert torch.equal(a, b)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="no interpret mode"):
        tst.pallas_scan_topk(base, qs, k=5, interpret=True, device="cuda")
    with pytest.raises(ValueError, match="no interpret mode"):
        tdist.refuse_interpret(True, torch.device("cuda", 1))
    tdist.refuse_interpret(False, "cuda")
    tdist.refuse_interpret(None, "cuda")


def test_l2_normalize_takes_eps_as_jax_does():
    """`eps` is accepted and unused, as in the JAX function."""
    from clann_tpu_torch.ops.distances import l2_normalize

    x = torch.from_numpy(_operands(n=64, q=4, seed=2)[0] * 3.0)
    x[5] = 0.0
    assert torch.equal(l2_normalize(x, eps=1e-3), l2_normalize(x))
