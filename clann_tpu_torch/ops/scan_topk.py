"""Fused dense-scan candidates (K1, K2) and the fused-scan query paths
(PyTorch).

Port of ``clann_tpu.ops.pallas.scan_topk``:

- ``scan_candidates_packed`` is the wrapper of K1, the hand-written CUDA
  kernel in ``csrc/scan_topk.cu`` that replaces the Pallas kernel
  ``_scan_kernel_packed``. It returns the packed bin winners in the JAX
  kernel's layout, ``(n_pad / per_bin, q_pad)`` int32: for every bin of
  ``per_bin`` consecutive base rows and every query, the max over the bin of
  ``(bitcast<int32>(score + 3.0) & ~(pg - 1)) | row_in_bin``.
- ``packed_candidates_plain`` is the same function in plain PyTorch. It runs
  for CPU tensors (the tests) and as the reference the kernel is compared
  with on the card. A CUDA tensor given to the wrapper never reaches it.
- ``fused_scan_candidates_packed`` adds the decode and the top-`num_bins`
  selection; ``fused_scan_topk_e2e`` the top-`rescore_m` cut, the exact f32
  rescore and the final top-k.
- ``scan_candidates`` is the wrapper of K2 (same source file), which
  replaces the unpacked Pallas kernel ``_scan_kernel``: per bin and query the
  f32 max of the score and the lowest row reaching it, as ``(q_pad,
  n_pad / per_bin)`` vals and ids. ``candidates_plain`` is its plain
  version; ``fused_scan_candidates`` and ``pallas_scan_topk`` are the path
  around it.

`block_n` and `num_bins` matter only through ``per_bin = block_n //
num_bins``; `q_tile` only pads the query count. Both keep the JAX meaning so
that the port selects the same candidates as the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from clann_tpu_torch.ops.distances import (
    _normalize_queries,
    as_device_f32,
    l2_normalize,
    rescore,
    resolve_device,
)

# Launches of the K1 kernel made by scan_candidates_packed, and of the K2
# kernel made by scan_candidates (the plain versions never count). A run
# resets them and reads them back to show that its path went through the
# kernel.
KERNEL_LAUNCHES = 0
CANDIDATES_LAUNCHES = 0

# decoded sentinel for padded / invalid rows (the JAX decode's value)
_INVALID = -(1 << 30)


def _check_operands(base_bf16, queries_bf16, per_bin):
    if base_bf16.dtype != torch.bfloat16 or queries_bf16.dtype != torch.bfloat16:
        raise ValueError("base and queries must be bfloat16")
    if base_bf16.dim() != 2 or queries_bf16.dim() != 2:
        raise ValueError("base and queries must be 2-D")
    if base_bf16.shape[1] != queries_bf16.shape[1]:
        raise ValueError(
            f"dpad mismatch: base {tuple(base_bf16.shape)}, "
            f"queries {tuple(queries_bf16.shape)}"
        )
    if base_bf16.device != queries_bf16.device:
        raise ValueError("base and queries must be on one device")
    if per_bin < 1 or per_bin & (per_bin - 1):
        raise ValueError(f"per_bin={per_bin} must be a power of two")
    if base_bf16.shape[0] % per_bin:
        raise ValueError(f"n_pad={base_bf16.shape[0]} is not a multiple of per_bin={per_bin}")


def _check_packed_args(base_bf16, queries_bf16, per_bin, group_r):
    _check_operands(base_bf16, queries_bf16, per_bin)
    if group_r < 1 or group_r & (group_r - 1) or per_bin % group_r:
        raise ValueError(f"group_r={group_r} must be a power of two dividing per_bin")
    pg = per_bin // group_r
    # the row index replaces the low log2(pg) mantissa bits of the score:
    # >= 9 of them must survive (bf16 inputs carry ~8)
    if pg > (1 << 14):
        raise ValueError(f"per_bin / group_r = {pg} exceeds 16384")


def _check_cuda_operands(base_bf16, queries_bf16):
    """What the CUDA kernels take beyond _check_operands."""
    if not base_bf16.is_cuda:
        raise ValueError(f"unsupported device {base_bf16.device}")
    if not (base_bf16.is_contiguous() and queries_bf16.is_contiguous()):
        raise ValueError("base and queries must be contiguous")
    if base_bf16.shape[1] % 64:
        raise ValueError(f"dpad={base_bf16.shape[1]} must be a multiple of 64")
    if base_bf16.data_ptr() % 16 or queries_bf16.data_ptr() % 16:
        raise ValueError("base and queries must be 16-byte aligned")


# The scan kernels (K1-K3) address base and query rows with TMA, whose
# coordinates are int32: every row a launch can reach, plus one tile past it,
# must stay below 2**31.
_TMA_ROW_LIMIT = (1 << 31) - 1
_TMA_BASE_TILE, _TMA_QUERY_GROUP = 64, 256


def _check_tma_rows(base_rows: int, query_rows: int) -> None:
    """What the scan kernels' TMA coordinates take (checked on every
    device, so that a call never depends on where its tensors lie)."""
    if base_rows + _TMA_BASE_TILE > _TMA_ROW_LIMIT:
        raise ValueError(f"{base_rows} base rows exceed the kernel's int32 TMA rows")
    if query_rows + _TMA_QUERY_GROUP > _TMA_ROW_LIMIT:
        raise ValueError(f"{query_rows} query rows exceed the kernel's int32 TMA rows")


def scan_candidates_packed(
    base_bf16: torch.Tensor,  # (n_pad, dpad) bf16
    queries_bf16: torch.Tensor,  # (q_pad, dpad) bf16
    *,
    per_bin: int,
    biased: bool = False,
    group_r: int = 1,
    acc_bf16: bool = False,
) -> torch.Tensor:
    """K1: packed bin winners, (n_pad // per_bin, q_pad) int32.

    CUDA tensors launch the hand-written kernel on the current stream (and
    raise on anything it does not take); CPU tensors run
    packed_candidates_plain. `group_r > 1` and `acc_bf16` are options of the
    plain version only. Rows are limited by the kernel's int32 TMA
    coordinates (below 2**31 - 64 base rows, 2**31 - 256 query rows).
    """
    global KERNEL_LAUNCHES

    _check_packed_args(base_bf16, queries_bf16, per_bin, group_r)
    _check_tma_rows(base_bf16.shape[0], queries_bf16.shape[0])
    if base_bf16.device.type == "cpu":
        return packed_candidates_plain(
            base_bf16, queries_bf16, per_bin=per_bin, biased=biased,
            group_r=group_r, acc_bf16=acc_bf16,
        )
    _check_cuda_operands(base_bf16, queries_bf16)
    if group_r != 1 or acc_bf16:
        raise ValueError("the CUDA kernel takes group_r=1 and acc_bf16=False only")
    n_pad, dpad = base_bf16.shape
    q_pad = queries_bf16.shape[0]

    from clann_tpu_torch.ops import _build

    lib = _build.load_library()
    out = torch.empty((n_pad // per_bin, q_pad), dtype=torch.int32,
                      device=base_bf16.device)
    if out.numel() == 0:
        return out  # nothing to launch (and nothing counted)
    dev = base_bf16.device
    code = lib.clann_scan_topk_packed(
        base_bf16.data_ptr(), queries_bf16.data_ptr(), out.data_ptr(),
        n_pad, q_pad, dpad, per_bin, int(biased), dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "clann_scan_topk_packed launch")
    KERNEL_LAUNCHES += 1
    return out


def packed_candidates_plain(
    base_bf16: torch.Tensor,
    queries_bf16: torch.Tensor,
    *,
    per_bin: int,
    biased: bool = False,
    group_r: int = 1,
    acc_bf16: bool = False,
    block_rows: int = 32768,
) -> torch.Tensor:
    """K1's function in plain PyTorch, block by block over the base.

    The bf16 operands are upcast to f32 BEFORE the product (a bf16 matmul
    would round the scores to bf16); products of bf16 values are exact in
    f32, so only the summation order differs from the kernel. Working in
    `block_rows` slices keeps the f32 score tile bounded (the whole score
    matrix at the bench shape would be 50 GB).

    `group_r`: a plain max over groups of group_r rows before packing (ids
    become group starts). `acc_bf16`: scores rounded to bf16 before
    packing.
    """
    _check_packed_args(base_bf16, queries_bf16, per_bin, group_r)
    n_pad = base_bf16.shape[0]
    q_pad = queries_bf16.shape[0]
    pg = per_bin // group_r
    qf = queries_bf16.float()
    blk = max(per_bin, (block_rows // per_bin) * per_bin)
    sub = torch.arange(pg, dtype=torch.int32, device=base_bf16.device).view(1, pg, 1)
    outs = []
    for start in range(0, n_pad, blk):
        s = torch.matmul(base_bf16[start : start + blk].float(), qf.T)
        if not biased:
            s = s + 3.0
        if acc_bf16:
            s = s.to(torch.bfloat16).float()
        nb = s.shape[0] // per_bin
        if group_r > 1:
            s3 = s.view(nb, pg, group_r, q_pad).amax(dim=2)
        else:
            s3 = s.view(nb, pg, q_pad)
        p = s3.contiguous().view(torch.int32)
        outs.append(((p & ~(pg - 1)) | sub).amax(dim=1))
    return torch.cat(outs)


def decode_packed(packed, *, n_real: int, num_bins: int, per_bin: int,
                  group_r: int = 1):
    """(q_pad, num_bins) candidate values (quantized, f32) and ids (int64)
    from K1's (n_bins_total, q_pad) output, exactly as the JAX decode.

    High bits hold bitcast(score + 3.0) with the low log2(pg) mantissa bits
    replaced by the row (or group) in the bin; clearing them floors the
    score to its quantization step. Rows >= n_real are masked out.
    """
    pg = per_bin // group_r
    pt = packed.T  # (q_pad, n_bins_total)
    n_bins_total = pt.shape[1]
    sub = (pt & (pg - 1)).long()
    ids = (torch.arange(n_bins_total, dtype=torch.int64,
                        device=packed.device)[None, :] * per_bin
           + sub * group_r)
    masked = torch.where(ids < n_real, pt, _INVALID)
    if n_bins_total > num_bins:
        top_p, sel = torch.topk(masked, num_bins, dim=1)
        top_i = torch.gather(ids, 1, sel)
    else:
        top_p, top_i = masked, ids
    # the sentinel decodes to bitcast(0xC0000000) - 3 = -5.0, below any score
    top_v = (top_p & ~(pg - 1)).view(torch.float32) - 3.0
    valid = top_p > _INVALID
    top_v = torch.where(valid, top_v, -torch.inf)
    top_i = torch.where(valid, top_i, -1)
    return top_v, top_i


def _check_plan(n_pad, q_pad, block_n, q_tile, num_bins, group_r):
    if n_pad % block_n or q_pad % q_tile:
        raise ValueError(
            f"n_pad={n_pad} / q_pad={q_pad} must be multiples of "
            f"block_n={block_n} / q_tile={q_tile}"
        )
    if block_n % num_bins:
        raise ValueError(f"block_n={block_n} is not a multiple of num_bins={num_bins}")
    per_bin = block_n // num_bins
    if per_bin % group_r:
        raise ValueError(f"group_r={group_r} does not divide per_bin={per_bin}")
    return per_bin


def fused_scan_candidates_packed(
    base_bf16: torch.Tensor,  # (n_pad, dpad) bf16, rows beyond n_real zero
    queries_bf16: torch.Tensor,  # (q_pad, dpad) bf16
    *,
    n_real: int,
    num_bins: int = 128,
    block_n: int = 16384,
    q_tile: int = 256,
    biased: bool = False,
    group_r: int = 1,
    acc_bf16: bool = False,
):
    """(q_pad, num_bins) approximate top candidates (vals f32, ids int64).

    Same contract as the JAX function. `biased`: the operands carry a bias
    column making the dot == score + 3.0. `group_r > 1`: ids are group-start
    rows; the caller rescores all group_r rows of each.
    """
    per_bin = _check_plan(base_bf16.shape[0], queries_bf16.shape[0],
                          block_n, q_tile, num_bins, group_r)
    packed = scan_candidates_packed(
        base_bf16, queries_bf16, per_bin=per_bin, biased=biased,
        group_r=group_r, acc_bf16=acc_bf16,
    )
    return decode_packed(packed, n_real=n_real, num_bins=num_bins,
                         per_bin=per_bin, group_r=group_r)


def pad_queries(queries_f32, dpad: int, q_tile: int, biased: bool):
    """(q_pad, dpad) bf16 query operand: rows padded to a q_tile multiple,
    the bias column d set to 3.0 when `biased`."""
    Q, d = queries_f32.shape
    q_pad = ((Q + q_tile - 1) // q_tile) * q_tile
    qp = torch.zeros((q_pad, dpad), dtype=torch.bfloat16, device=queries_f32.device)
    qp[:Q, :d] = queries_f32.to(torch.bfloat16)
    if biased:
        if dpad <= d:
            raise ValueError("bias column needs one spare padded dim")
        qp[:Q, d] = 3.0
    return qp


def fused_scan_topk_e2e(
    base_bf16: torch.Tensor,  # (n_pad, dpad) bf16, rows beyond n_real zero
    base_f32: torch.Tensor,  # (n_real, d) f32 normalized (exact rescore)
    queries_f32: torch.Tensor,  # (Q, d) f32; normalized here if `normalize`
    *,
    n_real: int,
    k: int,
    rescore_m: int = 32,
    num_bins: int = 64,
    block_n: int = 32768,
    q_tile: int = 256,
    normalize: bool = False,
    biased: bool = False,
    group_r: int = 1,
    acc_bf16: bool = False,
):
    """Whole fused-scan query: pad + K1 + candidate selection + exact f32
    rescore of the best `rescore_m` + final top-k.

    Returns (exact sims desc (Q, k), ids (Q, k) int64, -1 where empty).
    `biased`: base_bf16 carries the bias column (base_bf16[:n_real, d] ==
    1.0, as ops/ivf._pallas_base writes it); the query side is set here.
    """
    Q = queries_f32.shape[0]
    if normalize:
        queries_f32 = _normalize_queries(queries_f32)
    qp = pad_queries(queries_f32, base_bf16.shape[1], q_tile, biased)
    v, i = fused_scan_candidates_packed(
        base_bf16, qp, n_real=n_real,
        num_bins=num_bins, block_n=block_n, q_tile=q_tile,
        biased=biased, group_r=group_r, acc_bf16=acc_bf16,
    )
    v, i = v[:Q], i[:Q]
    m = min(rescore_m, v.shape[1])
    if v.shape[1] > m:
        # a stable sort keeps lax.top_k's tie order (lower index first):
        # the quantized values tie often, and ties at the m-th place would
        # otherwise pick other candidates than the JAX path
        sel = torch.sort(v, dim=1, descending=True, stable=True).indices[:, :m]
        i = torch.gather(i, 1, sel)
    if group_r > 1:
        # group-granular winners: rescore all group_r rows of each group
        gvalid = (i >= 0)[:, :, None]
        i = i[:, :, None] + torch.arange(group_r, device=i.device)
        i = torch.where(gvalid, i, -1).reshape(Q, m * group_r)
        i = torch.where(i < n_real, i, -1)
    ex = rescore(base_f32, i, queries_f32)
    s, sel2 = torch.topk(ex, k, dim=1)
    return s, torch.where(torch.isfinite(s), torch.gather(i, 1, sel2), -1)


def scan_candidates(
    base_bf16: torch.Tensor,  # (n_pad, dpad) bf16
    queries_bf16: torch.Tensor,  # (q_pad, dpad) bf16
    *,
    per_bin: int,
):
    """K2: per (query, bin) the f32 max of the score and the lowest row
    reaching it, as vals (q_pad, n_pad // per_bin) f32 and ids (same shape)
    int32 global rows, the JAX kernel's layout.

    CUDA tensors launch the hand-written kernel on the current stream (and
    raise on anything it does not take); CPU tensors run candidates_plain.
    Rows are limited as for K1 (the same loop's int32 TMA coordinates).
    """
    global CANDIDATES_LAUNCHES

    _check_operands(base_bf16, queries_bf16, per_bin)
    _check_tma_rows(base_bf16.shape[0], queries_bf16.shape[0])
    if base_bf16.device.type == "cpu":
        return candidates_plain(base_bf16, queries_bf16, per_bin=per_bin)
    _check_cuda_operands(base_bf16, queries_bf16)
    n_pad, dpad = base_bf16.shape
    q_pad = queries_bf16.shape[0]
    if per_bin > (1 << 14) or n_pad >= (1 << 31):
        raise ValueError(f"per_bin={per_bin} > 16384 or n_pad={n_pad} past int32 ids")

    from clann_tpu_torch.ops import _build

    lib = _build.load_library()
    dev = base_bf16.device
    vals = torch.empty((q_pad, n_pad // per_bin), dtype=torch.float32, device=dev)
    ids = torch.empty((q_pad, n_pad // per_bin), dtype=torch.int32, device=dev)
    if vals.numel() == 0:
        return vals, ids  # nothing to launch (and nothing counted)
    code = lib.clann_scan_candidates(
        base_bf16.data_ptr(), queries_bf16.data_ptr(), vals.data_ptr(),
        ids.data_ptr(), n_pad, q_pad, dpad, per_bin, dev.index,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, code, "clann_scan_candidates launch")
    CANDIDATES_LAUNCHES += 1
    return vals, ids


def candidates_plain(
    base_bf16: torch.Tensor,
    queries_bf16: torch.Tensor,
    *,
    per_bin: int,
    block_rows: int = 32768,
):
    """K2's function in plain PyTorch, block by block over the base: f32
    product of the upcast bf16 operands, bin max, first argmax (torch.argmax
    returns the first maximal index, as the JAX kernel's min over the rows
    reaching the max does)."""
    _check_operands(base_bf16, queries_bf16, per_bin)
    n_pad = base_bf16.shape[0]
    q_pad = queries_bf16.shape[0]
    qf = queries_bf16.float()
    blk = max(per_bin, (block_rows // per_bin) * per_bin)
    vals, ids = [], []
    for start in range(0, n_pad, blk):
        s = torch.matmul(base_bf16[start : start + blk].float(), qf.T)
        nb = s.shape[0] // per_bin
        s3 = s.view(nb, per_bin, q_pad)
        arg = torch.argmax(s3, dim=1)
        first = torch.arange(nb, device=s.device)[:, None] * per_bin + start
        vals.append(s3.amax(dim=1))
        ids.append((first + arg).to(torch.int32))
    return torch.cat(vals).T.contiguous(), torch.cat(ids).T.contiguous()


def fused_scan_candidates(
    base_bf16: torch.Tensor,  # (n_pad, dpad) bf16, rows beyond n_real zero
    queries_bf16: torch.Tensor,  # (q_pad, dpad) bf16
    *,
    n_real: int,
    num_bins: int = 128,
    block_n: int = 16384,
    q_tile: int = 256,
):
    """(q_pad, num_bins) approximate top candidates (vals f32, ids int64):
    K2, then the padded rows masked and the strongest num_bins of the
    (n_pad / per_bin) bin winners kept, as the JAX function does."""
    per_bin = _check_plan(base_bf16.shape[0], queries_bf16.shape[0],
                          block_n, q_tile, num_bins, 1)
    vals, ids = scan_candidates(base_bf16, queries_bf16, per_bin=per_bin)
    ids = ids.long()
    vals = torch.where(ids < n_real, vals, -torch.inf)
    if vals.shape[1] > num_bins:
        vals, sel = torch.topk(vals, num_bins, dim=1)
        ids = torch.gather(ids, 1, sel)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def pallas_scan_topk(
    base,
    queries,
    k: int = 10,
    num_bins: int = 128,
    block_n: int = 16384,
    q_tile: int = 256,
    batch_q: int = 4096,
    device="cuda",
):
    """Fused-kernel dense scan (K2 candidates): returns numpy (exact cosine
    sims desc (Q, k) f32, ids (Q, k) int32).

    The base is unbiased, padded to dpad = ceil(d / 128) * 128 columns; the
    candidates of each batch of `batch_q` queries are re-scored exactly in
    f32 and the best k kept, as in the JAX function. Runs on the card unless
    `device` names the CPU (resolve_device: no fallback).
    """
    if k > num_bins:
        raise ValueError(f"k={k} must be <= num_bins={num_bins}")
    device = resolve_device(device)
    base_n = l2_normalize(as_device_f32(base, device))
    qn_all = l2_normalize(as_device_f32(queries, device))
    n, d = base_n.shape
    dpad = ((d + 127) // 128) * 128
    n_pad = ((n + block_n - 1) // block_n) * block_n
    base_p = torch.zeros((n_pad, dpad), dtype=torch.bfloat16, device=base_n.device)
    base_p[:n, :d] = base_n.to(torch.bfloat16)

    out_s, out_i = [], []
    for s in range(0, qn_all.shape[0], batch_q):
        qn = qn_all[s : s + batch_q]
        qp = pad_queries(qn, dpad, q_tile, biased=False)
        vals, ids = fused_scan_candidates(
            base_p, qp, n_real=n, num_bins=num_bins, block_n=block_n,
            q_tile=q_tile,
        )
        ids = ids[: qn.shape[0]]
        top_s, sel = torch.topk(rescore(base_n, ids, qn), k, dim=1)
        out_s.append(top_s)
        out_i.append(torch.gather(ids, 1, sel))
    return (torch.cat(out_s).cpu().numpy(),
            torch.cat(out_i).cpu().numpy().astype(np.int32))
