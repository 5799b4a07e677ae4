"""Row gathers K4-K7 (PyTorch wrappers of ``csrc/gather.cu``).

The four TPU kernels of the repository's gather experiments, and the
global LSH engine's record gather, copy whole rows of 32-bit words picked
by an int32 index vector. Each has a wrapper here that launches its
hand-written CUDA kernel for CUDA tensors (and raises on anything the
kernel does not take) and runs its plain PyTorch version for CPU tensors:

- K4 `gather_pages`: out[i] = pages[idx[i]], 4 KB pages (P, 8, 128); the
  port of scripts/exp_pallas_gather.py::make_page_dma.
- K5 `gather_group8`: out[8i : 8i+8] = table[8 gidx[i] : 8 gidx[i] + 8],
  the aligned 8-row group; make_group8_dma.
- K6 `gather_flat1d`: out[iW : (i+1)W] = flat[idx[i] W : (idx[i]+1) W] of
  a flat word array; make_flat1d_dma.
- K7 `gather_rows`: out[r] = table[idx[r]]; scripts/exp_gather_rate.py::
  dma_gather, and the record gather of ops/global_query.py.

An index outside the source reads as a row of zeros, in the kernels and in
the plain versions alike. Words may be int32, uint32 or float32 tensors
(the bits are copied). `inflight` (1, 2, 4, 8, 16 or 32) is the
counterpart of the TPU kernels' NSEM: for K4 and K5 (bulk copies through a
shared-memory ring) the rows each CTA has in flight, for K6 and K7 (a warp
copy, `warp_plan`) the loads each lane has in flight. K4 and K5 copy with
the TMA, which needs 16-byte aligned addresses: on the card they refuse a
source whose base address is not a multiple of 16 bytes (e.g. a view at an
odd word offset). K6 and K7 take any source, in 4-byte units where a row's
width or a base address is not a multiple of 16 bytes.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from clann_tpu_torch.ops import _build

# Launches of each kernel made by its wrapper (the plain versions never
# count). A run resets them and reads them back to show that its path went
# through the kernel.
PAGES_LAUNCHES = 0  # K4
GROUP8_LAUNCHES = 0  # K5
FLAT1D_LAUNCHES = 0  # K6
ROWS_LAUNCHES = 0  # K7

INFLIGHT_CHOICES = (1, 2, 4, 8, 16, 32)
BULK_INFLIGHT = 32  # K4's and K5's default: rows in flight per CTA (the fastest on an H100)
WARP_INFLIGHT = 8  # K6's and K7's default: loads in flight per lane at most
# 16-byte loads a lane holds at once, at most: 32 take 128 registers and
# leave one CTA of 8 warps per SM, which is slower at 512-byte rows
WARP_VEC16_INFLIGHT = 16
WARP_THREADS = 256  # threads per CTA of warp_gather_kernel (csrc/gather.cu)
WARP_CTAS_PER_SM = 8  # K6 / K7 grid: CTAs per SM at most; a warp loops over the runs beyond


def reset_launches() -> None:
    global PAGES_LAUNCHES, GROUP8_LAUNCHES, FLAT1D_LAUNCHES, ROWS_LAUNCHES
    PAGES_LAUNCHES = GROUP8_LAUNCHES = FLAT1D_LAUNCHES = ROWS_LAUNCHES = 0


def _words(t: torch.Tensor, name: str) -> torch.Tensor:
    if t.element_size() != 4 or t.is_complex() or t.dtype == torch.bool:
        raise ValueError(f"{name} must hold 32-bit words, got {t.dtype}")
    return t if t.dtype == torch.int32 else t.view(torch.int32)


def _check(src: torch.Tensor, idx: torch.Tensor, inflight: int) -> None:
    if idx.dtype != torch.int32 or idx.dim() != 1:
        raise ValueError(f"idx must be a 1-D int32 tensor, got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != src.device:
        raise ValueError(f"idx on {idx.device}, source on {src.device}")
    if inflight not in INFLIGHT_CHOICES:
        raise ValueError(f"inflight={inflight} not in {INFLIGHT_CHOICES}")


def _rows_plain(src2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """src2d[idx] with rows of zeros where idx lies outside [0, rows)."""
    n = src2d.shape[0]
    valid = (idx >= 0) & (idx < n)
    if n == 0:
        return torch.zeros((idx.shape[0], src2d.shape[1]), dtype=src2d.dtype,
                           device=src2d.device)
    out = torch.index_select(src2d, 0, torch.clamp(idx, 0, n - 1).to(torch.int64))
    return out.masked_fill(~valid[:, None], 0)


# the library's launchers, bound once the library is loaded (a wrapper's call
# then costs one dict lookup, not a load and an attribute lookup)
_LAUNCHERS: dict = {}


def _launcher(fn_name: str, src: torch.Tensor):
    if not src.is_cuda:
        raise ValueError(f"unsupported device {src.device}")
    fn = _LAUNCHERS.get(fn_name)
    if fn is None:
        fn = _LAUNCHERS[fn_name] = getattr(_build.load_library(), fn_name)
    return fn


def _stream(device_index: int) -> int:
    """The current stream of the card, as a raw pointer (the capture
    stream inside `torch.cuda.graph`), without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def _launch(fn_name: str, args, src: torch.Tensor, what: str) -> None:
    fn = _launcher(fn_name, src)
    dev = src.get_device()
    code = fn(*args, dev, _stream(dev))
    if code:
        _build.check(_build.load_library(), code, what)


class WarpPlan(NamedTuple):
    """The launch of warp_gather_kernel (K6, K7) for one call."""
    vec16: bool  # 16-byte units (else 4-byte)
    su: int  # units per row
    run: int  # rows per run, a power of two <= 32
    per_lane: int  # units each lane copies in a whole run: run * su / 32
    inflight: int  # the kernel instance: loads in flight per lane
    n_runs: int  # runs of the call, ceil(n_rows / run)
    grid: int  # CTAs of WARP_THREADS


def fill_warps(sms: int) -> int:
    """Warps of warp_gather_kernel's largest grid on a card of `sms` SMs."""
    return sms * WARP_CTAS_PER_SM * (WARP_THREADS // 32)


def warp_plan(width: int, n_rows: int, inflight: int, *, aligned16: bool,
              sms: int) -> WarpPlan:
    """Rows of `width` words copied in 16-byte units where the width and
    both base addresses (`aligned16`) allow, else in 4-byte units. A run
    takes the fewest rows whose units fill whole warp steps,
    32 / gcd(su, 32), so no lane idles, doubled while every lane's units
    stay within `inflight`, the run within 32 rows (one index per lane) and
    the call's runs at least as many as the warps of a full grid
    (`fill_warps`): fewer, longer runs leave warps idle, as 16-row runs did
    at the walk's 65,536 rows of 192 B (3% slower than 8-row runs on an
    H100, PERF.md). Where even the fewest rows exceed `inflight` units
    per lane, a lane copies them in waves. The kernel instance holds the
    fewest loads in flight (a power of two) that take a lane's units, at
    most `inflight` and at most WARP_VEC16_INFLIGHT 16-byte loads: its
    registers, and so the warps an SM keeps, follow what the rows need. The
    grid covers the runs with one warp each, at most WARP_CTAS_PER_SM CTAs
    per SM."""
    if width < 1 or inflight not in INFLIGHT_CHOICES:
        raise ValueError(f"width {width}, inflight {inflight}")
    vec16 = aligned16 and width % 4 == 0
    su = width // 4 if vec16 else width
    run = 32 // math.gcd(su, 32)
    warps = WARP_THREADS // 32
    while (run < 32 and 2 * run * su <= 32 * inflight
           and -(-n_rows // (2 * run)) >= fill_warps(sms)):
        run *= 2
    if run * su >= 2**31:
        raise ValueError(f"rows of {width} words are too wide for the warp gather")
    n_runs = -(-n_rows // run)
    grid = max(1, min(-(-n_runs // warps), sms * WARP_CTAS_PER_SM))
    per_lane = run * su // 32
    cap = min(inflight, WARP_VEC16_INFLIGHT) if vec16 else inflight
    instance = min(cap, 1 << (per_lane - 1).bit_length())
    return WarpPlan(vec16, su, run, per_lane, instance, n_runs, grid)


def pack_warp_plan(p: WarpPlan, device_index: int) -> int:
    """A plan and its card as the one 64-bit word clann_gather_warp takes
    (csrc/gather.cu::clann_gather_warp): su in bits 0-30, log2 run in 32-34, log2
    of the instance's inflight in 35-37, vec16 in 38, the grid in 39-55,
    the device in 56-62."""
    if p.grid >= 1 << 17 or not 0 <= device_index < 1 << 7:
        raise ValueError(f"grid {p.grid} or device {device_index} out of range")
    return (p.su | (p.run.bit_length() - 1) << 32 | (p.inflight.bit_length() - 1) << 35
            | int(p.vec16) << 38 | p.grid << 39 | device_index << 56)


@functools.lru_cache(maxsize=1024)
def _warp_word(width: int, n_rows: int, inflight: int, aligned16: bool,
               device_index: int) -> int:
    """warp_plan's packed launch word for one call shape on one card, kept:
    the LSH loops repeat a few shapes thousands of times, and a wrapper's
    call then costs one lookup, not a plan."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return pack_warp_plan(warp_plan(width, n_rows, inflight, aligned16=aligned16, sms=sms),
                          device_index)


def _warp_gather(src: torch.Tensor, n_src: int, width: int, idx: torch.Tensor,
                 out: torch.Tensor, inflight: int, what: str) -> None:
    """Launch warp_gather_kernel: out (n, width) words = rows of `width`
    words of the contiguous `src`, `n_src` of them, picked by idx."""
    fn = _launcher("clann_gather_warp", src)
    sp, op, n, dev = src.data_ptr(), out.data_ptr(), idx.shape[0], src.get_device()
    code = fn(sp, n_src, idx.data_ptr(), n, op,
              _warp_word(width, n, inflight, (sp | op) % 16 == 0, dev), _stream(dev))
    if code:
        _build.check(_build.load_library(), code, what)


def _cuda_operands(src: torch.Tensor, idx: torch.Tensor) -> None:
    if not (src.is_contiguous() and idx.is_contiguous()):
        raise ValueError("source and idx must be contiguous")


def _bulk_aligned(src: torch.Tensor) -> None:
    """K4 and K5 copy rows with bulk (TMA) copies, whose addresses must be
    multiples of 16 bytes; their rows always are, so the base must be."""
    if src.data_ptr() % 16:
        raise ValueError(f"the source's base address must be 16-byte aligned for the bulk "
                         f"copies of K4 / K5, got {src.data_ptr():#x}")


# --- K4 -------------------------------------------------------------------

def pages_plain(pages: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K4's function in plain PyTorch: (n, 8, 128) pages[idx]."""
    p = _words(pages, "pages")
    out = _rows_plain(p.reshape(p.shape[0], -1), idx)
    return out.view(-1, 8, 128).view(pages.dtype)


def gather_pages(pages: torch.Tensor, idx: torch.Tensor, *,
                 inflight: int = BULK_INFLIGHT) -> torch.Tensor:
    """K4: out[i] = pages[idx[i]] for (P, 8, 128) 4 KB pages."""
    global PAGES_LAUNCHES

    if pages.dim() != 3 or tuple(pages.shape[1:]) != (8, 128):
        raise ValueError(f"pages must be (P, 8, 128), got {tuple(pages.shape)}")
    p = _words(pages, "pages")
    _check(p, idx, inflight)
    if p.device.type == "cpu":
        return pages_plain(pages, idx)
    _cuda_operands(p, idx)
    _bulk_aligned(p)
    out = torch.empty((idx.shape[0], 8, 128), dtype=torch.int32, device=p.device)
    if idx.numel():
        _launch("clann_gather_pages", (p.data_ptr(), p.shape[0], idx.data_ptr(),
                                       idx.shape[0], out.data_ptr(), inflight),
                p, "clann_gather_pages launch")
        PAGES_LAUNCHES += 1
    return out.view(pages.dtype)


# --- K5 -------------------------------------------------------------------

def group8_plain(table: torch.Tensor, gidx: torch.Tensor) -> torch.Tensor:
    """K5's function in plain PyTorch: (8 n, W) aligned 8-row groups."""
    t = _words(table, "table")
    T, W = t.shape
    groups = t[: (T // 8) * 8].reshape(T // 8, 8 * W)
    return _rows_plain(groups, gidx).view(-1, W).view(table.dtype)


def gather_group8(table: torch.Tensor, gidx: torch.Tensor, *,
                  inflight: int = BULK_INFLIGHT) -> torch.Tensor:
    """K5: the aligned 8-row group [8 gidx[i], 8 gidx[i] + 8) of a (T, W)
    table for every i, as (8 n, W). A group not wholly inside the table
    reads as zeros."""
    global GROUP8_LAUNCHES

    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got {tuple(table.shape)}")
    t = _words(table, "table")
    _check(t, gidx, inflight)
    if t.device.type == "cpu":
        return group8_plain(table, gidx)
    _cuda_operands(t, gidx)
    _bulk_aligned(t)
    T, W = t.shape
    out = torch.empty((8 * gidx.shape[0], W), dtype=torch.int32, device=t.device)
    if gidx.numel():
        _launch("clann_gather_group8", (t.data_ptr(), T, W, gidx.data_ptr(), gidx.shape[0],
                                        out.data_ptr(), inflight),
                t, "clann_gather_group8 launch")
        GROUP8_LAUNCHES += 1
    return out.view(table.dtype)


# --- K6 -------------------------------------------------------------------

def flat1d_plain(flat: torch.Tensor, idx: torch.Tensor, *, width: int) -> torch.Tensor:
    """K6's function in plain PyTorch: (n W,) slices of a flat word array."""
    f = _words(flat, "flat")
    rows = f[: (f.shape[0] // width) * width].reshape(-1, width)
    return _rows_plain(rows, idx).reshape(-1).view(flat.dtype)


def gather_flat1d(flat: torch.Tensor, idx: torch.Tensor, *, width: int,
                  inflight: int = WARP_INFLIGHT) -> torch.Tensor:
    """K6: out[i W : (i+1) W] = flat[idx[i] W : (idx[i]+1) W], (n W,)."""
    global FLAT1D_LAUNCHES

    if flat.dim() != 1 or width < 1:
        raise ValueError(f"flat must be 1-D and width >= 1, got {tuple(flat.shape)}, {width}")
    f = _words(flat, "flat")
    _check(f, idx, inflight)
    if f.device.type == "cpu":
        return flat1d_plain(flat, idx, width=width)
    _cuda_operands(f, idx)
    out = torch.empty((idx.shape[0] * width,), dtype=torch.int32, device=f.device)
    if idx.numel():
        _warp_gather(f, f.shape[0] // width, width, idx, out, inflight, "K6 gather_flat1d launch")
        FLAT1D_LAUNCHES += 1
    return out.view(flat.dtype)


# --- K7 -------------------------------------------------------------------

def rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7's function in plain PyTorch: (n, W) table[idx]."""
    return _rows_plain(_words(table, "table"), idx).view(table.dtype)


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *,
                inflight: int = WARP_INFLIGHT) -> torch.Tensor:
    """K7: out[r] = table[idx[r]] for a (T, W) table, (n, W)."""
    global ROWS_LAUNCHES

    if table.dim() != 2:
        raise ValueError(f"table must be 2-D, got {tuple(table.shape)}")
    t = _words(table, "table")
    _check(t, idx, inflight)
    if t.device.type == "cpu":
        return rows_plain(table, idx)
    _cuda_operands(t, idx)
    T, W = t.shape
    out = torch.empty((idx.shape[0], W), dtype=torch.int32, device=t.device)
    if idx.numel():
        _warp_gather(t, T, W, idx, out, inflight, "K7 gather_rows launch")
        ROWS_LAUNCHES += 1
    return out.view(table.dtype)
