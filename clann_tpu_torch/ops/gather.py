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
copy) the pieces each warp has in flight. K4 and K5 copy with the TMA, which
needs 16-byte aligned addresses: on the card they refuse a source whose
base address is not a multiple of 16 bytes (e.g. a view at an odd word
offset).
"""

from __future__ import annotations

import torch

# Launches of each kernel made by its wrapper (the plain versions never
# count). A run resets them and reads them back to show that its path went
# through the kernel.
PAGES_LAUNCHES = 0  # K4
GROUP8_LAUNCHES = 0  # K5
FLAT1D_LAUNCHES = 0  # K6
ROWS_LAUNCHES = 0  # K7

INFLIGHT_CHOICES = (1, 2, 4, 8, 16, 32)
BULK_INFLIGHT = 32  # K4's and K5's default: rows in flight per CTA (the fastest on an H100)


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


def _launch(fn_name: str, args, src: torch.Tensor, what: str) -> None:
    if not src.is_cuda:
        raise ValueError(f"unsupported device {src.device}")
    from clann_tpu_torch.ops import _build

    lib = _build.load_library()
    code = getattr(lib, fn_name)(*args, src.device.index,
                                 torch.cuda.current_stream(src.device).cuda_stream)
    _build.check(lib, code, what)


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
                  inflight: int = 8) -> torch.Tensor:
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
        _launch("clann_gather_flat1d", (f.data_ptr(), f.shape[0], width, idx.data_ptr(),
                                        idx.shape[0], out.data_ptr(), inflight),
                f, "clann_gather_flat1d launch")
        FLAT1D_LAUNCHES += 1
    return out.view(flat.dtype)


# --- K7 -------------------------------------------------------------------

def rows_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """K7's function in plain PyTorch: (n, W) table[idx]."""
    return _rows_plain(_words(table, "table"), idx).view(table.dtype)


def gather_rows(table: torch.Tensor, idx: torch.Tensor, *, inflight: int = 8) -> torch.Tensor:
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
        _launch("clann_gather_rows", (t.data_ptr(), T, W, idx.data_ptr(), idx.shape[0],
                                      out.data_ptr(), inflight),
                t, "clann_gather_rows launch")
        ROWS_LAUNCHES += 1
    return out.view(table.dtype)
