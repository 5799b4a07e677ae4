"""Peaks of the card and the work of a kernel's problem.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at the
700 W limit). The work counts are of the *problem*, at its real sizes and
without padding, so a share of the bound reads the same whatever kernel
implements it.
"""

from __future__ import annotations

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12


def scan_flops(q: int, n: int, d: int) -> float:
    """A dense scan of q queries over n rows of d dims: q*n*d multiply-adds."""
    return 2.0 * q * n * d


def scan_bytes(q: int, n: int, d: int, k: int) -> float:
    """The bf16 base read once, the f32 queries read once, k (distance, id)
    pairs of 4 + 4 bytes written per query."""
    return n * d * 2.0 + q * d * 4.0 + q * k * 8.0


def scan_bound_s(q: int, n: int, d: int, k: int) -> tuple:
    """(seconds, "flops" | "bytes"): the least time the card could take."""
    t_f = scan_flops(q, n, d) / PEAK_BF16_FLOPS
    t_b = scan_bytes(q, n, d, k) / PEAK_HBM_BYTES
    return (t_f, "flops") if t_f >= t_b else (t_b, "bytes")
