"""The work of the fused scan's problem at the glove shape."""

import pytest

from benchmark import roofline


def test_glove_scan_of_10000_queries():
    q, n, d, k = 10_000, 1_183_514, 100, 10
    assert roofline.scan_flops(q, n, d) == pytest.approx(2.367e12, rel=1e-3)
    assert roofline.scan_bytes(q, n, d, k) == n * d * 2 + q * d * 4 + q * k * 8
    t, by = roofline.scan_bound_s(q, n, d, k)
    assert by == "flops" and t * 1e3 == pytest.approx(2.393, rel=1e-3)


@pytest.mark.parametrize("q, by", [(10_000, "flops"), (8, "bytes")])
def test_the_longer_bound_is_taken(q, by):
    t, which = roofline.scan_bound_s(q, 1_000_000, 128, 10)
    assert which == by
    assert t == max(roofline.scan_flops(q, 1_000_000, 128) / roofline.PEAK_BF16_FLOPS,
                    roofline.scan_bytes(q, 1_000_000, 128, 10) / roofline.PEAK_HBM_BYTES)
