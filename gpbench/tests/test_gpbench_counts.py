"""Operation and byte counts against hand counts at small sizes."""

from __future__ import annotations

import pytest

from gpbench import peaks
from gpbench.counts import exact_gp, svgp


def test_peaks_and_bound():
    assert peaks.bound_s(3.35e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_s(1.0, 67e12) == pytest.approx(1.0)
    # gram tile 4 × 2 over D = 3: 4·((4 + 2)·3 + 8) bytes, 8·(9 + 12) operations
    assert peaks.gram_tile_cost(4, 2, 3) == (4.0 * 26, 8 * 21.0)
    # symmetric 4 × 4: the 10 entries of the lower triangle
    assert peaks.gram_tile_cost(4, 4, 3, sym=True) == (4.0 * (24 + 16), 10 * 21.0)


def test_sweep_counts_by_hand():
    # n = m = 2, D = 1, Matérn-3/2 (family 2, VJP 6), sym, cotangent 5, epilogue 4:
    # 3 pairs · (3 + 5 + 6 + 4) + 4 ordered entries · 3
    assert peaks.sweep_flops(2, 2, 1, 2, True, 5, 4) == 3 * 18 + 12
    assert peaks.logpdf_contraction_cost(2, 1, 1, 2) == (4.0 * (3 + 4 + 4), 66.0)
    # gram VJP 2 × 3, D = 1, SE (family 0, VJP 3), plain: 6 pairs · (3 + 0 + 3 + 1) + 6·3
    assert peaks.gram_bwd_cost(2, 3, 1, 0, False) == (4.0 * (6 + 7), 6 * 7 + 18.0)


def test_exact_counts_by_hand():
    cfg = {"n": 4, "d": 2, "kernel": "matern32"}
    gram = 10 * (6 + 12)
    vjp = 10 * (6 + 5 + 6 + 4) + 16 * 6
    assert exact_gp.step_flops(cfg, {}) == pytest.approx(
        gram + 64 / 3 + 32 + 128 / 3 + vjp)
    # q = 3: cross gram 3·4·3·2, whitening solve 16·3, mean and variance 4·4·3
    assert exact_gp.query_flops(cfg, 3) == 72 + 48 + 48
    big = {"n": 8192, "d": 8, "kernel": "matern32"}
    assert exact_gp.step_flops(big, {}) == pytest.approx(5.53e11, rel=0.01)
    assert exact_gp.gram_tile_launches(big, 31) == []
    assert len(exact_gp.gram_tile_launches(big, 32)) == 1


def test_svgp_counts_by_hand():
    cfg, traffic = {"m": 2, "d": 1}, {"batch": 3}
    per = 3 + 12
    fwd = 3 * per + 6 * per + 8 / 3 + 2 * 4 * 3 + 6 * 2 * 3 + 2 * 4
    assert svgp.step_flops(cfg, traffic) == pytest.approx(3 * fwd)
    assert svgp.query_flops(cfg, 5) == 2 * 5 * per + 2 * 4 * 5 + 4 * 2 * 5
    big, bt = {"m": 512, "d": 8}, {"batch": 2048}
    assert svgp.step_flops(big, bt) == pytest.approx(3.50e9, rel=0.01)
    assert len(svgp.gram_bwd_launches(big, bt)) == 3
    assert len(svgp.gram_tile_launches(big, 511)) == 1
    assert len(svgp.gram_tile_launches(big, 512)) == 2
