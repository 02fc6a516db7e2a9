"""The yardstick's bounds at the cells' shapes: the same least times as
the port's chip_smoke.bound gave for the same launches (PERF.md §6)."""

import pytest

from portbench import roofline


@pytest.mark.parametrize("N, Lq, band, ms", [
    (393_216, 40, 32, 0.0901),      # B3, swissprot_k5.reads100
    (3_072, 1728, 64, 0.0608),      # B3 at 5 kbp reads (PERF.md §6)
])
def test_sw_bound(N, Lq, band, ms):
    secs, by = roofline.bound(*roofline.sw_counts(N, Lq, band))
    assert by == "operations" and secs * 1e3 == pytest.approx(ms, rel=2e-3)


@pytest.mark.parametrize("R, Lq, band, ms", [
    (8192, 40, 32, 0.0188),         # R1, swissprot_k5.reads100
    (128, 1728, 64, 0.0254),        # R1 at 5 kbp reads (PERF.md §6)
])
def test_refine_bound(R, Lq, band, ms):
    secs, by = roofline.bound(*roofline.refine_counts(R, 10, Lq, band))
    assert by == "operations" and secs * 1e3 == pytest.approx(ms, rel=3e-3)


@pytest.mark.parametrize("Q, M, run, ms", [
    (8192, 3640, 0, 0.0476),        # B2 mono, CSR rows (PERF.md §6)
    (12288, 2200, 0, 0.0714),       # B2 mono, CSR rows of two shards
    (768, 608, 16, 0.00073),        # B2 mono, golden rows, runs of 16
])
def test_sort_vote_bound(Q, M, run, ms):
    secs, by = roofline.bound(*roofline.sort_vote_counts(Q, M, 8, run))
    assert by == "operations" and secs * 1e3 == pytest.approx(ms, rel=5e-3)


def test_bytes_bound_wins_when_ops_are_few():
    secs, by = roofline.bound(3.35e12, 1.0)
    assert by == "bytes" and secs == pytest.approx(1.0)
