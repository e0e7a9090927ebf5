"""The work counts against hand counts."""
from __future__ import annotations

import pytest

from port_bench.counts import peaks, work

#: the cell's fixed-effect shard with 2 genres a movie on average: 5 nonzeros a row
CELL = dict(nnz=2_500_033 * 5, rows=2_500_033, dim=1 + 17_312 + 3_410 + 19)


def test_sparse_pass_of_the_cell():
    flops, nbytes = work.sparse_pass(**CELL)
    assert flops == 2 * 12_500_165
    # 12,500,165 nonzeros × (4 B column id + 4 B value) + (2,500,033 + 20,742) × 4 B
    assert nbytes == 12_500_165 * 8 + (2_500_033 + 20_742) * 4 == 110_084_420


def test_sparse_pass_of_a_hand_made_block():
    # 3 rows, 4 columns, 5 nonzeros: 10 operations; 5 × 8 B + (3 + 4) × 4 B
    assert work.sparse_pass(5, 3, 4) == (10.0, 68.0)
    assert work.sparse_pass(5, 3, 4, item=8) == (10.0, 5 * 12 + 7 * 8)


def test_kernel_floor_matches_chip_smoke_less_window_ids():
    # chip_smoke.kernel_case: nnz·(8 + 4) + W_inst·4 + n·4 + dim·4; its config-5 row is
    # at half scale (2^20 rows, 25,165,824 nonzeros, W_inst = 6400): bound_ms 0.09156
    half = dict(nnz=(1 << 20) * 24, rows=1 << 20, dim=1 << 17)
    chip_smoke_bytes = half["nnz"] * 12 + 6400 * 4 + (1 << 20) * 4 + (1 << 17) * 4
    assert work.windowed_rmatvec_bytes(**half) == chip_smoke_bytes - 6400 * 4
    assert peaks.least_seconds(0.0, chip_smoke_bytes) * 1e3 == pytest.approx(0.09156, rel=1e-3)
    # chip_smoke's config-3 row: 58,720,256 nonzeros, 2^20 rows and columns, W_inst = 16640
    c3 = 58_720_256 * 12 + 16640 * 4 + 2 * (1 << 20) * 4
    assert peaks.least_seconds(0.0, c3) * 1e3 == pytest.approx(0.2129, rel=1e-3)
    assert work.windowed_rmatvec_bytes(**CELL) == 12_500_165 * 12 + (2_500_033 + 20_742) * 4


def test_lane_passes_and_least_seconds():
    f, b = work.lane_passes(1000.0)
    assert (f, b) == (2000.0, 4000.0)
    assert peaks.least_seconds(67e12, 0.0) == 1.0
    assert peaks.least_seconds(0.0, 3.35e12) == 1.0
    assert peaks.least_seconds(67e12, 6.7e12) == 2.0
