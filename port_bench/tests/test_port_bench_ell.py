"""The readers of ``ell_fused_pass_pct`` and ``ell_matvec_roofline`` (and
``.glm``) on hand-made runs: fake tallies in the port's registry and a fake
device trace."""
from __future__ import annotations

import pytest
import torch

from port_bench import run
from port_bench.counts import peaks, work
from port_bench.entries import game_fit, glm_fit

KERNEL = ("void (anonymous namespace)::ell_matvec_kernel<float, float, 4>"
          "(int const*, float const*, float const*, float*, long long, int, int)")


def read(name, c):
    return run.read_metrics([{"name": name, "unit": "%"}], c).get(name, {}).get("value")


@pytest.fixture
def registry():
    from photon_tpu_torch import obs

    obs.reset()
    yield obs
    obs.reset()


def _ctx(cell=None, traced=None):
    return run.Context(cell=cell, setup_s=1.0, window_s=1.0, steps=1, peak_bytes=0,
                       traced=traced, traced_steps=1 if traced else 0)


def test_the_fused_pass_share(registry):
    """None where the port counts no ELL pass (a port without the tallies
    reads the same); the fused passes' share of all once it counts."""
    assert read("ell_fused_pass_pct", _ctx()) is None
    registry.tally("ell.passes_fused", 3)
    assert read("ell_fused_pass_pct", _ctx()) == 100.0
    registry.tally("ell.passes_plain")
    assert read("ell_fused_pass_pct", _ctx()) == pytest.approx(75.0)
    registry.reset()
    registry.tally("ell.passes_plain", 2)
    assert read("ell_fused_pass_pct", _ctx()) == 0.0


class _GlmCell:
    dtype = torch.float32

    def _shape(self):
        return 152_806_755, 4_203_876, 20_216_830


class _GameCell:
    dtype = torch.float32

    def _fe_shape(self):
        return 12_500_165, 2_500_033, 20_742

    def _shape(self):
        raise AssertionError("the GAME cell's pass is over its fixed effect")


def _trace(spans):
    return {"busy_s": 1.0, "window_s": 2.0, "kernels": {}, "device_ops": [], "idle_gaps": [],
            "kernel_spans": spans}


@pytest.mark.parametrize("name,cell", [("ell_matvec_roofline", _GameCell()),
                                       ("ell_matvec_roofline.glm", _GlmCell())])
def test_the_roofline_share(name, cell):
    """The pass's byte floor for the cell's own shape over 3.35 TB/s, over
    the kernel's mean interval a launch (two launches of 1 ms and 3 ms: 2
    ms each); the other kernels of the trace do not count."""
    spans = {KERNEL: [(0.0, 1000.0), (5000.0, 8000.0)],
             "void windowed_partials<float, 0>(int const*)": [(0.0, 9000.0)]}
    shape = cell._fe_shape() if isinstance(cell, _GameCell) else cell._shape()
    floor_s = work.sparse_pass(*shape)[1] / peaks.HBM_BYTES_PER_S
    assert read(name, _ctx(cell, _trace(spans))) == pytest.approx(100.0 * floor_s / 2e-3)


def test_the_floor_counts_nonzeros_once_in_the_values_type():
    """float64 values and vectors double the item's bytes; ids stay 4."""
    class Cell64(_GlmCell):
        dtype = torch.float64

    spans = {KERNEL: [(0.0, 1000.0)]}
    got = read("ell_matvec_roofline.glm", _ctx(Cell64(), _trace(spans)))
    nnz, rows, dim = _GlmCell()._shape()
    want = (nnz * 12 + (rows + dim) * 8) / peaks.HBM_BYTES_PER_S / 1e-3
    assert got == pytest.approx(100.0 * want)


def test_the_roofline_finds_nothing_to_read():
    """No traced run, or a trace without the kernel (the parent, the CPU):
    None."""
    assert read("ell_matvec_roofline", _ctx(_GameCell())) is None
    other = _trace({"void windowed_partials<float, 0>(int const*)": [(0.0, 10.0)]})
    assert read("ell_matvec_roofline", _ctx(_GameCell(), other)) is None
    assert read("ell_matvec_roofline.glm", _ctx(_GlmCell(), _trace({}))) is None


def test_the_entries_have_the_shapes_the_reader_asks_for():
    assert callable(game_fit.Cell._fe_shape) and callable(glm_fit.Cell._shape)
    assert not hasattr(glm_fit.Cell, "_fe_shape")
