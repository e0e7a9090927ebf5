"""The reader of ``re_fused_lane_pct`` on hand-made runs: the port's lane
counts by solve path, read from its registry."""
from __future__ import annotations

import pytest

from port_bench import run
from port_bench.entries import game_fit
from port_bench.tests.conftest import small_config


def read(name, c):
    return run.read_metrics([{"name": name, "unit": "%"}], c).get(name, {}).get("value")


@pytest.fixture
def ctx():
    from photon_tpu_torch import obs

    obs.reset()
    yield run.Context(cell=None, setup_s=1.0, window_s=1.0, steps=1, peak_bytes=0)
    obs.reset()


def test_the_fused_lane_share(ctx, monkeypatch):
    """None where the port counts no lane (a port without the counter
    reads the same), 100 on a fit whose every random-effect bucket took
    the kernel, and the plain lanes' share off it once they take the
    loop. The CPU has no kernel: its stand-in is the plain solve the
    kernel is held to, behind the kernel's side of the dispatch."""
    from photon_tpu_torch.optimize import lane_lbfgs

    assert read("re_fused_lane_pct", ctx) is None
    monkeypatch.setattr(lane_lbfgs, "plain_loop_reason", lambda problem, features: None)
    monkeypatch.setattr(lane_lbfgs, "minimize_lanes",
                        lambda problem, batch, w0: problem.solve(batch, w0))
    cell = game_fit.Cell(small_config("game_ctr_scale"), {}, seed=4, device="cpu")
    cell.setup()
    cell.step()
    assert read("re_fused_lane_pct", ctx) == 100.0
    # set-up solved every lane three times (the warm-up, then a fit of two
    # sweeps) and the step twice; a second step on the plain loop adds two
    monkeypatch.undo()
    cell.step()
    assert read("re_fused_lane_pct", ctx) == pytest.approx(100.0 * 5 / 7)
