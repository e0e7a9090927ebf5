"""The reader of ``fe_fused_solve_pct`` on hand-made runs: the port's
one-lane L-BFGS solves by path, read from its registry."""
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


def test_the_fused_solve_share(ctx, monkeypatch):
    """None where the port counts no one-lane solve (a port without the
    counters reads the same), 100 on a fit whose every fixed-effect solve
    took the fused iteration, and the plain solves' share off it once they
    take the loop. The CPU has no kernel: its stand-in is the plain solve
    the kernels are held to, behind the kernels' side of the dispatch."""
    from photon_tpu_torch.optimize import lbfgs, solo_lbfgs

    assert read("fe_fused_solve_pct", ctx) is None
    monkeypatch.setattr(solo_lbfgs, "plain_loop_reason", lambda problem, batch, w0: None)
    monkeypatch.setattr(
        solo_lbfgs, "minimize_solo",
        lambda problem, batch, w0, objective: lbfgs.minimize_lbfgs(
            None, w0, problem.config.optimizer_config,
            oracle=objective.directional_oracle(batch)))
    cell = game_fit.Cell(small_config("game_ctr_scale"), {}, seed=4, device="cpu")
    cell.setup()
    cell.step()
    assert read("fe_fused_solve_pct", ctx) == 100.0
    # set-up solved the fixed effect three times (the warm-up, then a fit
    # of two sweeps) and the step twice; a second step on the plain loop
    # adds two
    monkeypatch.undo()
    cell.step()
    assert read("fe_fused_solve_pct", ctx) == pytest.approx(100.0 * 5 / 7)
