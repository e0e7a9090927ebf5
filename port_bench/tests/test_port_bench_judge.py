"""The judge: the reference follows the port, and the control and planted
faults come out not correct (on the CPU, at small sizes, under the limits
set from the chip's readings)."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from port_bench import run, spec
from port_bench.entries import game_fit
from port_bench.tests.conftest import small_config

CELL, CONFIG = "game_ctr_scale.fit", "game_ctr_scale"


def test_the_reference_follows_the_port_at_float64():
    c = game_fit.Cell(small_config(CONFIG), {}, seed=11, device="cpu")
    c.dtype = torch.float64
    c.setup()
    c.step()
    c.release()
    numbers = c.compare(c.outputs, c.reference())
    assert all(v <= 1e-6 for v in numbers.values()), numbers


def _fails(got: dict, want: dict, c) -> bool:
    limits = spec.limits(CELL)
    numbers = c.compare(got, want)
    return any(not v <= limits[k] for k, v in numbers.items())


def test_the_control_is_not_correct():
    """The reference computed in bfloat16, in the program's place."""
    c = game_fit.Cell(small_config(CONFIG), {}, seed=12, device="cpu")
    c.setup()
    got, _ = c.control()
    assert _fails(got, c.reference(), c)


# --- the planted faults: a whole run with the timed path broken underneath ---

def _unchanged_state(monkeypatch):
    """Each step returns the state it started from."""
    from photon_tpu_torch.game import descent

    real = descent.run_coordinate_descent
    monkeypatch.setattr(descent, "run_coordinate_descent",
                        lambda coords, order, sweeps, **kw: real(coords, order, 0, **kw))


def _half_batch(monkeypatch):
    """Every odd row left out, the others weighted double (the mean over
    the half that is left)."""
    real = game_fit.Cell.setup

    def setup(self):
        real(self)
        fe = self.coordinates["fixed"].batch.weights
        fe[1::2] = 0.0
        fe[0::2] *= 2.0
        for cid in ("user", "item"):
            for db in self.coordinates[cid].device_buckets:
                odd = (db.sample_pos % 2) == 1
                db.weights = torch.where(odd, torch.zeros_like(db.weights), 2 * db.weights)

    monkeypatch.setattr(game_fit.Cell, "setup", setup)


def _answer_altered(monkeypatch):
    """One row's summed score off by five where the fit produces it."""
    from photon_tpu_torch.game import descent

    real = descent.run_coordinate_descent

    def altered(*a, **kw):
        cd = real(*a, **kw)
        cd.total[7] += 5.0
        return cd

    monkeypatch.setattr(descent, "run_coordinate_descent", altered)


FAULTS = {"unchanged_state": _unchanged_state, "half_batch": _half_batch,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_is_not_correct(small_cells, monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    line = run.run_cell(CELL, 2**31 + 99, 0.2, False, device="cpu")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] == line["attempted"] >= 1


def test_an_unbroken_small_run_reads_below_the_fault(small_cells):
    """The same run without a fault: every number far under the half-batch
    reading, so the faults above fail on the fault and not on the size."""
    line = run.run_cell(CELL, 2**31 + 99, 0.2, False, device="cpu")
    assert all(c["value"] < 0.1 for c in line["checks"].values()), line["checks"]
    assert np.isfinite([c["value"] for c in line["checks"].values()]).all()
