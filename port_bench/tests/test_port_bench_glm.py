"""The single-GLM cell on the CPU at a small size: its judge passes the port
at float64 and fails the bfloat16 control and the half-batch fault under
the limits set from the chip's readings; its result lines carry the
metrics the benchmark lists for it; its readers read the port's counters
and stages, and give None for a port without them; the work counts
against hand counts."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from port_bench import run, spec
from port_bench.counts import glm as glm_counts
from port_bench.counts import work
from port_bench.entries import glm_fit

CELL, CONFIG = "glm_kdd2010a.fit", "glm_kdd2010a"
_config = spec.config


def small_glm_config() -> dict:
    """The configuration at 2,000 rows and 5,000 columns, with a λ that
    leaves about 15% of the columns nonzero at this size."""
    cfg = copy.deepcopy(_config(spec.benchmark(), CONFIG))
    cfg["data"].update(rows=2000, columns=5000)
    cfg["fit"]["lambda"] = 2.0
    return cfg


@pytest.fixture
def small_glm(monkeypatch):
    """``spec.config`` answering with the small configuration."""
    monkeypatch.setattr(spec, "config", lambda bench, name: small_glm_config())


def _cell(seed, dtype=None) -> glm_fit.Cell:
    c = glm_fit.Cell(small_glm_config(), {}, seed=seed, device="cpu")
    if dtype is not None:
        c.dtype = dtype
    return c


def _fails(numbers: dict) -> bool:
    limits = spec.limits(CELL)
    return any(not v <= limits[k] for k, v in numbers.items())


def test_the_judge_passes_the_port_at_float64():
    c = _cell(2**31 + 21, torch.float64)
    c.setup()
    c.step()
    c.release()
    numbers = c.compare(c.outputs, c.reference())
    assert set(numbers) == set(spec.limits(CELL))
    assert all(abs(v) <= 1e-12 for v in numbers.values()), numbers


def test_the_control_is_not_correct():
    """The reference computed in bfloat16, in the program's place."""
    c = _cell(2**31 + 22)
    c.setup()
    got, _ = c.control()
    assert _fails(c.compare(got, c.reference()))


def test_the_half_batch_fault_in_the_reference_is_not_correct():
    c = _cell(2**31 + 23)
    c.setup()
    assert _fails(c.compare(c.reference(fault="half_batch"), c.reference()))


def _half_batch(monkeypatch):
    """Every odd row left out of the placed batch, the others weighted
    double (the mean over the half that is left)."""
    real = glm_fit.Cell.setup

    def setup(self):
        real(self)
        w = self.batch.weights
        w[1::2] = 0.0
        w[0::2] *= 2.0

    monkeypatch.setattr(glm_fit.Cell, "setup", setup)


def test_a_planted_half_batch_is_not_correct(small_glm, monkeypatch):
    _half_batch(monkeypatch)
    line = run.run_cell(CELL, 2**31 + 24, 0.2, False, device="cpu")
    assert line["correct"] is False, line["checks"]
    assert line["failed"] == line["attempted"] >= 1


def test_the_line_of_an_untraced_run(small_glm):
    line = run.run_cell(CELL, 2**31 + 25, 0.2, False, device="cpu")
    assert line["correct"] is True, line["checks"]
    want = {m["name"] for m in spec.cell_metrics(spec.benchmark(), CELL, "end_to_end")}
    assert set(line["metrics"]) == want == {"setup_s", "fit_s", "peak_device_gib"}
    assert set(line["checks"]) == set(spec.limits(CELL))


def test_the_line_of_a_traced_run(small_glm, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    line = run.run_cell(CELL, 2**31 + 26, 0.2, True, device="cpu")
    want = {m["name"] for m in spec.cell_metrics(spec.benchmark(), CELL, "per_layer")}
    # no device on the CPU: the kernel's roofline has nothing to read
    assert set(line["metrics"]) == want - {"windowed_rmatvec_roofline.glm"}
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert 0 < m["window_fill_pct"] <= 100
    assert m["owlqn_trials_per_iter"] >= 1
    assert all(m[f"glm_build_s.{s}"] >= 0 for s in ("ell", "fe_windows", "placement"))


class _Cell:
    build_stages = {"glm.ell": 1.5, "glm.fe_windows": 2.5, "glm.placement": 0.5}


def _ctx(cell=None):
    return run.Context(cell=cell or _Cell(), setup_s=1.0, window_s=1.0, steps=1, peak_bytes=0)


def _read(name, c):
    return run.read_metrics([{"name": name, "unit": "x"}], c).get(name, {}).get("value")


def _registry(monkeypatch, counts: dict):
    """The port's registry holding ``counts`` alone."""
    from photon_tpu_torch import obs
    from photon_tpu_torch.obs.metrics import MetricsRegistry

    reg = MetricsRegistry()
    for k, v in counts.items():
        reg.counter(k, v)
    monkeypatch.setattr(obs, "get_registry", lambda: reg)


def test_the_readers_of_the_port_counters(monkeypatch):
    _registry(monkeypatch, {"windows.nnz": 300, "windows.slots": 1000,
                            "owlqn.iterations": 100, "owlqn.trials": 130})
    c = _ctx()
    assert _read("window_fill_pct", c) == pytest.approx(30.0)
    assert _read("owlqn_trials_per_iter", c) == pytest.approx(1.3)
    assert _read("glm_build_s.ell", c) == 1.5
    assert _read("glm_build_s.fe_windows", c) == 2.5
    assert _read("glm_build_s.placement", c) == 0.5


def test_the_readers_give_none_for_a_port_without_the_counters(monkeypatch):
    """The parent: no window or OWL-QN counters, no ``glm.*`` stages."""
    _registry(monkeypatch, {"re.lanes_fused": 5})

    class Parent:
        build_stages = {}

    c = _ctx(Parent())
    for name in ("window_fill_pct", "owlqn_trials_per_iter", "glm_build_s.ell",
                 "glm_build_s.fe_windows", "glm_build_s.placement"):
        assert _read(name, c) is None, name


def test_the_fit_work_against_a_hand_count():
    # 3 rows, 4 columns, 5 nonzeros, 7 passes, 4 iterations with m = 2:
    # pairs 0 + 1 + 2 + 2 = 5; 7 × 10 + 8·4·5 operations;
    # 7 × (5 × 8 + 7 × 4) + 4·4·4·5 bytes
    assert glm_counts.pairs_used(4, 2) == 5
    assert glm_counts.fit_work(5, 3, 4, passes=7, iterations=4, m=2) == (
        7 * 10 + 160.0, 7 * 68 + 320.0)
    # the cell at full size, 100 iterations of m = 10: 955 pairs
    assert glm_counts.pairs_used(100, 10) == 45 + 90 * 10
    flops, nbytes = work.sparse_pass(305_613_510, 8_407_752, 20_216_830)
    assert nbytes == 305_613_510 * 8 + (8_407_752 + 20_216_830) * 4


def test_the_step_work_reads_the_last_fit():
    c = _cell(2**31 + 27)
    c.setup()
    c.step()
    r = c.last.result
    nnz, rows, dim = int(c.arrays["indptr"][-1]), 2000, 5000
    assert c.step_work() == glm_counts.fit_work(nnz, rows, dim, passes=int(r.n_feature_passes),
                                                iterations=int(r.iterations), m=10)
    assert c.kernel_bytes() == work.windowed_rmatvec_bytes(nnz, rows, dim)
    assert np.isfinite(c.values).all() and c.attempted() == 1
