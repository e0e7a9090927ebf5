"""The fit's warm-up (``GameEstimator(precompile=True)``,
``descent.precompile_coordinates``) in the port, on the CPU at float64.

On the data of tests/test_torch_game.py (a fixed effect through the
window layout, per-user and per-item random effects) plus a
matrix-factorization coordinate, and on a streamed fit with a locked
fixed effect:

- a warmed fit equals the unwarmed one bit for bit: coefficients, scores,
  every sweep's ``dispatches`` and health rows;
- every warmed sweep reads ``compiles`` 0, while an unwarmed fit counts
  its sweep programs in sweep 0 and 0 after (the first dispatch at each
  program key is its one-time cost, as JAX's first call compiles);
- the warm-up's ``n_programs`` and program labels equal those of JAX's
  ``precompile_coordinates`` on the same coordinates, in memory, streamed
  and with a locked coordinate;
- a fault plan on ``descent.sweep`` fires at the same sweep with and
  without the warm-up, and the warm-up counts no arrival at any point.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.descent import precompile_coordinates as jprecompile
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.game.streaming import StreamConfig as JStreamConfig
from photon_tpu.optimize import problem as jprob
from photon_tpu.optimize.common import OptimizerConfig as JOptConfig
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.descent import precompile_coordinates
from photon_tpu_torch.game.estimator import GameEstimator
from photon_tpu_torch.game.streaming import StreamConfig
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.optimize.common import OptimizerConfig as TOptConfig
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import EventEmitter, faults
from test_torch_game import UPDATE, _arrays, _game_data, _jax_configs, _torch_configs
from test_torch_streaming_fit import _both_estimators
from test_torch_streaming_fit import _data as _stream_data

MF_UPDATE = UPDATE + ["mf"]


def _mf(cfg, prob, OptConfig, task):
    return cfg.MatrixFactorizationCoordinateConfig(
        "user", "item",
        prob.GLMProblemConfig(
            task=task, optimizer_config=OptConfig(max_iterations=4),
            regularization=prob.RegularizationContext(prob.RegularizationType.L2)),
        num_factors=3)


def _torch_est(**kw):
    cfgs = {**_torch_configs(), "mf": _mf(tcfg, tprob, TOptConfig, TTask.LOGISTIC_REGRESSION)}
    kw.setdefault("update_sequence", MF_UPDATE)
    return GameEstimator(task=TTask.LOGISTIC_REGRESSION, coordinate_configs=cfgs,
                         descent_iterations=2, dtype=torch.float64, device="cpu", **kw)


def _sweeps(result):
    return [r for r in result.tracker if "sweep_seconds" in r]


@pytest.fixture(scope="module")
def data():
    return _game_data(tdata, _arrays())


@pytest.fixture(scope="module")
def fits(data):
    out = {}
    for warm in (False, True):
        est = _torch_est(precompile=warm, keep_coordinates=True)
        out[warm] = (est, est.fit(data)[0])
    return out


def test_warmed_fit_equals_unwarmed_bit_for_bit(fits):
    (_, cold), (_, warm) = fits[False], fits[True]
    assert np.array_equal(cold.scores, warm.scores)
    assert np.array_equal(cold.model["fixed"].coefficients.means,
                          warm.model["fixed"].coefficients.means)
    for cid in ("user", "item"):
        for a, b in zip(cold.model[cid].buckets, warm.model[cid].buckets, strict=True):
            assert np.array_equal(a.coefficients, b.coefficients)
    for side in ("row_factors", "col_factors"):
        assert np.array_equal(getattr(cold.model["mf"], side), getattr(warm.model["mf"], side))
    assert [r["dispatches"] for r in _sweeps(cold)] == [r["dispatches"] for r in _sweeps(warm)]
    assert [r["health"] for r in _sweeps(cold)] == [r["health"] for r in _sweeps(warm)]
    assert fits[False][0].last_fit_stats["dispatches"] == fits[True][0].last_fit_stats["dispatches"]


def test_warmed_sweeps_count_no_one_time_cost(fits):
    cold_est, cold = fits[False]
    warm_est, warm = fits[True]
    assert [r["compiles"] for r in _sweeps(warm)] == [0, 0]
    rows = _sweeps(cold)
    # one sweep program per coordinate, first dispatched in sweep 0
    assert rows[0]["compiles"] == len(MF_UPDATE)
    assert [r["compiles"] for r in rows[1:]] == [0]
    assert cold_est.last_fit_stats["precompile"] is None
    assert cold_est.last_fit_stats["cold_dispatches"] == 2 * len(MF_UPDATE)
    # the warm-up covered every key the fit dispatched, and nothing else
    for coord in warm_est.last_coordinates.values():
        assert coord.programs.warmed == coord.programs.dispatched
    assert warm_est.last_fit_stats["cold_dispatches"] == 0
    report = warm_est.last_fit_stats["precompile"]
    assert report["n_programs"] == sum(
        len(c.programs.dispatched) for c in warm_est.last_coordinates.values())
    assert report["max_workers"] == 1
    assert {"n_programs", "wall_s", "sum_program_walls_s", "programs"} <= set(report)
    assert not {"lower_wall_s", "cache_hits", "cache_misses"} & set(report)
    assert all(set(p) == {"program", "wall_s", "backend_compile_s"} for p in report["programs"])


def test_fit_precompile_span_carries_n_programs(data):
    from photon_tpu_torch import obs

    obs.reset()
    obs.enable()
    try:
        est = _torch_est(precompile=True, update_sequence=UPDATE)
        est.fit(data)
        spans = obs.get_tracer().spans()
    finally:
        obs.disable()
        obs.reset()
    (pre,) = [s for s in spans if s.name == "fit.precompile"]
    assert pre.args["n_programs"] == est.last_fit_stats["precompile"]["n_programs"]
    programs = [s.args["program"] for s in spans if s.name == "precompile.program"]
    assert programs == [p["program"] for p in est.last_fit_stats["precompile"]["programs"]]


def _labels(report):
    return [p["program"] for p in report["programs"]]


def _jax_mf_configs():
    return {**_jax_configs(), "mf": _mf(jcfg, jprob, JOptConfig, JTask.LOGISTIC_REGRESSION)}


def test_in_memory_report_equals_jax(fits, monkeypatch):
    monkeypatch.setenv("PHOTON_SPARSE_WINDOWS", "1")
    jd = _game_data(jdata, _arrays())
    jest = JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_mf_configs(),
                      update_sequence=MF_UPDATE, descent_iterations=1, dtype=jnp.float64,
                      precompile=True)
    want = jest.fit(jd)[0].compile_stats["precompile"]
    got = fits[True][0].last_fit_stats["precompile"]
    assert got["n_programs"] == want["n_programs"] == 2 * len(MF_UPDATE)
    assert _labels(got) == _labels(want)


def _built(est, data, **kw):
    out = est._build_coordinates(data, **kw)
    return out[0] if isinstance(out, tuple) else out


def test_locked_coordinate_report_equals_jax(data):
    locked = frozenset({"fixed"})
    jd = _game_data(jdata, _arrays())
    jest = JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
                      update_sequence=UPDATE, dtype=jnp.float64)
    want = jprecompile(_built(jest, jd), locked=locked)
    tcoords = _built(_torch_est(update_sequence=UPDATE), data)
    tcoords.pop("mf")
    got = precompile_coordinates(tcoords, locked=locked)
    assert got["n_programs"] == want["n_programs"] == 5
    assert _labels(got) == _labels(want)
    assert _labels(got)[0] == "fixed:score"


def test_streamed_report_equals_jax():
    j_est, t_est = _both_estimators(with_fe=True)
    j_coords = _built(j_est, _stream_data(jdata, seed=4),
                      stream_cfg=JStreamConfig(chunk_rows=128))
    t_coords = _built(t_est, _stream_data(tdata, seed=4),
                      stream_cfg=StreamConfig(chunk_rows=128))
    locked = frozenset({"fixed"})
    want = jprecompile(j_coords, locked=locked)
    got = precompile_coordinates(t_coords, locked=locked)
    assert got["n_programs"] == want["n_programs"]
    assert _labels(got) == _labels(want)
    assert {"user:stream_solve", "user:stream_score", "fixed:stream_score"} <= set(_labels(got))


def _fixed_model(means):
    from photon_tpu_torch.game.model import Coefficients, FixedEffectModel, GameModel

    return GameModel(coordinates={"fixed": FixedEffectModel(
        coefficients=Coefficients(means=means, variances=None), feature_shard="g",
        task=TTask.LINEAR_REGRESSION)}, task=TTask.LINEAR_REGRESSION)


def test_streamed_warmed_fit_equals_unwarmed():
    data = _stream_data(tdata, seed=4)
    init = _fixed_model(np.random.default_rng(11).normal(size=6))
    out = {}
    for warm in (False, True):
        _, est = _both_estimators(with_fe=True)
        est = dataclasses.replace(est, precompile=warm, keep_coordinates=True)
        out[warm] = (est, est.fit(data, stream=128, initial_model=init)[0])
    (cold_est, cold), (warm_est, warm) = out[False], out[True]
    assert np.array_equal(cold.scores, warm.scores)
    for a, b in zip(cold.model["user"].buckets, warm.model["user"].buckets, strict=True):
        assert np.array_equal(a.coefficients, b.coefficients)
    assert [r["dispatches"] for r in _sweeps(cold)] == [r["dispatches"] for r in _sweeps(warm)]
    assert _sweeps(cold)[0]["compiles"] > 0
    assert [r["compiles"] for r in _sweeps(warm)] == [0, 0]
    report = warm_est.last_fit_stats["precompile"]
    assert report["n_programs"] == sum(
        len(c.programs.warmed) for c in warm_est.last_coordinates.values())
    for coord in warm_est.last_coordinates.values():
        assert coord.programs.dispatched <= coord.programs.warmed
    # the warm-up's chunks are not the stream's: the same chunk count
    assert (cold_est.last_fit_stats["stream"]["chunks"]
            == warm_est.last_fit_stats["stream"]["chunks"])


def test_sweep_fault_fires_at_the_same_sweep(data):
    """``descent.sweep@2`` fails the fit after its first sweep with and
    without the warm-up, and every fault point saw the same arrivals."""
    spec = "descent.sweep@2=error;descent.coordinate@999=error;coordinate.placement@999=error"
    out = {}
    for warm in (False, True):
        emitter = EventEmitter()
        seen = []
        emitter.register(lambda event, seen=seen: seen.append(event.payload["iteration"])
                         if event.name == "sweep_complete" else None)
        est = _torch_est(precompile=warm, update_sequence=UPDATE, events=emitter)
        with faults.injected(spec) as plan:
            with pytest.raises(faults.InjectedFault):
                est.fit(data)
            out[warm] = (seen, dict(plan._counts))
    assert out[False] == out[True]
    seen, counts = out[True]
    assert seen == [0]
    assert counts["descent.sweep"] == 2 and counts["descent.coordinate"] == len(UPDATE)
