"""Port parity of the descent's work counters and the placement fault point.

On tests/test_torch_game.py's data (a config-5-shaped GLMix at float64)
both packages fit 2 sweeps: each sweep row's ``dispatches`` (the
coordinate-level launch sites, not CUDA kernels) equals JAX's, the port's
sweep rows and coordinate rows carry every key of JAX's and
``last_fit_stats`` every one the port measures (all but the XLA compile
cache's and tracer's), and the exported ``descent.sweep`` spans carry the counters.
``tracker_granularity="coordinate"`` closes each coordinate with a sync
and changes no number. ``record_optimize_metrics`` gives JAX's
``optimize.*`` counters on the same GLM grid. The two placement cases of
tests/test_chaos.py: a transient ``coordinate.placement`` fault recovers
bit for bit with ``retry.attempts.device_put`` counted, a fatal one
raises without a retry; and a placement that fails mid-bucket leaves no
tensor of the failed attempt alive while it retries.
"""
from __future__ import annotations

import dataclasses
import gc
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import obs as jobs
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch import obs
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.optimize.common import record_optimize_metrics
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import faults
from photon_tpu_torch.util.faults import InjectedFault
from test_torch_checkpoint import _arrays, _data, _port, assert_models_identical
from test_torch_game import UPDATE, _game_data, _jax_configs, _torch_configs
from test_torch_game import _arrays as _ctr_arrays


@pytest.fixture(autouse=True)
def _clean():
    for o in (obs, jobs):
        o.reset()
        o.disable()
    faults.clear()
    yield
    faults.clear()
    for o in (obs, jobs):
        o.reset()
        o.disable()


def _t_est(**kw):
    return TEstimator(task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
                      update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64,
                      device="cpu", **kw)


@pytest.fixture(scope="module")
def fits():
    arrays = _ctr_arrays()
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
        jest = JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
                          update_sequence=UPDATE, descent_iterations=2, dtype=jnp.float64)
        jres = jest.fit(jd)[0]
    obs.enable()
    try:
        test = _t_est()
        tres = test.fit(td)[0]
        spans = [s for s in obs.get_tracer().spans()
                 if s.name in ("fit", "descent.sweep", "descent.coordinate")]
    finally:
        obs.disable()
        obs.reset()
    return jest, jres, test, tres, td, spans


def _sweeps(tracker):
    return [r for r in tracker if "sweep_seconds" in r]


def test_sweep_dispatches_equal_jax(fits):
    jest, jres, test, tres, _, _ = fits
    want, got = _sweeps(jres.tracker), _sweeps(tres.tracker)
    assert len(got) == len(want) == 2
    assert [r["dispatches"] for r in got] == [r["dispatches"] for r in want]
    # one fused step per coordinate per sweep
    assert [r["dispatches"] for r in got] == [len(UPDATE)] * 2
    assert test.last_fit_stats["dispatches"] == jest.last_fit_stats["dispatches"]
    assert [r["granularity"] for r in got] == ["sweep"] * 2


def test_rows_and_fit_stats_carry_every_jax_key(fits):
    jest, jres, test, tres, _, _ = fits
    for want, got in zip(jres.tracker, tres.tracker):
        assert set(want) <= set(got), set(want) - set(got)
    # the XLA compile cache's hits and misses and its trace and lowering
    # walls have no counterpart in the port, which compiles nothing
    xla_only = {"cache_hits", "cache_misses", "trace_s", "lowering_s"}
    assert set(jest.last_fit_stats) - xla_only <= set(test.last_fit_stats)
    assert not xla_only & set(test.last_fit_stats)
    assert test.last_fit_stats["ingest"] == jest.last_fit_stats["ingest"] == "host"
    # its one-time costs are the first dispatch at each program key (a
    # sweep and a score program per coordinate, as JAX compiles each
    # once) and the native builds it paid, if any
    stats = test.last_fit_stats
    assert stats["cold_dispatches"] == 2 * len(UPDATE)
    assert stats["backend_compiles"] == stats["cold_dispatches"] + stats["native_builds"]
    sweeps = _sweeps(tres.tracker)
    assert sweeps[0]["compiles"] >= len(UPDATE) and sweeps[1]["compiles"] == 0


def test_sweep_spans_carry_the_counters(fits):
    _, _, test, tres, _, spans = fits
    sweeps = [s for s in spans if s.name == "descent.sweep"]
    rows = _sweeps(tres.tracker)
    assert [s.args["dispatches"] for s in sweeps] == [r["dispatches"] for r in rows]
    for s in sweeps:
        assert {"compiles", "compile_seconds", "barrier_seconds", "granularity"} <= set(s.args)
    coords = [s for s in spans if s.name == "descent.coordinate"]
    assert [s.args["coordinate"] for s in coords] == UPDATE * 2
    assert all(s.args["dispatches"] == 1 for s in coords)
    by_id = {s.span_id: s for s in spans}
    assert all(by_id[s.parent_id].name == "descent.sweep" for s in coords)
    (fit,) = [s for s in spans if s.name == "fit"]
    assert fit.args["dispatches"] == test.last_fit_stats["dispatches"]


def test_coordinate_granularity_syncs_each_coordinate_and_changes_nothing(fits):
    _, _, test, tres, td, _ = fits
    est = _t_est()
    coordinates = est._build_coordinates(td)
    cd = run_coordinate_descent(coordinates, UPDATE, 2, tracker_granularity="coordinate")
    rows = _sweeps(cd.tracker)
    assert [r["granularity"] for r in rows] == ["coordinate"] * 2
    assert [r["barrier_seconds"] for r in rows] == [0.0, 0.0]
    assert [r["dispatches"] for r in rows] == [r["dispatches"] for r in _sweeps(tres.tracker)]
    np.testing.assert_array_equal(cd.total.numpy(), tres.scores)
    with pytest.raises(ValueError, match="tracker_granularity"):
        run_coordinate_descent(coordinates, UPDATE, 1, tracker_granularity="batch")


def test_dispatch_counter_mirrors_into_telemetry():
    obs.enable()
    d0 = obs.dispatch_count()
    for _ in range(3):
        obs.record_dispatch()
    obs.disable()
    obs.record_dispatch()  # counted whether or not telemetry is on
    assert obs.dispatch_count() - d0 == 4
    assert obs.get_registry().snapshot()["counters"]["descent.dispatches"] == 3


def test_dispatch_counter_loses_no_update_across_threads():
    """More threads than cores record at once, some inside a dispatch site
    (whose own launches count once); no increment is lost."""
    import os
    import threading

    workers = 2 * (os.cpu_count() or 2) + 2
    per = 2000
    d0 = obs.dispatch_count()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for _ in range(per):
            if i % 2:
                with obs.dispatch_site():
                    obs.record_dispatch()  # part of the site: not counted
            else:
                obs.record_dispatch()

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert obs.dispatch_count() - d0 == workers * per


@pytest.mark.parametrize("opt", ["LBFGS", "TRON", "OWLQN"])
def test_record_optimize_metrics_equals_jax(opt):
    from test_torch_model_training import _fit

    for o in (obs, jobs):
        o.enable()
    jres, tres, _, _ = _fit(opt, "dense")
    names = [f"optimize.{n}" for n in ("iterations", "n_evals", "n_hvp", "n_feature_passes")]
    got = {k: obs.get_registry().snapshot()["counters"][k] for k in names}
    assert got == {k: jobs.get_registry().snapshot()["counters"][k] for k in names}
    assert got["optimize.iterations"] == sum(int(r.result.iterations) for r in tres)
    obs.reset()
    obs.disable()
    record_optimize_metrics(tres[0].result)  # disabled: a no-op
    assert obs.get_registry().snapshot()["counters"] == {}


# -- the placement fault point (tests/test_chaos.py:227-252) ----------------


def _chaos_data():
    """tests/test_chaos.py's fit data: 300 rows, 8 FE and 4 RE columns,
    15 users."""
    return _data(tdata, _arrays(n=300, d_fe=8, users=15, seed=1))


def _chaos_est():
    return _port(grid=(1.0,), validation=False)


@pytest.fixture
def fast_retry(monkeypatch):
    monkeypatch.setattr(tcoord, "PLACEMENT_RETRY_POLICY",
                        dataclasses.replace(tcoord.PLACEMENT_RETRY_POLICY, base_s=0.0))


def test_transient_placement_fault_recovers_bit_exact(fast_retry):
    data = _chaos_data()
    baseline = _chaos_est().fit(data)[0]
    obs.enable()
    with faults.injected("coordinate.placement@1=unavailable"):
        res = _chaos_est().fit(data)[0]
    counters = obs.get_registry().snapshot()["counters"]
    assert counters.get("retry.attempts.device_put", 0) >= 1
    assert_models_identical(baseline.model, res.model)


def test_placement_fatal_fault_is_not_retried(fast_retry):
    data = _chaos_data()
    obs.enable()
    with faults.injected("coordinate.placement@1=error"):
        with pytest.raises(InjectedFault, match="injected fatal"):
            _chaos_est().fit(data)
    assert "retry.attempts.device_put" not in obs.get_registry().snapshot()["counters"]


class _FlakyBucket:
    """A host bucket whose ``score_feats`` read fails once with a transient
    error, after its other float32 fields were placed; it records how many
    references two of those host arrays have at the failure and when the
    retry begins."""

    def __init__(self, bucket):
        self._b = bucket
        self.failed = False
        self.at_failure = None
        self.at_retry = None

    def _refs(self):
        return [sys.getrefcount(self._b.features), sys.getrefcount(self._b.labels)]

    def __getattr__(self, name):
        if name == "score_feats" and not self.failed:
            self.failed = True
            self.at_failure = self._refs()
            raise InjectedFault("UNAVAILABLE: placement failed mid-bucket")
        if name == "features" and self.failed and self.at_retry is None:
            gc.collect()
            self.at_retry = self._refs()
        return getattr(self._b, name)


def test_retried_placement_drops_the_failed_attempts_tensors(fast_retry):
    data = _chaos_data()
    cfg = _chaos_est().coordinate_configs["per-user"]
    ds = tdata.build_random_effect_dataset(data, cfg, seed=0)
    flaky = _FlakyBucket(ds.buckets[0])
    baseline = flaky._refs()
    obs.enable()
    coord = tcoord.RandomEffectCoordinate.build(
        dataclasses.replace(ds, buckets=(flaky, *ds.buckets[1:])), cfg,
        dtype=torch.float32, device=torch.device("cpu"),
    )
    # the failed attempt's tensors shared the float32 host arrays' memory
    # (each held a reference); by the retry they are gone
    assert [r - b for r, b in zip(flaky.at_failure, baseline)] == [1, 1]
    assert flaky.at_retry == baseline
    assert obs.get_registry().snapshot()["counters"]["retry.attempts.device_put"] == 1
    np.testing.assert_array_equal(coord.device_buckets[0].features.numpy(),
                                  ds.buckets[0].features)
