"""The port's fleet plane (photon_tpu_torch/obs/fleet.py) against the JAX
package's (photon_tpu/obs/fleet.py), case by case with tests/test_fleet.py.

The pure functions take the same inputs in both packages and must give
the same outputs exactly (the histogram merge, the snapshot merge, the
skew rows, the headline ratio, ``obs_dir``, ``process_info``'s
validation, the ``/metrics`` fleet families, the offline report less its
wall stamps, and the breakdown's join for the same tracker rows and the
same per-coordinate flops and bytes). Files cross over: the port's
heartbeat docs and sweep rows are read by JAX's readers, and JAX's by the
port's. A fit with the publisher armed has the same ``dispatches`` and
the same model, bit for bit. The two-rank case runs in Gloo CPU processes
(tests/torch_mesh_worker.py): both ranks write ``p0/`` and ``p1/``, the
stalled rank is the straggler, and a rank stopped with SIGSTOP goes stale
for rank 0's watcher thread while rank 0's main thread waits in a Gloo
collective (the wait releases the GIL), then comes back.
"""
from __future__ import annotations

import json
import math
import os
import time

import numpy as np
import pytest
import torch

from photon_tpu.obs import fleet as jfleet
from photon_tpu.obs import http as jhttp
from photon_tpu.obs.metrics import MetricsRegistry as JRegistry
from photon_tpu_torch import obs
from photon_tpu_torch.cli import fleet_report as fleet_cli
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.estimator import GameEstimator
from photon_tpu_torch.obs import fleet, flight, http, series
from photon_tpu_torch.obs.fleet import FleetPublisher, compute_skew, merge_histograms
from photon_tpu_torch.obs.metrics import MetricsRegistry, percentile_from_buckets
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.types import TaskType
from test_torch_mesh import _assert_models_close, a7_ranks  # noqa: F401 - the two-rank fixture
import torch_mesh_worker as worker


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    for var in ("PHOTON_OBS_PROCESS", "PHOTON_OBS_FLEET", "PHOTON_OBS_HEARTBEAT_S",
                "PHOTON_FLEET_STRAGGLER_X", "PHOTON_FLEET_STALE_X", "PHOTON_COMM_GBPS",
                "PHOTON_DEVICE_GFLOPS"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    obs.disable()
    fleet.stop_publisher()
    yield
    fleet.stop_publisher()
    jfleet.stop_publisher()
    series.stop_flusher()
    flight.disable()
    obs.reset()
    obs.disable()


def _small_fit(seed=3, n=300, users=24, d_fe=5, d_re=3, sweeps=2, **est_kw):
    """tests/test_fleet.py's fit in the port, on the CPU at float64."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, users, size=n)
    x = rng.normal(size=(n, d_fe))
    xr = rng.normal(size=(n, d_re))
    y = x @ rng.normal(size=d_fe) * 0.3 + rng.normal(size=n) * 0.1
    data = tdata.GameData.build(
        labels=y,
        feature_shards={"g": tdata.CSRMatrix.from_dense(x), "u": tdata.CSRMatrix.from_dense(xr)},
        id_tags={"userId": [f"u{i}" for i in ids]},
    )
    opt = tprob.GLMProblemConfig(
        task=TaskType.LINEAR_REGRESSION,
        regularization=tprob.RegularizationContext(tprob.RegularizationType.L2),
        optimizer_config=OptimizerConfig(max_iterations=4),
    )
    est = GameEstimator(
        task=TaskType.LINEAR_REGRESSION,
        coordinate_configs={
            "fixed": tcfg.FixedEffectCoordinateConfig(
                feature_shard="g", optimization=opt, regularization_weights=(1.0,)),
            "user": tcfg.RandomEffectCoordinateConfig(
                random_effect_type="userId", feature_shard="u", optimization=opt,
                regularization_weights=(1.0,)),
        },
        update_sequence=["fixed", "user"], descent_iterations=sweeps, seed=seed,
        dtype=torch.float64, device="cpu", **est_kw,
    )
    return est, data


def _publisher(tmp_path, index=0, count=2, interval_s=60.0):
    """A constructed (not started) publisher installed as the process-global
    one, under ``obs/p<index>``."""
    info = fleet.ProcessInfo(index=index, count=count, host="testhost", pid=os.getpid())
    pub = FleetPublisher(os.path.join(str(tmp_path), "obs", f"p{index}"), interval_s=interval_s,
                         info=info)
    fleet._publisher = pub
    return pub


def _sweep_row(p, it, start, sweep_s, barrier_s=0.05):
    return {"process_index": p, "iteration": it, "start_wall_s": start,
            "arrival_wall_s": start + sweep_s - barrier_s, "sweep_seconds": sweep_s,
            "barrier_seconds": barrier_s}


# -- bucket-exact histogram merging ----------------------------------------------


def test_merge_empty_identity():
    assert merge_histograms([]) == jfleet.merge_histograms([]) == {
        "count": 0, "sum": 0.0, "min": None, "max": None, "buckets": {}}
    r = MetricsRegistry()
    for v in (1.0, 2.0, 4.0):
        r.histogram("h", v)
    h = r.snapshot()["histograms"]["h"]
    merged = merge_histograms([merge_histograms([]), h])
    assert merged == jfleet.merge_histograms([jfleet.merge_histograms([]), h])
    assert merged["count"] == 3 and merged["buckets"] == h["buckets"]


def test_merge_is_bucket_exact_vs_pooled_registry():
    """N per-process histograms merge to exactly the buckets one registry
    holds for the pooled samples, as JAX's merge does on the same input."""
    rng = np.random.default_rng(7)
    parts = [rng.lognormal(0, 1, 400), rng.lognormal(1, 0.5, 250), rng.lognormal(-1, 2, 100)]
    regs = [MetricsRegistry() for _ in parts]
    pooled = MetricsRegistry()
    for reg, vals in zip(regs, parts):
        for v in vals:
            reg.histogram("lat", v)
            pooled.histogram("lat", v)
    snaps = [r.snapshot()["histograms"]["lat"] for r in regs]
    merged = merge_histograms(snaps)
    ref = pooled.snapshot()["histograms"]["lat"]
    assert merged["buckets"] == ref["buckets"] and merged["count"] == ref["count"]
    assert merged["sum"] == pytest.approx(ref["sum"])
    assert merged["min"] == ref["min"] and merged["max"] == ref["max"]
    assert merged == jfleet.merge_histograms(snaps)


def test_merged_percentiles_within_documented_tolerance():
    rng = np.random.default_rng(0)
    parts = [rng.lognormal(0, 1, 500), rng.lognormal(1, 0.5, 300)]
    regs = [MetricsRegistry() for _ in parts]
    for reg, vals in zip(regs, parts):
        for v in vals:
            reg.histogram("h", v)
    snaps = [r.snapshot() for r in regs]
    merged = fleet.merge_snapshots(snaps)
    assert merged == jfleet.merge_snapshots(snaps)
    pooled = np.concatenate(parts)
    for q in (50, 90, 99):
        ref = float(np.percentile(pooled, q))
        got = merged["histograms"]["h"][f"p{q}"]
        assert abs(got - ref) / ref < 0.06, (q, got, ref)


def test_merge_nonfinite_outlier_buckets():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    r1.histogram("h", 1.0)
    r1.histogram("h", float("nan"))
    r2.histogram("h", float("inf"))
    r2.histogram("h", 2.0)
    hs = [r1.snapshot()["histograms"]["h"], r2.snapshot()["histograms"]["h"]]
    merged = merge_histograms(hs)
    assert merged == jfleet.merge_histograms(hs)
    assert merged["count"] == 4 and merged["nonfinite"] == 2
    assert merged["buckets"][str(10**6)] == 2
    assert math.isfinite(merged["sum"])
    assert merged["min"] == 1.0 and merged["max"] == 2.0
    assert percentile_from_buckets(merged, 50) is not None


def test_merge_snapshots_sums_counters_and_drops_gauges():
    r1, r2 = MetricsRegistry(), MetricsRegistry()
    r1.counter("descent.sweeps", 3)
    r2.counter("descent.sweeps", 4)
    r2.counter("io.records", 10)
    r1.gauge("mem.live_bytes", 100)
    snaps = [r1.snapshot(), r2.snapshot()]
    merged = fleet.merge_snapshots(snaps)
    assert merged == jfleet.merge_snapshots(snaps)
    assert merged["counters"] == {"descent.sweeps": 7, "io.records": 10}
    assert merged["gauges"] == {}


# -- the /metrics fleet families --------------------------------------------------


def test_fleet_families_monotonic_across_registry_clear(tmp_path):
    pub = _publisher(tmp_path)
    reg = pub._registry
    obs.enable()
    mono = http.CounterMonotonicity()
    reg.counter("descent.sweeps", 5)
    pub.write_heartbeat()
    fam = http.parse_prometheus_text(http.fleet_prometheus_text(mono))
    assert fam["photon_fleet_descent_sweeps_total"]["samples"][0][2] == 5
    reg.clear()
    reg.counter("descent.sweeps", 2)
    pub.write_heartbeat()
    fam = http.parse_prometheus_text(http.fleet_prometheus_text(mono))
    assert fam["photon_fleet_descent_sweeps_total"]["samples"][0][2] == 7
    assert fam["photon_proc_descent_sweeps_total"]["samples"][0][2] == 7


def _write_workers(root, pkg, registry_cls, counts=((0, 3), (1, 4))):
    """Two workers' heartbeat docs under ``root``, written by ``pkg``'s
    publisher."""
    for k, n in counts:
        reg = registry_cls()
        reg.counter("descent.sweeps", n)
        reg.gauge("health.loss.fixed", 0.5 + k)
        for v in (0.1 * (k + 1), 0.2 * (k + 1)):
            reg.histogram("descent.sweep_seconds", v)
        info = pkg.ProcessInfo(index=k, count=2, host="h", pid=100 + k)
        pkg.FleetPublisher(os.path.join(root, f"p{k}"), interval_s=60.0, info=info,
                           registry=reg).write_heartbeat()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_fleet_prometheus_text_per_process_and_aggregate(tmp_path, writer):
    """One scrape carries the labeled per-process samples and the fleet
    aggregate (fleet = Σ per-process); the port's text equals JAX's on the
    same heartbeat docs, whichever package wrote them."""
    obs.enable()
    root = os.path.join(str(tmp_path), "obs")
    _write_workers(root, *((fleet, MetricsRegistry) if writer == "port" else (jfleet, JRegistry)))
    fleet._publisher = FleetPublisher(os.path.join(root, "p0"), interval_s=60.0, info=fleet.
                                      ProcessInfo(index=0, count=2, host="h", pid=1))
    jfleet._publisher = jfleet.FleetPublisher(os.path.join(root, "p0"), interval_s=60.0,
                                              info=jfleet.ProcessInfo(0, 2, "h", 1))
    text = http.fleet_prometheus_text(None)
    assert text == jhttp.fleet_prometheus_text(None)
    fams = http.parse_prometheus_text(text)
    procs = fams["photon_proc_descent_sweeps_total"]["samples"]
    assert {lbl["process"] for _n, lbl, _v in procs} == {"0", "1"}
    assert sum(v for _n, _l, v in procs) == 7
    assert fams["photon_fleet_descent_sweeps_total"]["samples"][0][2] == 7
    assert "photon_proc_health_loss_fixed" in fams
    assert fams["photon_fleet_descent_sweep_seconds"]["type"] == "summary"


# -- namespacing, process info ------------------------------------------------------


@pytest.mark.parametrize("value", ["1/4", "0/1", "4/4", "junk", "-1/2", "1"])
def test_process_info_env_override_and_validation(monkeypatch, value):
    monkeypatch.setenv("PHOTON_OBS_PROCESS", value)
    try:
        want = jfleet.process_info()
    except ValueError:
        with pytest.raises(ValueError, match="PHOTON_OBS_PROCESS"):
            fleet.process_info()
        return
    got = fleet.process_info()
    assert (got.index, got.count, got.host, got.pid) == (want.index, want.count, want.host,
                                                         want.pid)
    assert series.process_info() == got  # the series rows' one resolution


@pytest.mark.parametrize("proc", [None, "2/4", "0/1"])
@pytest.mark.parametrize("flag", [None, "0", "1", "bogus"])
def test_obs_dir_equals_jax(monkeypatch, proc, flag):
    for var, value in (("PHOTON_OBS_PROCESS", proc), ("PHOTON_OBS_FLEET", flag)):
        if value is None:
            monkeypatch.delenv(var, raising=False)
        else:
            monkeypatch.setenv(var, value)
    if flag == "bogus":
        with pytest.raises(ValueError, match="PHOTON_OBS_FLEET"):
            fleet.obs_dir("/x/y")
        return
    assert fleet.obs_dir("/x/y") == jfleet.obs_dir("/x/y")
    assert fleet.fleet_enabled() is jfleet.fleet_enabled()


def test_obs_dir_single_process_layout_unchanged():
    assert fleet.obs_dir("/x/y") == os.path.join("/x/y", "obs")


@pytest.mark.parametrize("d", ["/a/obs/p3", "/a/obs", "/a/obs/px", "/a/obs/p3/"])
def test_fleet_root_of(d):
    assert fleet.fleet_root_of(d) == jfleet.fleet_root_of(d)


# -- heartbeats, staleness, files read across packages ---------------------------


def test_heartbeat_doc_and_staleness_read_by_both_packages(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_OBS_HEARTBEAT_S", "1.0")
    pub = _publisher(tmp_path, index=1, count=2)
    obs.enable()
    doc = pub.write_heartbeat()
    assert doc["process_index"] == 1 and doc["host"] == "testhost"
    root = fleet.fleet_root_of(pub.directory)
    for reader in (fleet, jfleet):
        docs = reader.read_worker_docs(root)
        assert len(docs) == 1 and docs[0]["process_index"] == 1
    now = doc["heartbeat_wall_s"]
    for dt, status in ((0.5, "ok"), (4.0, "stale"), (10.0, "dead")):
        assert fleet.worker_status(doc, now + dt) == jfleet.worker_status(doc, now + dt) == status
    pub.stop()
    stopped = fleet.read_worker_docs(root)[0]
    assert stopped["stopped"] is True and fleet.worker_status(stopped, now + 1e6) == "ok"
    # and JAX's heartbeat doc, read by the port
    jpub = jfleet.FleetPublisher(os.path.join(root, "p0"), interval_s=60.0,
                                 info=jfleet.ProcessInfo(0, 2, "jhost", 7), registry=JRegistry())
    jpub.write_heartbeat()
    got = fleet.workers_summary(root, now)
    want = jfleet.workers_summary(root, now)
    assert got == want and [w["host"] for w in got] == ["jhost", "testhost"]


def test_torn_heartbeat_skipped(tmp_path):
    d = os.path.join(str(tmp_path), "obs", "p0")
    os.makedirs(d)
    with open(os.path.join(d, fleet.REGISTRY_FILENAME), "w") as f:
        f.write('{"process_index": 0, "trunc')
    assert fleet.read_worker_docs(os.path.join(str(tmp_path), "obs")) == []


# -- skew and stragglers ------------------------------------------------------------


def test_compute_skew_healthy_no_stragglers():
    rows = {0: [_sweep_row(0, it, 100.0 + it, 0.5) for it in range(3)],
            1: [_sweep_row(1, it, 100.01 + it, 0.52) for it in range(3)]}
    skew = compute_skew(rows, straggler_x=2.0)
    assert skew == jfleet.compute_skew(rows, straggler_x=2.0)
    assert len(skew) == 3 and all(r["stragglers"] == [] for r in skew)


def test_compute_skew_flags_late_starter():
    rows = {0: [_sweep_row(0, 0, 100.0, 0.5), _sweep_row(0, 1, 101.0, 6.5)],
            1: [_sweep_row(1, 0, 100.0, 0.5), _sweep_row(1, 1, 107.0, 0.5)]}
    skew = compute_skew(rows, straggler_x=2.0)
    assert skew == jfleet.compute_skew(rows, straggler_x=2.0)
    assert skew[0]["warmup"] and skew[0]["stragglers"] == []
    assert skew[1]["stragglers"] == [1]
    assert skew[1]["skew_ratio"]["1"] == pytest.approx(13.0, rel=0.01)


def test_max_skew_ratio_excludes_warmup():
    rows = {0: [_sweep_row(0, 0, 100.0, 0.3), _sweep_row(0, 1, 101.0, 0.3)],
            1: [_sweep_row(1, 0, 101.0, 0.3), _sweep_row(1, 1, 101.01, 0.3)]}
    skew = compute_skew(rows, straggler_x=2.0)
    assert fleet.max_skew_ratio(skew) == jfleet.max_skew_ratio(skew) < 1.1
    assert fleet.max_skew_ratio(skew[:1]) is None


def test_aggregate_once_emits_straggler_events_exactly_once(tmp_path):
    obs.enable()
    pub = _publisher(tmp_path)
    root = fleet.fleet_root_of(pub.directory)
    for p in (0, 1):
        os.makedirs(os.path.join(root, f"p{p}"), exist_ok=True)
        with open(os.path.join(root, f"p{p}", fleet.SWEEPS_FILENAME), "w") as f:
            f.write(json.dumps(_sweep_row(p, 0, 100.0, 0.5)) + "\n")
            f.write(json.dumps(_sweep_row(p, 1, 101.0 if p == 0 else 109.0, 0.5)) + "\n")
    pub.write_heartbeat()
    skew = pub.aggregate_once()
    assert skew[1]["stragglers"] == [1]
    pub.aggregate_once()
    snap = obs.get_registry().snapshot()
    assert snap["counters"]["fleet.stragglers"] == 1
    assert snap["gauges"]["fleet.workers"] == 1
    assert snap["gauges"]["fleet.skew_ratio_max"] == max(r["max_skew_ratio"] for r in skew)


def test_record_sweep_rows_read_by_both_packages(tmp_path):
    fleet.record_sweep(0, 0.5, 0.1)  # no publisher: nothing written
    pub = _publisher(tmp_path)
    obs.enable()
    fleet.record_sweep(0, 0.5, 0.1)
    fleet.record_sweep(1, 0.6, 0.2)
    pub.stop()
    root = fleet.fleet_root_of(pub.directory)
    rows = fleet.read_sweeps(root)
    jfleet.clear_sweeps_cache()
    assert jfleet.read_sweeps(root) == rows
    assert [r["iteration"] for r in rows[0]] == [0, 1]
    r = rows[0][0]
    assert r["arrival_wall_s"] - r["start_wall_s"] == pytest.approx(0.4, abs=1e-3)
    # JAX's rows, read by the port
    jpub = jfleet.FleetPublisher(os.path.join(root, "p1"), interval_s=60.0,
                                 info=jfleet.ProcessInfo(1, 2, "h", 1), registry=JRegistry())
    jpub.record_sweep(0, 0.5, 0.1)
    jpub.stop()
    fleet.clear_sweeps_cache()
    jfleet.clear_sweeps_cache()
    assert fleet.read_sweeps(root) == jfleet.read_sweeps(root)
    assert sorted(fleet.read_sweeps(root)) == [0, 1]


def test_record_sweep_discriminates_grid_runs(tmp_path):
    pub = _publisher(tmp_path)
    obs.enable()
    for it in (0, 1, 0, 1):
        pub.record_sweep(it, 0.5, 0.1)
    rows = fleet.read_sweeps(fleet.fleet_root_of(pub.directory))[0]
    assert [(r["run"], r["iteration"]) for r in rows] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    skew = compute_skew({0: rows}, straggler_x=2.0)
    assert skew == jfleet.compute_skew({0: rows}, straggler_x=2.0)
    assert [r["warmup"] for r in skew] == [True, False, True, False]


def test_obs_reset_clears_sweeps_cache(tmp_path):
    d = os.path.join(str(tmp_path), "obs", "p0")
    os.makedirs(d)
    with open(os.path.join(d, fleet.SWEEPS_FILENAME), "w") as f:
        f.write(json.dumps(_sweep_row(0, 0, 100.0, 0.5)) + "\n")
    root = os.path.join(str(tmp_path), "obs")
    assert fleet.read_sweeps(root)[0] and fleet._sweeps_cache
    obs.reset()
    assert fleet._sweeps_cache == {}
    assert fleet.read_sweeps(root)[0]


def test_read_sweeps_incremental_and_partial_tail(tmp_path):
    d = os.path.join(str(tmp_path), "obs", "p0")
    os.makedirs(d)
    path = os.path.join(d, fleet.SWEEPS_FILENAME)
    with open(path, "w") as f:
        f.write(json.dumps(_sweep_row(0, 0, 100.0, 0.5)) + "\n")
    root = os.path.join(str(tmp_path), "obs")
    assert len(fleet.read_sweeps(root)[0]) == 1
    with open(path, "a") as f:
        f.write(json.dumps(_sweep_row(0, 1, 101.0, 0.5)) + "\n")
        f.write('{"process_index": 0, "iteration": 2')
    assert [r["iteration"] for r in fleet.read_sweeps(root)[0]] == [0, 1]
    with open(path, "a") as f:
        f.write(', "start_wall_s": 102.0, "sweep_seconds": 0.5}\n')
    assert [r["iteration"] for r in fleet.read_sweeps(root)[0]] == [0, 1, 2]


# -- the publisher launches nothing and changes nothing --------------------------


def test_fleet_publisher_is_dispatch_and_model_neutral(tmp_path):
    """A fit with the publisher armed (its thread running) has the same
    sweep ``dispatches`` and the same model, bit for bit, as one without;
    its tap wrote one row per sweep."""
    def run(fleet_on):
        obs.reset()
        obs.enable()
        fleet.stop_publisher()
        if fleet_on:
            _publisher(tmp_path, interval_s=0.05).start()
        est, data = _small_fit(sweeps=3)
        result = est.fit(data)[0]
        fleet.stop_publisher()
        return result

    off, on = run(False), run(True)
    assert [r["dispatches"] for r in on.tracker if "sweep_seconds" in r] == [
        r["dispatches"] for r in off.tracker if "sweep_seconds" in r]
    np.testing.assert_array_equal(on.scores, off.scores)
    assert np.array_equal(on.model["fixed"].coefficients.means,
                          off.model["fixed"].coefficients.means)
    for a, b in zip(on.model["user"].buckets, off.model["user"].buckets):
        assert np.array_equal(a.coefficients, b.coefficients)
    assert len(fleet.read_sweeps(os.path.join(str(tmp_path), "obs")).get(0, [])) == 3


# -- the device-time breakdown -------------------------------------------------------


def test_device_breakdown_published_from_precompiled_fit(tmp_path):
    obs.enable()
    est, data = _small_fit(sweeps=3, precompile=True)
    est.fit(data)
    bd = fleet.get_breakdown()
    assert bd is not None
    assert bd["barrier_frac"] + bd["compute_frac"] + bd["comm_frac"] == pytest.approx(1.0,
                                                                                      abs=1e-4)
    assert set(bd["coordinates"]) == {"fixed", "user"}
    # off a mesh nothing crosses ranks: the rest of the sweep is compute
    assert all(d["comm_bytes"] == 0 and d["comm_frac"] == 0 for d in bd["coordinates"].values())
    assert "analytic flops" in bd["provenance"]["comm_compute_split"]
    gauges = obs.get_registry().snapshot()["gauges"]
    assert {"device.barrier_frac", "device.compute_frac.fixed", "device.comm_frac.user"} <= set(
        gauges)
    paths = obs.export_artifacts(str(tmp_path / "obs"))
    with open(paths["breakdown"]) as f:
        assert json.load(f)["breakdown"]["barrier_frac"] == bd["barrier_frac"]
    with open(paths["summary"]) as f:
        assert "device-time breakdown" in f.read()
    obs.reset()
    assert fleet.get_breakdown() is None


def test_device_breakdown_none_without_warmed_programs():
    obs.enable()
    est, data = _small_fit(sweeps=2, precompile=False)
    est.fit(data)
    assert fleet.get_breakdown() is None


class _JaxCoord:
    """A JAX-side coordinate whose one sweep executable JAX's pricing
    reads as ``flops`` and a census of ``sites`` (each a payload)."""

    def __init__(self, flops, sites):
        self.flops, self.sites = flops, sites

    def aot_executables(self):
        return {("sweep", False): self}


@pytest.mark.parametrize("tracker_kind", ["steady", "one_sweep", "zero_barrier"])
def test_device_time_breakdown_join_equals_jax(monkeypatch, tracker_kind):
    """For the same tracker rows, the same per-coordinate flops, bytes and
    sites and the same assumed rates, the port's join equals JAX's
    ``device_time_breakdown`` (pricing stubbed to those numbers),
    provenance text apart. The default rates differ (the port's are an
    H100's), so the test sets both."""
    from photon_tpu.analysis import hlo as jhlo
    from photon_tpu.analysis import spmd as jspmd

    monkeypatch.setenv("PHOTON_COMM_GBPS", "8")
    monkeypatch.setenv("PHOTON_DEVICE_GFLOPS", "50")

    prices = {"fixed": (4.0e6, [136, 8, 8]), "user": (2.5e6, [2048]), "mf": (1.0e5, [])}
    monkeypatch.setattr(jspmd, "executable_flops", lambda exe: exe.flops)
    monkeypatch.setattr(jhlo, "try_module_text", lambda exe: (exe, None))
    monkeypatch.setattr(jspmd, "communication_census", lambda exe: [
        jspmd.CollectiveSite(op="all-reduce", shape="?", nbytes=b, replica_groups="", line=1)
        for b in exe.sites])
    sweeps = {"steady": [(0.9, 0.1), (0.5, 0.05), (0.6, 0.12)], "one_sweep": [(0.4, 0.1)],
              "zero_barrier": [(0.5, 0.0), (0.5, 0.0)]}[tracker_kind]
    tracker = [{"iteration": i, "coordinate": "fixed", "seconds": 0.1} for i in range(2)] + [
        {"iteration": i, "sweep_seconds": s, "barrier_seconds": b}
        for i, (s, b) in enumerate(sweeps)]
    want = jfleet.device_time_breakdown(
        {cid: _JaxCoord(f, sites) for cid, (f, sites) in prices.items()}, tracker)
    got = fleet.breakdown_from_prices(
        {cid: {"flops": f, "comm_bytes": sum(sites), "collective_sites": len(sites)}
         for cid, (f, sites) in prices.items()}, tracker)
    for bd in (want, got):
        bd["provenance"].pop("comm_compute_split")
    assert got == want


# -- stale rings, series rows, /healthz, the offline report ---------------------------


def test_recover_stale_scans_process_subdirs(tmp_path):
    root = str(tmp_path / "obs")
    for k in (0, 1):
        d = os.path.join(root, f"p{k}")
        os.makedirs(d)
        rec = flight.FlightRecorder(os.path.join(d, "blackbox.ring"), capacity_bytes=8192)
        rec.append("sweep", {"iteration": 5 + k})
        rec.close(clean=False)
    assert flight.recover_stale(root) is not None
    for k in (0, 1):
        (dump,) = [f for f in os.listdir(os.path.join(root, f"p{k}"))
                   if f.startswith("blackbox-") and f.endswith(".json")]
        with open(os.path.join(root, f"p{k}", dump)) as f:
            doc = json.load(f)
        assert doc["recovered"] is True and doc["last_sweep"]["iteration"] == 5 + k


def test_series_rows_carry_process_identity_and_heartbeat(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_OBS_PROCESS", "1/2")
    obs.enable()
    obs.counter("x")
    row = series.SeriesFlusher(str(tmp_path / "s.jsonl"), interval_s=60.0).flush_once()
    assert row["process_index"] == 1 and row["host"]
    # phl-ok: PHL006 the row's wall stamp against wall now
    assert abs(row["heartbeat_wall_s"] - time.time()) < 30


def _stale_worker_and_straggler(root):
    info1 = fleet.ProcessInfo(index=1, count=2, host="h", pid=1)
    doc = FleetPublisher(os.path.join(root, "p1"), interval_s=60.0, info=info1,
                         registry=MetricsRegistry()).write_heartbeat()
    doc["heartbeat_wall_s"] -= 1e6
    with open(os.path.join(root, "p1", fleet.REGISTRY_FILENAME), "w") as f:
        json.dump(doc, f)
    for p, start in ((0, 101.0), (1, 111.0)):
        with open(os.path.join(root, f"p{p}", fleet.SWEEPS_FILENAME), "a") as f:
            f.write(json.dumps(_sweep_row(p, 0, 100.0, 0.5)) + "\n")
            f.write(json.dumps(_sweep_row(p, 1, start, 0.5)) + "\n")


def test_healthz_reports_fleet_workers_and_stragglers(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_OBS_HEARTBEAT_S", "0.2")
    obs.enable()
    pub = _publisher(tmp_path)
    pub.write_heartbeat()
    root = fleet.fleet_root_of(pub.directory)
    _stale_worker_and_straggler(root)
    fl = http.healthz_snapshot()["fleet"]
    assert [w["process_index"] for w in fl["workers"]] == [0, 1]
    assert 1 in fl["dead"] and fl["stragglers"] == [1]
    assert fl["max_skew_ratio"] > 2.0 and fl["sweeps_joined"] == 2
    # JAX's /healthz fleet section over the same files, its clock apart
    jfleet._publisher = jfleet.FleetPublisher(pub.directory, interval_s=60.0,
                                              info=jfleet.ProcessInfo(0, 2, "testhost", 1))
    want = jhttp.healthz_snapshot()["fleet"]
    for doc in (fl, want):
        for w in doc["workers"]:
            w.pop("heartbeat_age_s")
    assert fl == want


def test_fleet_report_document_equals_jax(tmp_path, capsys):
    obs.enable()
    root = os.path.join(str(tmp_path), "obs")
    for k in (0, 1):
        reg = MetricsRegistry()
        reg.counter("descent.sweeps", 2 + k)
        FleetPublisher(os.path.join(root, f"p{k}"), interval_s=60.0,
                       info=fleet.ProcessInfo(index=k, count=2, host="h", pid=k),
                       registry=reg).write_heartbeat()
        with open(os.path.join(root, f"p{k}", fleet.SWEEPS_FILENAME), "w") as f:
            f.write(json.dumps(_sweep_row(k, 0, 100.0, 0.5)) + "\n")
            f.write(json.dumps(_sweep_row(k, 1, 101.0 + 7 * k, 0.5)) + "\n")
    doc = fleet.fleet_report(root)
    want = jfleet.fleet_report(root)
    for d in (doc, want):
        d.pop("generated_wall_s")
        for w in d["workers"]:
            w.pop("heartbeat_age_s")
    assert doc == want
    assert doc["fleet"]["counters"]["descent.sweeps"] == 5
    assert doc["stragglers"][0]["process_index"] == 1 and doc["max_skew_ratio"] > 2.0
    # the offline reader: the run's out_root or its obs directory
    assert fleet_cli.main([str(tmp_path), "--strict"]) == 4
    assert "STRAGGLER: process 1" in capsys.readouterr().out
    with open(os.path.join(root, "fleet_report.json")) as f:
        assert json.load(f)["stragglers"] == doc["stragglers"]


# -- two ranks in a Gloo group ---------------------------------------------------------


def test_two_ranks_write_their_own_dirs_and_flag_the_stalled_rank(a7_ranks):  # noqa: F811
    got = [worker.load(a7_ranks, "fleet", 2, 1, r) for r in range(2)]
    root = os.path.join(a7_ranks, "fleet", "obs")
    assert [g["obs_dir"] for g in got] == [os.path.join(a7_ranks, "fleet", "obs", f"p{r}")
                                           for r in range(2)]
    for r in range(2):
        names = set(os.listdir(os.path.join(root, f"p{r}")))
        assert {"registry.json", "sweeps.jsonl", "metrics.json", "breakdown.json",
                "series.jsonl"} <= names
    skew = fleet.compute_skew(fleet.read_sweeps(root))
    assert skew == jfleet.compute_skew(jfleet.read_sweeps(root))
    assert [r["iteration"] for r in skew] == [0, 1] and skew[1]["stragglers"] == [1]
    with open(os.path.join(root, "fleet_report.json")) as f:
        report = json.load(f)
    assert [s["process_index"] for s in report["stragglers"]] == [1]
    assert all(w["status"] == "ok" and w["stopped"] for w in fleet.workers_summary(root))
    # the stopped rank went stale for rank 0's watcher thread while rank 0's
    # main thread waited in a Gloo collective, then came back
    seen = got[0]["seen"]
    assert seen["stale"] in ("stale", "dead") and seen["in_barrier_when_stale"]
    assert seen["ok_again"]
    # the breakdown: a measured barrier share and the census's bytes
    bd = got[0]["breakdown"]
    assert 0.0 <= bd["barrier_frac"] <= 1.0 and bd["coordinates"]["fixed"]["comm_bytes"] > 0
    # the warmed, armed, stalled fit is still the fit: within 1e-9 of the
    # unmeshed one (the meshed tolerance of tests/test_torch_mesh.py)
    plain = worker.port_estimator().fit(worker.port_data())[0]
    _assert_models_close(worker.model_arrays(plain.model), got[0]["model"])
    assert got[0]["dispatches"] == got[1]["dispatches"]
