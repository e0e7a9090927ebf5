"""Port parity of the telemetry core (photon_tpu_torch/obs, util/compile_watch,
util/sanitize) and of the counters that report through it.

Held against the JAX package on the same inputs: the metrics registry's
bucket indices, percentiles and snapshots (exact); the Chrome-trace,
manifest and summary exports of the same span sequence (the same events,
names, categories and args; times differ); ``series.jsonl`` rows (the
same keys). Then the port's own contracts: the memory ledger on the CPU
(zero device bytes), compile_watch's counts, the live plane and the
drivers' ``run_profile`` (artifacts, failure path, ``PHOTON_OBS=0``), the
unported switches naming ROADMAP A5b, and the ``retry.*`` /
``recovery.*`` counters under the JAX names.
"""
from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from photon_tpu.obs import metrics as jmetrics
from photon_tpu.obs import series as jseries
from photon_tpu.obs.export import chrome_trace as j_chrome_trace
from photon_tpu.obs.export import histogram_summary as j_histogram_summary
from photon_tpu.obs.export import phase_summary as j_phase_summary
from photon_tpu.obs.tracer import Tracer as JTracer
from photon_tpu_torch import obs
from photon_tpu_torch.cli import game_base
from photon_tpu_torch.obs import memory, metrics, series
from photon_tpu_torch.obs.export import chrome_trace, histogram_summary, phase_summary
from photon_tpu_torch.obs.tracer import Tracer
from photon_tpu_torch.util import compile_watch, faults, retry, sanitize


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PHOTON_OBS", "PHOTON_OBS_HTTP_PORT", "PHOTON_OBS_FLEET", "PHOTON_TRACE",
                "PHOTON_OBS_FLUSH_S", "PHOTON_OBS_RING_MB", "PHOTON_SANITIZE"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    yield
    obs.disable()
    obs.reset()
    faults.clear()


def _samples(kind: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if kind == "lognormal":
        return rng.lognormal(-4, 2, size=2000)
    if kind == "uniform":
        return rng.uniform(1e-6, 10, size=500)
    if kind == "edge":
        return np.array([0.0, -1.0, float("inf"), float("nan"), -float("inf"), 1e-300, 1e300,
                         1.0, 1.1, 1.21])
    return rng.exponential(0.05, size=1000)


KINDS = ("lognormal", "uniform", "edge", "exponential")


@pytest.mark.parametrize("kind", KINDS)
def test_bucket_indices_and_values_equal_jax(kind):
    xs = _samples(kind)
    got = [metrics._bucket_index(float(x)) for x in xs]
    assert got == [jmetrics._bucket_index(float(x)) for x in xs]
    for i in set(got):
        assert metrics._bucket_value(i) == jmetrics._bucket_value(i)


@pytest.mark.parametrize("kind", KINDS)
def test_percentiles_and_snapshot_equal_jax(kind):
    """The same operations on both registries give identical snapshots,
    percentiles included (exact: the same float arithmetic)."""
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    for r in (reg, jreg):
        for x in _samples(kind):
            r.histogram("h", float(x))
        r.counter("c", 3)
        r.counter("c", 0.5)
        r.gauge("g", 2.0)
    snap, jsnap = reg.snapshot(), jreg.snapshot()
    assert json.dumps(snap, sort_keys=True) == json.dumps(jsnap, sort_keys=True)
    for q in (1, 25, 50, 90, 99, 99.9, 100):
        assert reg.percentile("h", q) == jreg.percentile("h", q)
        assert metrics.percentile_from_buckets(snap["histograms"]["h"], q) == (
            jmetrics.percentile_from_buckets(jsnap["histograms"]["h"], q))
    later = metrics.MetricsRegistry.delta(snap, {"counters": {"c": 10, "d": 1}})
    assert later == jmetrics.MetricsRegistry.delta(jsnap, {"counters": {"c": 10, "d": 1}})


def _record(tracer, registry):
    """One span sequence: nesting, an instant, args, an error span."""
    with tracer.span("fit", grid=3) as sp:
        with tracer.span("descent.sweep", cat="sweep", iteration=0):
            tracer.instant("checkpoint", cat="lifecycle", seq=np.int64(4))
        sp.set(models=np.array([1, 2]))
    with pytest.raises(ValueError):
        with tracer.span("score.batch", rows=16):
            raise ValueError("boom")
    registry.histogram("score.batch_seconds", 0.25)
    registry.counter("score.batches", 2)


def _shape(doc):
    events = [{k: v for k, v in ev.items() if k not in ("ts", "dur", "pid", "tid")}
              for ev in doc["traceEvents"]]
    return sorted(events, key=lambda e: (e["ph"], e["name"]))


def test_chrome_trace_of_the_same_spans_equals_jax():
    tracer, jtracer = Tracer(enabled=True), JTracer(enabled=True, annotate_device=False)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    _record(tracer, reg)
    _record(jtracer, jreg)
    doc = chrome_trace(tracer, reg, meta={"driver": "x"})
    jdoc = j_chrome_trace(jtracer, jreg, meta={"driver": "x"})
    assert _shape(doc) == _shape(jdoc)
    assert set(doc) == set(jdoc) and doc["displayTimeUnit"] == jdoc["displayTimeUnit"]
    assert doc["otherData"]["metrics"] == jdoc["otherData"]["metrics"]
    assert doc["otherData"]["driver"] == "x"
    spans = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert spans["descent.sweep"]["args"]["parent_id"] == spans["fit"]["args"]["span_id"]
    assert spans["score.batch"]["args"]["error"] == "ValueError"
    assert spans["fit"]["dur"] >= spans["descent.sweep"]["dur"] >= 0
    # the per-phase and histogram summaries agree too
    assert {k: v["count"] for k, v in phase_summary(tracer).items()} == {
        k: v["count"] for k, v in j_phase_summary(jtracer).items()}
    assert histogram_summary(reg) == j_histogram_summary(jreg)


def test_disabled_tracer_measures_and_records_nothing():
    tracer = Tracer(enabled=False)
    with tracer.span("x") as sp:
        pass
    tracer.instant("i")
    assert sp.duration_s >= 0 and tracer.spans() == []
    obs.counter("c")
    obs.histogram("h", 1.0)
    assert obs.get_registry().snapshot()["counters"] == {}


def test_export_artifacts_and_manifest(tmp_path):
    obs.enable()
    with obs.span("score.stream", rows=3):
        obs.counter("score.batches")
        obs.histogram("score.e2e_seconds", 0.01)
    paths = obs.export_artifacts(tmp_path, meta={"driver": "t"})
    assert set(paths) == {"trace", "metrics", "manifest", "memory", "summary", "slo"}
    lines = [json.loads(x) for x in open(paths["manifest"])]
    assert [x["kind"] for x in lines] == ["header", "span", "metrics"]
    assert lines[0]["driver"] == "t" and lines[1]["name"] == "score.stream"
    with open(paths["metrics"]) as f:
        assert json.load(f)["metrics"]["counters"] == {"score.batches": 1}
    assert "score.stream" in open(paths["summary"]).read()
    partial = obs.export_partial_artifacts(tmp_path, meta={"failed": True})
    assert set(partial) == {"metrics", "manifest", "summary"}
    assert os.path.basename(partial["metrics"]) == "partial.metrics.json"


def test_memory_ledger_on_the_cpu():
    """On the CPU a census reports zero device bytes; transfer counters
    and censuses are gated by the pipeline; tree_device_bytes prices the
    tensors where they live."""
    assert memory.census("x") is None  # telemetry off
    obs.enable()
    row = memory.census("serve_start")
    assert row["allocated_bytes"] == row["live_bytes"] == 0 and row["phase"] == "serve_start"
    memory.count_h2d(100)
    memory.count_d2h(8)
    memory.record_executable("score:k", {"allocated_bytes": 64, "segments_added": 1})
    rep = memory.get_ledger().report()
    assert (rep["h2d_bytes"], rep["d2h_bytes"]) == (100, 8)
    assert rep["executables"]["score:k"]["total_bytes"] == 64
    tree = {"a": torch.zeros(4, dtype=torch.float64), "b": (torch.zeros(2, dtype=torch.int32),),
            "c": [1, "x"]}
    assert memory.tree_device_bytes(tree) == 40
    assert memory.live_device_bytes() == 0
    obs.reset()  # footprints survive the artifact boundary, censuses do not
    rep = memory.get_ledger().report()
    assert "score:k" in rep["executables"] and rep["censuses"] == [] and rep["h2d_bytes"] == 0


def test_compile_watch_counts_cold_dispatches_and_native_builds():
    before = compile_watch.snapshot()
    assert set(before) == {"backend_compiles", "backend_compile_s", "cold_dispatches",
                           "native_builds", "native_build_s", "allocator_segments"}
    with compile_watch.watch() as cw:
        compile_watch.record_native_build("lib", 1.5)
        compile_watch.record_cold_dispatch()
    assert cw["backend_compiles"] == 2 and cw["cold_dispatches"] == 1
    assert cw["native_builds"] == 1 and cw["native_build_s"] == 1.5
    assert cw["backend_compile_s"] == 1.5 and cw["allocator_segments"] == 0
    assert compile_watch.install() and compile_watch.installed()


def test_sanitizer_is_a_noop_off_the_card(monkeypatch):
    with pytest.raises(ValueError, match="reason"):
        with sanitize.sanctioned_transfers(" "):
            pass
    monkeypatch.setenv("PHOTON_SANITIZE", "transfers")
    assert sanitize.transfers_mode()
    with sanitize.transfer_sanitizer("region", "cpu"):
        assert torch.ones(3).sum().item() == 3.0
    with sanitize.sanctioned_transfers("a reason"):
        pass
    monkeypatch.setenv("PHOTON_SANITIZE", "0")
    assert not sanitize.transfers_mode()


def test_series_rows_have_the_jax_keys(tmp_path):
    obs.enable()
    from photon_tpu import obs as jobs

    reg, jreg = obs.get_registry(), jobs.get_registry()
    flusher = series.SeriesFlusher(str(tmp_path / "s.jsonl"), 10.0, registry=reg)
    jflusher = jseries.SeriesFlusher(str(tmp_path / "j.jsonl"), 10.0, registry=jreg)
    for r in (reg, jreg):
        r.counter("serve.requests", 3)
        r.gauge("mem.live_bytes", 5)
        r.histogram("serve.e2e_seconds", 0.02)
    row, jrow = flusher.flush_once(), jflusher.flush_once()
    jreg.clear()
    assert set(row) == set(jrow)
    assert row["counters"] == jrow["counters"] and row["gauges"] == jrow["gauges"]
    assert row["histograms"] == jrow["histograms"]
    assert series.read_series(str(tmp_path / "s.jsonl")) == [row]
    assert jseries.read_series(str(tmp_path / "s.jsonl")) == [row]


def test_series_knob_and_process_info(monkeypatch):
    assert series.flush_interval_s() == 10.0
    monkeypatch.setenv("PHOTON_OBS_FLUSH_S", "-1")
    with pytest.raises(ValueError):
        series.flush_interval_s()
    monkeypatch.setenv("PHOTON_OBS_PROCESS", "1/3")
    info = series.process_info()
    assert (info.index, info.count, info.pid) == (1, 3, os.getpid())
    monkeypatch.setenv("PHOTON_OBS_PROCESS", "3/3")
    with pytest.raises(ValueError):
        series.process_info()


@pytest.mark.parametrize("var,value", [("PHOTON_OBS_HTTP_PORT", "0"), ("PHOTON_OBS_FLEET", "1")])
def test_live_plane_refuses_unported_layers(tmp_path, monkeypatch, var, value):
    """No switch of the JAX plane is refused any more: ``PHOTON_OBS_FLEET=1``
    arms the fleet publisher with the plane and ``PHOTON_OBS_HTTP_PORT``
    the endpoints, and the plane's close stops both. The name dates from
    when both were refused; it is kept so that the test's history reads
    on."""
    monkeypatch.setenv(var, value)
    plane = obs.live_plane(tmp_path / "obs")
    try:
        if var == "PHOTON_OBS_FLEET":
            assert plane.fleet_publisher is obs.fleet.get_publisher() is not None
            assert (tmp_path / "obs" / obs.fleet.REGISTRY_FILENAME).exists()
        else:
            assert plane.server is obs.http.get_server() and plane.server.port > 0
    finally:
        plane.close()
    assert obs.http.get_server() is None and obs.fleet.get_publisher() is None
    assert obs.flight.get_recorder() is None and obs.series.get_flusher() is None


def test_live_plane_arms_and_closes(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_OBS_FLEET", "0")
    obs.enable()
    plane = obs.live_plane(tmp_path / "obs")
    try:
        assert plane.recorder is not None and plane.flusher is not None
        obs.flight.record("serve_batch", batch=1)
    finally:
        plane.close()
    records, clean = obs.flight.FlightRecorder.read_file(str(tmp_path / "obs" / "blackbox.ring"))
    assert clean and [r["k"] for r in records][:1] == ["serve_batch"]
    assert series.read_series(str(tmp_path / "obs" / "series.jsonl"))  # the final row


def test_run_profile_success_failure_and_opt_out(tmp_path, monkeypatch):
    with game_base.run_profile(tmp_path / "ok") as _:
        assert obs.enabled()
        with obs.span("work"):
            obs.counter("c")
        paths = game_base.export_run_profile(tmp_path / "ok", meta={"driver": "t"})
    assert not obs.enabled()
    assert {os.path.basename(p) for p in paths.values()} >= {
        "trace.json", "metrics.json", "manifest.jsonl", "memory_report.json", "summary.txt"}
    assert (tmp_path / "ok" / "obs" / "series.jsonl").exists()
    with pytest.raises(RuntimeError, match="driver died"):
        with game_base.run_profile(tmp_path / "bad"):
            obs.counter("c")
            raise RuntimeError("driver died")
    names = set(os.listdir(tmp_path / "bad" / "obs"))
    assert {"partial.metrics.json", "partial.manifest.jsonl", "partial.summary.txt"} <= names
    (dump,) = [n for n in names if n.startswith("blackbox-")]
    with open(tmp_path / "bad" / "obs" / dump) as f:
        assert json.load(f)["reason"] == "RuntimeError: driver died"
    monkeypatch.setenv("PHOTON_OBS", "0")
    obs.enable()
    obs.counter("kept")
    with game_base.run_profile(tmp_path / "off"):
        pass
    assert obs.enabled() and obs.get_registry().snapshot()["counters"] == {"kept": 1}
    assert not (tmp_path / "off").exists()


def test_trace_switch_still_raises_naming_a5b(monkeypatch):
    """``PHOTON_TRACE`` is no longer refused: ``causal.ensure_from_env``
    arms the plane; nor is ``PHOTON_OBS_FLEET``, which turns the fleet
    plane on (``1``) or off (``0``) as JAX's does and refuses any other
    value. The name dates from when ``PHOTON_TRACE`` was refused, naming
    A5b; it is kept so that the test's history reads on."""
    monkeypatch.setenv("PHOTON_TRACE", "1")
    try:
        assert obs.causal.ensure_from_env() is obs.causal.active() is not None
    finally:
        obs.causal.clear()
    from photon_tpu.obs import fleet as jfleet

    for value, on in (("1", True), ("0", False), ("", False)):
        monkeypatch.setenv("PHOTON_OBS_FLEET", value)
        assert obs.fleet.fleet_enabled() is jfleet.fleet_enabled() is on
    monkeypatch.setenv("PHOTON_OBS_FLEET", "yes")
    with pytest.raises(ValueError, match="PHOTON_OBS_FLEET"):
        obs.fleet.fleet_enabled()


def test_retry_counters_use_the_jax_names():
    obs.enable()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise OSError("flaky")
        return "ok"

    policy = retry.RetryPolicy(attempts=2, base_s=0.0, jitter=0.0)
    assert retry.retry_call(flaky, policy=policy, classify=retry.is_transient_io,
                            label="io_decode", sleep=lambda s: None) == "ok"
    with pytest.raises(OSError):
        retry.retry_call(lambda: (_ for _ in ()).throw(OSError("x")), policy=policy,
                         classify=retry.is_transient_io, label="io_decode",
                         sleep=lambda s: None)
    c = obs.get_registry().snapshot()["counters"]
    assert c["retry.attempts"] == c["retry.attempts.io_decode"] == 3
    assert c["retry.exhausted"] == c["retry.exhausted.io_decode"] == 1


def test_recovery_counters_use_the_jax_names():
    from photon_tpu_torch.game.recovery import run_with_recovery
    from photon_tpu_torch.serve.admission import DeadlineExceeded

    obs.enable()
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 2:
            raise faults.InjectedFault("UNAVAILABLE: flake")
        return "ok"

    assert run_with_recovery(flaky, max_restarts=1, sleep=lambda s: None) == "ok"
    with pytest.raises(DeadlineExceeded):  # a shed is never restarted
        run_with_recovery(lambda: (_ for _ in ()).throw(DeadlineExceeded("late")),
                          max_restarts=3, sleep=lambda s: None)
    with pytest.raises(ValueError):
        run_with_recovery(lambda: (_ for _ in ()).throw(ValueError("bug")), max_restarts=0,
                          sleep=lambda s: None)
    c = obs.get_registry().snapshot()["counters"]
    assert c["recovery.failures.transient"] == 1 and c["recovery.restarts"] == 1
    assert c["recovery.recovered"] == 1 and c["recovery.failures.load_shed"] == 1
    assert c["recovery.failures.fatal"] == 1 and "recovery.giveup" not in c
    kinds = [s.args["kind"] for s in obs.get_tracer().spans() if s.name == "recovery.failure"]
    assert kinds == ["transient", "load_shed", "fatal"]
