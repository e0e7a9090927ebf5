"""Port parity of the live endpoints (photon_tpu_torch/obs/http.py).

Every case of tests/test_obs_http.py runs on the port's modules: metric
name sanitization, counter monotonicity across ``MetricsRegistry.clear()``,
quantile lines from the sparse log buckets, the committed golden file
(tests/fixtures/prometheus_golden.txt, byte for byte) through the vendored
parser, ``/metrics`` / ``/healthz`` / ``/blackbox`` served live, an
injected divergence and a recovery restart visible in ``/healthz``, and a
server whose ``stop()`` leaves no thread or socket. The cross-package
cases: a registry fed the same counters, gauges and histograms renders
identical Prometheus text in both packages, and the ``/healthz``
documents have the same keys. ``/slo`` and ``/trace`` are served too, and
the drivers' live plane arms the server from ``PHOTON_OBS_HTTP_PORT``.
"""
from __future__ import annotations

import json
import os
import urllib.error
import urllib.request

import numpy as np
import pytest

from photon_tpu import obs as jobs
from photon_tpu.obs import MetricsRegistry as JRegistry
from photon_tpu.obs import http as jhttp
from photon_tpu_torch import obs
from photon_tpu_torch.game.config import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import CSRMatrix, GameData
from photon_tpu_torch.game.estimator import GameEstimator
from photon_tpu_torch.obs import MetricsRegistry, causal, flight, http, slo
from photon_tpu_torch.obs.http import (
    CounterMonotonicity,
    TelemetryServer,
    healthz_snapshot,
    parse_prometheus_text,
    prometheus_text,
    sanitize_metric_name,
)
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.problem import (
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.util import faults

GOLDEN_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)), "fixtures",
                           "prometheus_golden.txt")


@pytest.fixture(autouse=True)
def _clean_plane(monkeypatch):
    for var in ("PHOTON_OBS_HTTP_PORT", "PHOTON_OBS_FLEET", "PHOTON_SLO_SPEC", "PHOTON_TRACE"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    obs.disable()
    http.stop_server()
    flight.disable()
    faults.clear()
    yield
    faults.clear()
    http.stop_server()
    flight.disable()
    causal.clear()
    slo.clear()
    obs.reset()
    obs.disable()


def _get(url: str):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read()


def _golden_registry(cls=MetricsRegistry):
    """The fixed metric population behind the committed golden file: every
    instrument kind, a dashed name, a leading-digit name, float and int
    counters, and a histogram spread wide enough for distinct percentile
    lines."""
    reg = cls()
    reg.counter("descent.sweeps", 3)
    reg.counter("score.samples", 4096)
    reg.counter("io.bytes", 12345.5)
    reg.gauge("health.loss.per-user", -1.5)
    reg.gauge("mem.live_bytes", 1048576)
    reg.gauge("9weird-name", 2)
    for i in range(100):
        reg.histogram("score.batch_seconds", 0.001 * (i + 1))
    return reg


# -- exposition units -------------------------------------------------------


def test_sanitize_metric_name():
    assert sanitize_metric_name("descent.sweeps") == "photon_descent_sweeps"
    assert sanitize_metric_name("health.loss.per-user") == "photon_health_loss_per_user"
    assert sanitize_metric_name("9weird-name") == "photon_9weird_name"
    assert sanitize_metric_name("a b/c") == "photon_a_b_c"


def test_counter_families_get_total_suffix_and_types():
    fams = parse_prometheus_text(prometheus_text(_golden_registry().snapshot()))
    assert fams["photon_descent_sweeps_total"]["type"] == "counter"
    assert fams["photon_health_loss_per_user"]["type"] == "gauge"
    assert fams["photon_score_batch_seconds"]["type"] == "summary"
    (sample,) = fams["photon_descent_sweeps_total"]["samples"]
    assert sample == ("photon_descent_sweeps_total", {}, 3.0)


def test_histogram_quantile_lines_match_registry_percentiles():
    reg = _golden_registry()
    fams = parse_prometheus_text(prometheus_text(reg.snapshot()))
    samples = fams["photon_score_batch_seconds"]["samples"]
    by_label = {lab.get("quantile"): v for name, lab, v in samples if lab}
    assert set(by_label) == {"0.5", "0.9", "0.99", "0.999"}
    for q, v in by_label.items():
        assert v == pytest.approx(reg.percentile("score.batch_seconds", 100 * float(q)))
    flat = {name: v for name, lab, v in samples if not lab}
    assert flat["photon_score_batch_seconds_count"] == 100
    assert flat["photon_score_batch_seconds_sum"] == pytest.approx(
        sum(0.001 * (i + 1) for i in range(100))
    )


def test_counter_monotonic_across_registry_reset():
    """A scraper sees a cumulative counter series although the registry is
    cleared at run boundaries."""
    reg = MetricsRegistry()
    mono = CounterMonotonicity()

    def scrape() -> float:
        fams = parse_prometheus_text(prometheus_text(reg.snapshot(), monotonic=mono))
        (s,) = fams["photon_descent_sweeps_total"]["samples"]
        return s[2]

    reg.counter("descent.sweeps", 5)
    values = [scrape()]
    reg.counter("descent.sweeps", 2)
    values.append(scrape())
    reg.clear()  # the reset a plain exposition would render as a drop
    reg.counter("descent.sweeps", 1)
    values.append(scrape())
    reg.clear()
    reg.counter("descent.sweeps", 0.5)
    values.append(scrape())
    assert values == [5, 7, 8, 8.5]
    assert values == sorted(values)  # never decreases


def test_golden_file_schema():
    """The committed golden exposition matches byte for byte AND parses
    through the vendored parser."""
    text = prometheus_text(_golden_registry().snapshot())
    with open(GOLDEN_PATH) as f:
        golden = f.read()
    assert text == golden
    fams = parse_prometheus_text(golden)
    assert sorted(fams) == [
        "photon_9weird_name",
        "photon_descent_sweeps_total",
        "photon_health_loss_per_user",
        "photon_io_bytes_total",
        "photon_mem_live_bytes",
        "photon_score_batch_seconds",
        "photon_score_samples_total",
    ]
    for fam in fams.values():
        assert fam["type"] in ("counter", "gauge", "summary")
        for name, labels, value in fam["samples"]:
            assert isinstance(value, float)


def test_parser_rejects_malformed_lines():
    with pytest.raises(ValueError, match="non-numeric value"):
        parse_prometheus_text("# TYPE photon_x counter\nphoton_x not-a-number")
    with pytest.raises(ValueError, match="malformed sample"):
        parse_prometheus_text("# TYPE photon_x counter\n{weird} 3")
    with pytest.raises(ValueError, match="precedes"):
        parse_prometheus_text("photon_unknown 3")
    with pytest.raises(ValueError, match="unknown type"):
        parse_prometheus_text("# TYPE photon_x wat\nphoton_x 3")


def test_nonfinite_gauge_renders_parseable():
    """A diverged run's NaN/Inf health gauges render as Prometheus
    NaN/+Inf/-Inf samples, never a 500."""
    reg = MetricsRegistry()
    reg.gauge("health.gnorm.fixed", float("nan"))
    reg.gauge("health.gnorm.user", float("inf"))
    reg.gauge("health.loss.user", float("-inf"))
    fams = parse_prometheus_text(prometheus_text(reg.snapshot()))
    (s,) = fams["photon_health_gnorm_fixed"]["samples"]
    assert s[2] != s[2]
    (s,) = fams["photon_health_gnorm_user"]["samples"]
    assert s[2] == float("inf")
    (s,) = fams["photon_health_loss_user"]["samples"]
    assert s[2] == float("-inf")


# -- cross-package: the same exposition and health document ----------------


def _feed(reg, case: str):
    if case == "golden":
        return _golden_registry(type(reg))
    if case == "serving":
        for i in range(40):
            reg.counter("serve.requests")
            reg.counter("serve.rows", 1024)
            reg.histogram("serve.e2e_seconds", 0.0125 + 0.0007 * i)
            reg.histogram(f"serve.stage_seconds.{('assemble', 'h2d', 'readback')[i % 3]}",
                          0.001 * (1 + i % 7))
        reg.counter("serve.shed.queue_full", 2)
        reg.gauge("mem.live_bytes", 123456789)
        return reg
    if case == "training":
        for it in range(3):
            reg.counter("descent.sweeps")
            reg.counter("descent.dispatches", 3)
            reg.histogram("descent.sweep_seconds", 1.5 / (it + 1))
            reg.gauge("health.loss.user", 100.25 - it)
            reg.gauge("health.gnorm.fixed", float("nan") if it == 2 else 0.5 ** it)
        reg.counter("optimize.n_evals", 17)
        return reg
    raise AssertionError(case)


@pytest.mark.parametrize("case", ["golden", "serving", "training"])
def test_prometheus_text_equals_jax(case):
    treg, jreg = _feed(MetricsRegistry(), case), _feed(JRegistry(), case)
    tmono, jmono = CounterMonotonicity(), jhttp.CounterMonotonicity()
    got = prometheus_text(treg.snapshot(), tmono)
    assert got == jhttp.prometheus_text(jreg.snapshot(), jmono)
    # the reset compensation renders the same cumulative series
    treg.clear()
    jreg.clear()
    _feed(treg, case)
    _feed(jreg, case)
    assert prometheus_text(treg.snapshot(), tmono) == jhttp.prometheus_text(jreg.snapshot(),
                                                                            jmono)
    # repr: a NaN gauge parses to NaN in both, which == cannot compare
    assert repr(parse_prometheus_text(got)) == repr(jhttp.parse_prometheus_text(got))


def _keys(doc, prefix=""):
    out = set()
    for k, v in doc.items():
        out.add(prefix + k)
        if isinstance(v, dict) and k not in ("health", "health_gauges", "failures",
                                             "burn_rates", "violations_by_stage"):
            out |= _keys(v, prefix + k + ".")
    return out


def test_healthz_documents_have_the_jax_keys(tmp_path):
    from photon_tpu.obs import flight as jflight
    from photon_tpu.obs import slo as jslo

    for o, fl, sl, d in ((obs, flight, slo, "t"), (jobs, jflight, jslo, "j")):
        o.reset()
        o.enable()
        o.counter("serve.requests", 4)
        o.counter("serve.shed.tenant.default")
        o.counter("recovery.failures.transient")
        fl.enable(str(tmp_path / d), capacity_bytes=8192)
        sl.install("p99<=1s@60s")
        sl.observe_batch(0.5, {"dispatch": 0.5})
    try:
        got, want = healthz_snapshot(), jhttp.healthz_snapshot()
    finally:
        for o, fl, sl in ((obs, flight, slo), (jobs, jflight, jslo)):
            fl.disable()
            sl.clear()
            o.reset()
            o.disable()
    assert _keys(got) == _keys(want)
    assert got["fleet"] is None and want["fleet"] is None
    assert got["serve"] == want["serve"] and got["slo"]["status"] == want["slo"]["status"]


# -- endpoints --------------------------------------------------------------


def test_endpoints_serve_metrics_healthz_blackbox(tmp_path):
    obs.enable()
    obs.counter("descent.sweeps", 2)
    flight.enable(str(tmp_path), capacity_bytes=8192)
    flight.record("sweep", iteration=0)
    srv = TelemetryServer(0)
    port = srv.start()
    try:
        fams = parse_prometheus_text(_get(f"http://127.0.0.1:{port}/metrics").decode())
        assert "photon_descent_sweeps_total" in fams
        hz = json.loads(_get(f"http://127.0.0.1:{port}/healthz"))
        assert hz["status"] == "ok"
        assert hz["recorder"]["last_seq"] == 0
        bb = json.loads(_get(f"http://127.0.0.1:{port}/blackbox"))
        assert [r["k"] for r in bb["records"]] == ["sweep"]
        with pytest.raises(urllib.error.HTTPError) as exc:
            _get(f"http://127.0.0.1:{port}/nope")
        assert exc.value.code == 404
    finally:
        srv.stop()
    # a stopped server has no live thread or socket
    assert srv._thread is None and srv._httpd is None


def test_slo_and_trace_endpoints_serve_their_documents():
    obs.enable()
    slo.install("p99<=1s@60s")
    slo.observe_batch(0.25, {"dispatch": 0.2, "readback": 0.05})
    srv = TelemetryServer(0)
    port = srv.start()
    try:
        doc = json.loads(_get(f"http://127.0.0.1:{port}/slo"))
        assert doc["armed"] and doc["batches"] == 1 and doc["spec"]["spec"] == "p99<=1s@60s"
        trace = json.loads(_get(f"http://127.0.0.1:{port}/trace"))
        assert trace["otherData"]["causal_tracing"] == {"armed": False}
        buf = causal.install(sample_n=1)
        buf.mint("req").event("stage", 1.0, 0.001).finish("ok", e2e_s=0.001)
        trace = json.loads(_get(f"http://127.0.0.1:{port}/trace"))
        assert causal.validate_chrome_trace(trace) == []
        assert trace["otherData"]["causal_tracing"]["finished"] == 1
    finally:
        srv.stop()


def test_scrape_is_monotonic_across_obs_reset():
    obs.enable()
    obs.counter("io.records", 10)
    srv = TelemetryServer(0)
    port = srv.start()
    try:
        def records():
            fams = parse_prometheus_text(_get(f"http://127.0.0.1:{port}/metrics").decode())
            (s,) = fams["photon_io_records_total"]["samples"]
            return s[2]

        def batch_count():
            fams = parse_prometheus_text(_get(f"http://127.0.0.1:{port}/metrics").decode())
            samples = fams["photon_score_batch_seconds"]["samples"]
            return {n: v for n, lab, v in samples if not lab}["photon_score_batch_seconds_count"]

        obs.histogram("score.batch_seconds", 0.01)
        obs.histogram("score.batch_seconds", 0.02)
        assert records() == 10
        assert batch_count() == 2
        obs.reset()  # the per-run boundary
        obs.counter("io.records", 3)
        obs.histogram("score.batch_seconds", 0.03)
        assert records() == 13  # cumulative, not a sawtooth
        assert batch_count() == 3
    finally:
        srv.stop()


def test_start_from_env_gating(monkeypatch):
    monkeypatch.delenv("PHOTON_OBS_HTTP_PORT", raising=False)
    assert http.start_from_env() is None  # default: no socket at all
    monkeypatch.setenv("PHOTON_OBS_HTTP_PORT", "not-a-port")
    with pytest.raises(ValueError, match="PHOTON_OBS_HTTP_PORT"):
        http.start_from_env()
    monkeypatch.setenv("PHOTON_OBS_HTTP_PORT", "0")
    srv = http.start_from_env()
    try:
        assert srv is not None and srv.port > 0
        assert http.start_from_env() is srv  # idempotent while live
    finally:
        http.stop_server()
    assert http.get_server() is None


def test_driver_profile_arms_the_endpoints_and_a_taken_port_fails_loudly(tmp_path,
                                                                         monkeypatch):
    """The drivers' run profile serves the endpoints for the run and stops
    them after it; a port already bound fails the start, leaving nothing
    armed (the plane never runs without its endpoints)."""
    from photon_tpu_torch.cli import game_base

    monkeypatch.setenv("PHOTON_OBS_HTTP_PORT", "0")
    monkeypatch.setenv("PHOTON_OBS_FLUSH_S", "0")
    with game_base.run_profile(tmp_path / "run"):
        srv = http.get_server()
        obs.counter("descent.sweeps")
        fams = parse_prometheus_text(_get(f"http://127.0.0.1:{srv.port}/metrics").decode())
        assert fams["photon_descent_sweeps_total"]["samples"][0][2] == 1
        hz = json.loads(_get(f"http://127.0.0.1:{srv.port}/healthz"))
        assert hz["recorder"] is not None
        taken = srv.port
    assert http.get_server() is None
    holder = TelemetryServer(0)
    port = holder.start()
    try:
        monkeypatch.setenv("PHOTON_OBS_HTTP_PORT", str(port))
        with pytest.raises(OSError):
            obs.live_plane(tmp_path / "taken" / "obs")
        assert http.get_server() is None and flight.get_recorder() is None
    finally:
        holder.stop()
    assert taken > 0


def _divergent_fit(on_divergence):
    """A 2-coordinate fit whose 'user' coordinate the fault plan poisons
    with NaN before its first step: the health check flags it at the
    first sweep's barrier."""
    rng = np.random.default_rng(5)
    n, users, d_fe, d_re = 200, 12, 4, 3
    ids = rng.integers(0, users, size=n)
    x = rng.normal(size=(n, d_fe))
    xr = rng.normal(size=(n, d_re))
    y = x @ rng.normal(size=d_fe) * 0.3 + rng.normal(size=n) * 0.1
    data = GameData.build(
        labels=y,
        feature_shards={"g": CSRMatrix.from_dense(x), "u": CSRMatrix.from_dense(xr)},
        id_tags={"userId": [f"u{i}" for i in ids]},
    )
    opt = GLMProblemConfig(
        task=TaskType.LINEAR_REGRESSION,
        regularization=RegularizationContext(RegularizationType.L2),
        optimizer_config=OptimizerConfig(max_iterations=3),
    )
    est = GameEstimator(
        task=TaskType.LINEAR_REGRESSION,
        coordinate_configs={
            "fixed": FixedEffectCoordinateConfig(feature_shard="g", optimization=opt,
                                                 regularization_weights=(1.0,)),
            "user": RandomEffectCoordinateConfig(random_effect_type="userId",
                                                 feature_shard="u", optimization=opt,
                                                 regularization_weights=(1.0,)),
        },
        update_sequence=["fixed", "user"],
        descent_iterations=2,
        seed=5,
        on_divergence=on_divergence,
        device="cpu",
    )
    return est, data


def test_healthz_reflects_injected_divergence_and_recovery_restart(tmp_path):
    """/healthz flips to 'diverged' after an injected NaN under
    on_divergence=warn, names the non-finite coordinate, and shows a
    recovery restart, all live."""
    obs.enable()
    flight.enable(str(tmp_path), capacity_bytes=1 << 20)
    srv = TelemetryServer(0)
    port = srv.start()
    try:
        hz = json.loads(_get(f"http://127.0.0.1:{port}/healthz"))
        assert hz["status"] == "ok" and hz["divergences"] == 0

        faults.install("descent.coordinate@2=nan")  # occurrence 2 = 'user'
        est, data = _divergent_fit("warn")
        est.fit(data)

        hz = json.loads(_get(f"http://127.0.0.1:{port}/healthz"))
        assert hz["status"] == "diverged"
        assert hz["divergences"] >= 1
        assert hz["health"]["user"]["finite"] is False
        bb = json.loads(_get(f"http://127.0.0.1:{port}/blackbox"))
        div = [r for r in bb["records"] if r["k"] == "divergence"]
        assert div and div[0]["coordinate"] == "user"

        obs.counter("recovery.restarts")
        obs.counter("recovery.failures.transient")
        hz = json.loads(_get(f"http://127.0.0.1:{port}/healthz"))
        assert hz["recovery"]["restarts"] == 1
        assert hz["recovery"]["failures"] == {"transient": 1.0}
    finally:
        srv.stop()


def test_healthz_snapshot_without_plane_is_pure_host():
    doc = healthz_snapshot()
    assert doc["status"] == "ok"
    assert doc["recorder"] is None and doc["flusher"] is None
    assert doc["fleet"] is None and doc["process_count"] == 1
    json.dumps(doc)  # strictly serializable
