"""Port parity of the latency SLO plane (photon_tpu_torch/obs/slo.py).

``SloSpec`` parses and renders identical strings in both packages and
rejects the same bad specs. Trackers fed the same end-to-end and stage
sequence, under one injected clock, give the same dominant stages, burn
rates and ``report()`` (registries fed the same histograms). The offline
gate (``check_slo``, ``burn_rates_from_series``, ``main``) agrees on the
same documents. Then the port's streaming scorer reports through it: an
arrival stamp charges queueing to the batch, an armed SLO counts its
violations, and a decode stall is attributed to decode and flips the
gate's exit code.
"""
from __future__ import annotations

import json
import time

import numpy as np
import pytest
import torch

from photon_tpu.obs import metrics as jmetrics
from photon_tpu.obs import slo as jslo
from photon_tpu_torch import obs
from photon_tpu_torch.obs import metrics, slo
from photon_tpu_torch.game.data import slice_game_data
from photon_tpu_torch.game.scoring import GameScorer
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.util import faults
from test_scoring_stream import _make_data, _make_model
from test_torch_game import _numpy_model
from test_torch_scoring_stream import _port_data

SPECS = ("p99<=50ms@60s", "p99.9 <= 0.2s @ 120s", "p90<=1s@8s", "p50<=1500ms@3600s",
         "p99.99<=0.5ms@1s", "p95<=2s@60.5s")
BAD = ("", "p99<50ms@60s", "99<=50ms@60s", "p99<=50m@60s", "p99<=50ms", "p0<=50ms@60s",
       "p100<=50ms@60s", "p99<=0ms@60s", "p99<=50ms@0s")


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("PHOTON_SLO_SPEC", raising=False)
    monkeypatch.delenv("PHOTON_SLO_GATE_BURN", raising=False)
    slo.clear()
    jslo.clear()
    obs.reset()
    yield
    slo.clear()
    jslo.clear()
    obs.disable()
    obs.reset()
    faults.clear()


@pytest.mark.parametrize("spec", SPECS)
def test_spec_parse_and_render_equal_jax(spec):
    s, j = slo.SloSpec.parse(spec), jslo.SloSpec.parse(spec)
    assert s.render() == j.render()
    assert s.as_dict() == j.as_dict()
    assert s.burn_windows_s() == j.burn_windows_s()
    assert slo.SloSpec.parse(s.render()) == s


@pytest.mark.parametrize("bad", BAD)
def test_bad_specs_raise_in_both(bad):
    with pytest.raises(ValueError):
        slo.SloSpec.parse(bad)
    with pytest.raises(ValueError):
        jslo.SloSpec.parse(bad)


def _sequence(seed=3, n=400):
    """(e2e, stages) pairs: mostly fast, a tail dominated by varying stages."""
    rng = np.random.default_rng(seed)
    names = ("queue", "assemble", "h2d", "dispatch", "pipeline", "readback")
    out = []
    for i in range(n):
        stages = {k: float(rng.exponential(0.002)) for k in names}
        if i % 17 == 0:
            stages[names[i % len(names)]] += float(rng.uniform(0.05, 0.5))
        e2e = sum(stages.values())
        out.append((e2e, None if i % 50 == 49 else stages))
    out.append((float("nan"), {"h2d": 1.0}))
    return out


def test_trackers_and_reports_equal_jax_under_one_clock(monkeypatch):
    """The same sequence through both packages' observe_batch and
    registries, with time.perf_counter replaced by one stepping clock."""
    clock = {"t": 1000.0}
    fake = lambda: clock["t"]  # noqa: E731
    monkeypatch.setattr(slo.time, "perf_counter", fake)
    monkeypatch.setattr(jslo.time, "perf_counter", fake)
    spec = "p99<=50ms@60s"
    t, jt = slo.install(spec), jslo.install(spec)
    reg, jreg = metrics.MetricsRegistry(), jmetrics.MetricsRegistry()
    doms, jdoms = [], []
    for e2e, stages in _sequence():
        clock["t"] += 0.25
        doms.append(slo.observe_batch(e2e, stages))
        jdoms.append(jslo.observe_batch(e2e, stages))
        for r in (reg, jreg):
            r.histogram("serve.e2e_seconds", e2e)
            for k, v in (stages or {}).items():
                r.histogram(f"serve.stage_seconds.{k}", v)
    assert doms == jdoms and any(d is not None for d in doms)
    assert (t.batches, t.violations, t.by_stage) == (jt.batches, jt.violations, jt.by_stage)
    assert t.burn_rates() == jt.burn_rates()
    assert t.fast_burning() == jt.fast_burning()
    doc, jdoc = slo.report(reg), jslo.report(jreg)
    assert json.dumps(doc, sort_keys=True) == json.dumps(jdoc, sort_keys=True)
    assert slo.check_slo(doc) == jslo.check_slo(jdoc) != []
    assert slo.dominant_stage(t.by_stage) == jslo.dominant_stage(jt.by_stage)


def test_gate_on_series_rows_and_files_equal_jax(tmp_path, capsys):
    spec = slo.SloSpec.parse("p99<=10ms@60s")
    rows = [{"interval_s": 10.0, "counters": {"slo.batches": 100, "slo.violations": v}}
            for v in (0, 0, 1, 5, 0, 30)]
    assert slo.burn_rates_from_series(rows, spec) == jslo.burn_rates_from_series(
        rows, jslo.SloSpec.parse("p99<=10ms@60s"))
    slo.install("p99<=10ms@60s")
    for e2e in (0.001,) * 99 + (1.0,):
        slo.observe_batch(e2e, {"h2d": e2e})
    obs.enable()
    obs.histogram("serve.e2e_seconds", 0.001)
    doc = slo.report()
    path = tmp_path / "slo_report.json"
    path.write_text(json.dumps({"slo": doc}))
    series_path = tmp_path / "series.jsonl"
    series_path.write_text("\n".join(json.dumps(r) for r in rows) + "\n")
    for argv in ([str(path)], [str(path), "--series", str(series_path)],
                 [str(path), "--max-burn", "100"], [str(tmp_path / "missing.json")]):
        assert slo.main(argv) == jslo.main(argv), argv
    assert slo.main([str(path), "--series", str(series_path)]) == 3
    assert "burn" in capsys.readouterr().out
    assert slo.check_slo({"armed": False}) == jslo.check_slo({"armed": False})


def test_env_arming_and_gate_burn_knob(monkeypatch):
    assert slo.ensure_from_env() is None
    monkeypatch.setenv("PHOTON_SLO_SPEC", "p99<=1s@60s")
    t = slo.ensure_from_env()
    assert t is slo.active() and t.spec.render() == "p99<=1s@60s"
    assert slo.ensure_from_env() is t  # armed once; programmatic wins
    monkeypatch.setenv("PHOTON_SLO_SPEC", "garbage")
    slo.clear()
    with pytest.raises(ValueError):
        slo.ensure_from_env()
    assert slo.gate_max_burn() == 1.0 == jslo.gate_max_burn()
    monkeypatch.setenv("PHOTON_SLO_GATE_BURN", "2.5")
    assert slo.gate_max_burn(9.0) == 2.5 == jslo.gate_max_burn(9.0)


# -- the streaming scorer reports through the plane -------------------------


@pytest.fixture(scope="module")
def scorer_and_data():
    jmodel = _make_model(projection=False)
    model = _numpy_model(jmodel, TaskType.LINEAR_REGRESSION)
    data = _port_data(_make_data(n=128))
    return GameScorer(model, device="cpu", dtype=torch.float64, batch_rows=64), data


def _chunks(data, rows=64):
    return [slice_game_data(data, lo, min(lo + rows, data.num_samples))
            for lo in range(0, data.num_samples, rows)]


def test_arrival_stamp_charges_queueing_to_the_batch(scorer_and_data):
    scorer, data = scorer_and_data
    chunk = _chunks(data)[0]
    chunk.slo_arrival_t = time.perf_counter() - 0.5  # born 500 ms ago
    res = scorer.stream(iter([chunk]))
    assert res.stats.e2e_walls_s[0] >= 0.5
    assert res.stats.stage_walls_s["decode"][0] < 0.5  # the wait is not decode


def test_deadline_violations_counted_against_the_armed_slo(scorer_and_data):
    scorer, data = scorer_and_data
    slo.install("p99<=0.001ms@60s")  # everything violates
    obs.enable()
    res = scorer.stream(iter(_chunks(data)))
    st = res.stats
    assert st.deadline_violations == st.batches == 2
    assert sum(st.violations_by_stage.values()) == 2
    c = obs.get_registry().snapshot()["counters"]
    assert c["slo.batches"] == c["slo.violations"] == 2
    hists = obs.get_registry().snapshot()["histograms"]
    assert hists["score.e2e_seconds"]["count"] == 2
    for stage in ("decode", "queue", "assemble", "h2d", "dispatch", "pipeline", "readback"):
        assert hists[f"score.stage_seconds.{stage}"]["count"] == 2, stage


def test_decode_stall_attributed_and_gate_flips(scorer_and_data, tmp_path):
    """A decode stall (the ``scoring.chunk`` fault point) blows a 100 ms
    budget on a one-batch stream; the violation names decode, and the gate
    exits 3 off the exported report."""
    scorer, data = scorer_and_data
    slo.install("p99<=100ms@60s")
    obs.enable()
    with faults.injected("scoring.chunk@1=stall:0.3"):
        res = scorer.stream(iter(_chunks(data)[:1]))
    assert res.stats.violations_by_stage == {"decode": 1}
    paths = obs.export_artifacts(tmp_path)
    assert slo.main([paths["slo"]]) == 3
    with open(paths["slo"]) as f:
        assert json.load(f)["slo"]["dominant_stage"] == "decode"
