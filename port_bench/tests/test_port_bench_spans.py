"""The split of a device trace by the port's spans (``spans.py``) on a trace
recorded on an H100, the readers of the port's own telemetry, and the
port's telemetry staying off in an untraced run."""
from __future__ import annotations

import json
from pathlib import Path

import pytest
import torch

from port_bench import run, spans, telemetry
from port_bench.entries import telemetry as entry_telemetry

FIXTURE = Path(__file__).parent / "fixtures" / "spans_two_threads.json"


@pytest.fixture(scope="module")
def joined():
    """The fixture's events joined to its records by the port."""
    from photon_tpu_torch.obs.export import annotate_device_trace
    from photon_tpu_torch.obs.tracer import SpanRecord

    with open(FIXTURE) as f:
        doc = json.load(f)
    fields = set(SpanRecord.__dataclass_fields__)
    records = [SpanRecord(**{k: v for k, v in r.items() if k in fields}) for r in doc["records"]]
    events, _ = annotate_device_trace(doc["traceEvents"], records)
    return events



def _brute(events):
    """Each kernel's innermost covering span, the slow way: the shortest
    annotation on its launch's thread that covers the launch."""
    calls = {e["args"]["correlation"]: e for e in events if e["cat"] == "cuda_runtime"}
    anns = [e for e in events if e["cat"] == "user_annotation"]
    out = []
    for k in (e for e in events if e["cat"] == "kernel"):
        call = calls.get(k["args"]["correlation"])
        cover = [a for a in anns if call is not None and a["tid"] == call["tid"]
                 and a["ts"] <= call["ts"] <= a["ts"] + a["dur"]]
        out.append(min(cover, key=lambda a: a["dur"])["name"] if cover else spans.OUTSIDE)
    return out


def test_kernels_go_to_their_launchs_innermost_span(joined):
    j = spans.join(spans.from_chrome(joined))
    got = [s["name"] if s else spans.OUTSIDE for _, _, s in j["kernels"]]
    assert got == _brute(joined)
    # two threads of spans, kernels launched on both and outside any span
    assert len({e["tid"] for e in joined if e["cat"] == "user_annotation"}) == 2
    assert got.count(spans.OUTSIDE) >= 2
    assert "lbfgs.solve" in got and "lbfgs.linesearch" in got


def test_by_span_counts_launches_busy_and_idle(joined):
    j = spans.join(spans.from_chrome(joined))
    table = spans.by_span(j)
    assert sum(v[0] for v in table.values()) == len(j["kernels"])
    busy = sum(b - a for a, b in j["busy"]) / 1e6
    assert sum(v[1] for v in table.values()) == pytest.approx(busy, rel=0.05)
    timed = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in joined]
    window = (max(b for _, b in timed) - min(a for a, _ in timed)) / 1e6
    assert sum(v[2] for v in table.values()) == pytest.approx(window - busy)
    rows = spans.top(table, 3)
    assert len(rows) == min(3, len(table)) and all(len(r) == 4 for r in rows)


def test_per_coordinate_takes_the_joined_coordinate(joined):
    t = spans.from_chrome(joined)
    per = spans.per_coordinate(t, spans.join(t))
    assert set(per) == {"fixed", "user"}
    names = _brute(joined)
    # the coordinates' kernels are those under their train and score spans
    under = sum(n in ("lbfgs.linesearch", "coordinate.score") for n in names)
    assert sum(p["launches"] for p in per.values()) == under
    assert all(p["busy_s"] > 0 for p in per.values())


class _Est:
    last_fit_stats = {"build_s": 2.0, "build_stages": {
        "fit.shape_profile": 0.1, "build.pad": 0.01, "build.re_dataset": 1.2,
        "build.fe_windows": 0.3, "build.placement": 0.2}}


class _Cell:
    est = _Est()

    def step(self):  # pragma: no cover - the readers take the stored measurement
        raise AssertionError("no fit expected")


def _ctx(measurement):
    c = run.Context(cell=_Cell(), setup_s=1.0, window_s=1.0, steps=1, peak_bytes=0)
    c.port_telemetry = measurement
    return c


def _read(name, c):
    return run.read_metrics([{"name": name, "unit": "x"}], c).get(name, {}).get("value")


MEASURED = {
    "fits": [{"syncs": 1000, "wait_s": None, "wall_s": None},
             {"syncs": 1000, "wait_s": 0.1, "wall_s": 2.0},
             {"syncs": 1000, "wait_s": 0.3, "wall_s": 2.0},
             {"syncs": 1000, "wait_s": 0.9, "wall_s": None}],
    "coordinates": {"fixed": {"launches": 7000, "busy_s": 0.05},
                    "user": {"launches": 60000, "busy_s": 0.1}},
    "by_span": {}, "join": {"offset_us": 1.0, "unmatched_events": 0, "unmatched_records": 0},
}


def test_the_readers_of_the_ports_telemetry():
    c = _ctx(MEASURED)
    assert _read("host_syncs_per_fit", c) == 1000
    # the untraced fits only: 5% and 15%
    assert _read("host_wait_pct", c) == pytest.approx(10.0)
    assert _read("coord_launches.user", c) == 60000
    assert _read("coord_busy_s.fixed", c) == pytest.approx(0.05)
    # a coordinate that launched nothing reads 0
    assert _read("coord_launches.item", c) == 0
    assert _read("build_s.shape_profile", c) == pytest.approx(0.1)
    assert _read("build_s.re_dataset", c) == pytest.approx(1.2)
    assert _read("build_s.fe_windows", c) == pytest.approx(0.3)
    assert _read("build_s.placement", c) == pytest.approx(0.2)


def test_the_readers_find_nothing_without_the_instrumentation():
    c = _ctx(None)
    c.cell.est = type("E", (), {"last_fit_stats": {"build_s": 2.0}})()
    for name in ("host_syncs_per_fit", "host_wait_pct", "coord_launches.fixed",
                 "coord_busy_s.user", "build_s.placement"):
        assert _read(name, c) is None
    assert telemetry.measured(run.Context(cell=object(), setup_s=1, window_s=1, steps=1,
                                          peak_bytes=0)) is None


def test_fit_syncs_leaves_out_what_an_untraced_fit_does_not_pass():
    tracker = [{"iteration": 0, "coordinate": "fixed", "host_syncs": {"lbfgs.iteration": 9}},
               {"iteration": 0, "sweep_seconds": 1.0,
                "host_syncs": {"lbfgs.iteration": 9, "descent.coordinate_barrier": 3,
                               "descent.barrier": 1, "optimize.counters": 2},
                "sync_wait_s": {"lbfgs.iteration": 0.5, "descent.coordinate_barrier": 0.25}}]
    assert entry_telemetry.fit_syncs(tracker) == {"syncs": 10, "wait_s": 0.5}
    assert entry_telemetry.fit_syncs(tracker[:1]) == {"syncs": 0, "wait_s": None}


def test_an_untraced_run_leaves_the_ports_telemetry_off(small_cells):
    from photon_tpu_torch import obs

    obs.disable()
    obs.get_tracer().clear()
    run.run_cell("game_ctr_scale.fit", 2**31 + 3, 0.1, False, device="cpu")
    assert not obs.enabled() and obs.get_tracer().spans() == []


def test_a_traced_run_measures_the_ports_telemetry_and_turns_it_off(small_cells, monkeypatch):
    from photon_tpu_torch import obs

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    obs.disable()
    line = run.run_cell("game_ctr_scale.fit", 2**31 + 5, 0.1, True, device="cpu")
    assert not obs.enabled()
    m = line["metrics"]
    assert m["host_syncs_per_fit"]["value"] > 0
    assert 0 < m["host_wait_pct"]["value"] < 100
    # every traced and measured fit is judged: the window's, the traced
    # step and the measurement's
    assert line["attempted"] >= 2 + entry_telemetry.PLAIN_FITS
    assert line["correct"]
