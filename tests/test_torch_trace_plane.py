"""Port parity of causal request tracing (photon_tpu_torch/obs/causal.py).

Every case of tests/test_trace_plane.py runs on the port's modules except
two: the ``trace_phase`` bridge (``util/profiler.py`` has no counterpart:
the port's tracer enters ``torch.profiler.record_function`` itself, pinned
below) and the bench band (it imports bench.py). The cross-package cases
hold the two planes interchangeable: one scripted sequence of
``mint``/``event``/``flow``/``group``/``finish`` calls at fixed times
gives the same Chrome-trace document in both packages once pid and epoch
are dropped, both validators return the same violations on the same
malformed documents, and the same requests through JAX's serving engine
and the port's give every request a chain of the same events and flow
phases with the batch slices exported once per batch. The port's
streaming trainer, its fault hook and the run profile's export are
covered too. Everything runs on the CPU.
"""
from __future__ import annotations

import json
import threading
import time
import urllib.request

import numpy as np
import pytest
import torch

from photon_tpu import obs as jobs
from photon_tpu.obs import causal as jcausal
from photon_tpu.obs import slo as jslo
from photon_tpu.util import faults as jfaults
from photon_tpu_torch import obs
from photon_tpu_torch.game.data import slice_game_data
from photon_tpu_torch.game.scoring import GameScorer
from photon_tpu_torch.obs import causal, slo, tracer
from photon_tpu_torch.serve.admission import AdmissionQueue
from photon_tpu_torch.serve.engine import SERVE_STAGES, ServingEngine
from photon_tpu_torch.util import faults
from test_torch_serve import BATCH_ROWS, _jax_workload, _registry, _workload

TRACE_ENV = ("PHOTON_TRACE", "PHOTON_TRACE_SAMPLE_N", "PHOTON_TRACE_RING",
             "PHOTON_TRACE_WORST_K", "PHOTON_TRACE_WINDOW_S", "PHOTON_SLO_SPEC")


def _reset_all():
    for c, s, f, o in ((causal, slo, faults, obs), (jcausal, jslo, jfaults, jobs)):
        c.clear()
        s.clear()
        f.clear()
        o.reset()
        o.disable()


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in TRACE_ENV:
        monkeypatch.delenv(var, raising=False)
    _reset_all()
    yield
    _reset_all()


def _scorer(model) -> GameScorer:
    return GameScorer(model, device="cpu", batch_rows=BATCH_ROWS)


def _chain(doc: dict, trace_id: int) -> list:
    """(name, ph) of one trace's events in export order: its slices and
    instants (``args.trace_id``) and its flow events (``id``)."""
    return [
        (e["name"], e["ph"]) for e in doc["traceEvents"]
        if e.get("id") == trace_id or (e.get("args") or {}).get("trace_id") == trace_id
    ]


# -- disarmed discipline ----------------------------------------------------


def test_disarmed_mint_returns_shared_null():
    assert causal.active() is None
    ctx = causal.mint("anything")
    assert ctx is causal.null()
    # every recorder chains as a no-op; active() costs no new object
    assert ctx.event("e", 0.0, 1.0) is ctx
    assert ctx.instant("i") is ctx
    assert ctx.flow("s", 0.0) is ctx
    assert ctx.attach(None) is ctx
    assert ctx.finish("ok") is None
    assert ctx.active() is causal.null().active()
    with ctx.active():
        assert causal.current_trace_id() is None
    assert causal.group("g", [ctx]) is causal.null()
    causal.mark("swap")  # no buffer: silently dropped
    causal.mark_fault("p", "stall")
    doc = causal.chrome_trace()
    assert doc["otherData"]["causal_tracing"] == {"armed": False}
    assert causal.validate_chrome_trace(doc) == []


def test_disarmed_scoring_parity_with_armed():
    """Arming the trace plane may not change a single score."""
    model, chunks = _workload(seed=3, num_requests=2)
    scorer = _scorer(model)
    base = scorer.stream(iter(chunks)).scores
    causal.install(sample_n=1)
    traced = scorer.stream(iter(chunks)).scores
    np.testing.assert_array_equal(base, traced)
    traces, _, _, stats = causal.active().export_state()
    assert stats["finished"] >= len(chunks)
    assert traces, "armed run retained no traces"


# -- arming + env knobs -----------------------------------------------------


def test_ensure_from_env_arms_and_is_loud(monkeypatch):
    assert causal.ensure_from_env() is None
    monkeypatch.setenv("PHOTON_TRACE", "1")
    monkeypatch.setenv("PHOTON_TRACE_SAMPLE_N", "5")
    monkeypatch.setenv("PHOTON_TRACE_WORST_K", "3")
    buf = causal.ensure_from_env()
    assert buf is causal.active()
    assert buf.sample_n == 5 and buf.worst_k == 3
    # programmatic install wins over repeated env arming
    assert causal.ensure_from_env() is buf

    causal.clear()
    monkeypatch.setenv("PHOTON_TRACE", "yes")
    with pytest.raises(ValueError):
        causal.ensure_from_env()
    monkeypatch.setenv("PHOTON_TRACE", "1")
    monkeypatch.setenv("PHOTON_TRACE_SAMPLE_N", "0")
    with pytest.raises(ValueError):
        causal.ensure_from_env()


# -- retention policy -------------------------------------------------------


def test_head_sampling_one_in_n():
    buf = causal.install(sample_n=3, ring=64)
    for _ in range(9):
        buf.mint("req").finish("ok", e2e_s=0.01)
    traces, _, _, stats = buf.export_state()
    assert stats["retained_sampled"] == 3
    assert stats["dropped"] == 6
    # head sampling: the 1st, 4th, 7th minted trace
    assert [t.trace_id for t in traces] == [1, 4, 7]


def test_sampled_ring_is_bounded_oldest_out():
    buf = causal.install(sample_n=1, ring=4)
    for _ in range(6):
        buf.mint("req").finish("ok", e2e_s=0.01)
    traces, _, _, stats = buf.export_state()
    assert stats["retained_sampled"] == 4
    assert [t.trace_id for t in traces] == [3, 4, 5, 6]


def test_exemplar_worst_k_eviction_keeps_the_worst():
    # sample_n high so nothing rides the ring; long window = one bucket
    buf = causal.install(sample_n=1000, worst_k=2, window_s=1000.0)
    for e2e in (1.0, 9.0, 5.0):
        buf.mint("req").finish("deadline", e2e_s=e2e)
    traces, _, _, stats = buf.export_state()
    assert stats["retained_exemplars"] == 2
    assert stats["evicted_exemplars"] == 1
    assert sorted(t.e2e_s for t in traces) == [5.0, 9.0]
    # sheds and errors are exemplars too, regardless of sampling
    buf.mint("req").finish("shed:queue_full", e2e_s=99.0)
    _, _, _, stats = buf.export_state()
    assert stats["retained_exemplars"] == 2  # 99.0 evicted the 5.0
    assert any(t.outcome == "shed:queue_full" for t in buf.traces())


def test_slo_fast_burn_nominates_ok_traces():
    """A trace that met its own deadline still becomes an exemplar when it
    finishes inside a hot burn window: tail context, not a victim."""
    buf = causal.install(sample_n=1000)  # the ring would not keep it
    slo.install("p99<=0.001s@60s")
    tracker = slo.active()
    for _ in range(20):
        tracker.observe(1.0, {"dispatch": 1.0})
    assert tracker.fast_burning()
    buf.mint("req").finish("ok", e2e_s=0.5)
    _, _, _, stats = buf.export_state()
    assert stats["retained_exemplars"] == 1


# -- fault + lifecycle instants ---------------------------------------------


def test_mark_fault_attaches_to_active_trace_else_global():
    buf = causal.install(sample_n=1)
    ctx = buf.mint("victim")
    with ctx.active():
        causal.mark_fault("serve.dispatch", "stall")
    assert any(e["name"] == "fault.injected" for e in ctx.events)
    causal.mark_fault("scoring.chunk", "unavailable")  # no active trace
    _, instants, _, _ = buf.export_state()
    assert [e["name"] for e in instants] == ["fault.injected"]
    causal.mark("serve.swap", tenant="default")
    _, instants, _, _ = buf.export_state()
    assert [e["name"] for e in instants] == ["fault.injected", "serve.swap"]


def test_fired_fault_point_lands_in_the_active_trace():
    """``faults.fault_point`` marks the fault in the trace active on its
    thread; with tracing broken the fault still fires."""
    buf = causal.install(sample_n=1)
    ctx = buf.mint("victim")
    with faults.injected("unit.point@1=stall:0"), ctx.active():
        assert faults.fault_point("unit.point") is not None
    (ev,) = [e for e in ctx.events if e["name"] == "fault.injected"]
    assert ev["args"] == {"point": "unit.point", "kind": "stall", "trace_id": ctx.trace_id}

    def broken(*a, **k):
        raise RuntimeError("tracing broke")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(causal, "mark_fault", broken)
        with faults.injected("unit.point@1=error"), pytest.raises(faults.InjectedFault):
            faults.fault_point("unit.point")


def test_trace_event_cap_counts_overflow():
    buf = causal.install(sample_n=1)
    ctx = buf.mint("noisy")
    for i in range(causal.MAX_EVENTS_PER_TRACE + 10):
        ctx.instant(f"i{i}")
    assert len(ctx.events) == causal.MAX_EVENTS_PER_TRACE
    _, _, _, stats = buf.export_state()
    assert stats["dropped_events"] == 10


def test_concurrent_minting_loses_no_trace():
    """More threads than cores mint, record and finish traces at once (a
    short switch interval); every id is unique and every trace counted."""
    import os
    import sys

    buf = causal.install(sample_n=1, ring=100_000)
    workers, per = 2 * (os.cpu_count() or 2) + 2, 300
    ids: list = []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        mine = []
        for _ in range(per):
            ctx = causal.mint("req")
            with ctx.active():
                causal.mark_fault("unit.point", "stall")
            ctx.event("stage", 1.0, 0.001).finish("ok", e2e_s=0.001)
            mine.append(ctx.trace_id)
        ids.extend(mine)

    try:
        threads = [threading.Thread(target=work) for _ in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    stats = buf.export_state()[3]
    assert len(set(ids)) == len(ids) == workers * per
    assert stats["minted"] == stats["finished"] == stats["retained_sampled"] == workers * per
    assert causal.validate_chrome_trace(causal.chrome_trace()) == []


# -- export + schema contract -----------------------------------------------


def test_chrome_trace_drops_dangling_flows_and_validates():
    obs.enable()
    buf = causal.install(sample_n=1)
    t0 = time.perf_counter()
    # a full chain: s inside one slice, t and f inside another
    full = buf.mint("full")
    full.event("stage_a", t0, 0.010).flow("s", t0)
    full.event("stage_b", t0 + 0.020, 0.010)
    full.flow("t", t0 + 0.020).flow("f", t0 + 0.020)
    full.finish("ok", e2e_s=0.030)
    # shed at the door: only an "s" flow, dropped at export
    shed = buf.mint("shed")
    shed.event("admit", t0, 0.001).flow("s", t0)
    shed.finish("shed:queue_full", e2e_s=0.001)

    doc = causal.chrome_trace()
    assert causal.validate_chrome_trace(doc) == []
    flows = [e for e in doc["traceEvents"] if e["ph"] in ("s", "t", "f")]
    assert {e["id"] for e in flows} == {full.trace_id}
    # the dangling trace's slices survive, only its flows are dropped
    names = [e["name"] for e in doc["traceEvents"]]
    assert "admit" in names
    summaries = doc["otherData"]["causal_tracing"]["traces"]
    assert {s["outcome"] for s in summaries} == {"ok", "shed:queue_full"}


def test_validator_catches_schema_violations():
    base = {"pid": 1, "tid": 1}
    assert causal.validate_chrome_trace({}) == ["traceEvents missing or not a list"]
    errs = causal.validate_chrome_trace({"traceEvents": [dict(base, name="x", ph="Z", ts=0.0)]})
    assert any("unknown phase" in e for e in errs)
    errs = causal.validate_chrome_trace(
        {"traceEvents": [dict(base, name="x", ph="X", ts=0.0, dur=-1)]}
    )
    assert any("dur >= 0" in e for e in errs)
    # a dangling flow id, and a flow binding to no slice on its track
    errs = causal.validate_chrome_trace(
        {"traceEvents": [dict(base, name="x", ph="s", ts=5.0, id=7)]}
    )
    assert any("no finish" in e for e in errs)
    assert any("binds to no slice" in e for e in errs)
    ok = causal.validate_chrome_trace({"traceEvents": [
        dict(base, name="a", ph="X", ts=0.0, dur=10.0),
        dict(base, name="x", ph="s", ts=5.0, id=7),
        dict(base, name="a", ph="X", ts=20.0, dur=10.0),
        dict(base, name="x", ph="f", ts=20.0, id=7, bp="e"),
    ]})
    assert ok == []


def test_run_profile_export_writes_the_served_document(tmp_path):
    """``export_artifacts`` writes ``trace_exemplars.json`` (the document
    ``/trace`` serves) only while the plane is armed."""
    obs.enable()
    assert "trace_exemplars" not in obs.export_artifacts(tmp_path / "off")
    buf = causal.install(sample_n=1)
    t0 = time.perf_counter()
    buf.mint("req").event("stage", t0, 0.001).finish("ok", e2e_s=0.001)
    paths = obs.export_artifacts(tmp_path / "on", meta={"run": "unit"})
    with open(paths["trace_exemplars"]) as f:
        doc = json.load(f)
    assert causal.validate_chrome_trace(doc) == []
    assert doc["otherData"]["run"] == "unit"
    assert doc["otherData"]["causal_tracing"]["finished"] == 1
    # obs.reset() is the run boundary: retained traces go, the arming stays
    obs.reset()
    assert causal.active() is buf and buf.export_state()[3]["finished"] == 0


# -- cross-package: identical documents and verdicts -----------------------


class _Clock:
    """A stand-in for the ``time`` module of one causal module: every
    ``perf_counter_ns`` read advances 1 ms from a fixed start."""

    def __init__(self):
        self.ns = 10_000_000_000

    def perf_counter_ns(self) -> int:
        self.ns += 1_000_000
        return self.ns

    def perf_counter(self) -> float:
        return self.ns / 1e9


def _scripted(mod):
    """One fixed sequence of recorder calls on ``mod``'s plane; returns
    its Chrome-trace document."""
    buf = mod.install(sample_n=2, ring=8, worst_k=2, window_s=30.0)
    t0 = 12.5
    a = mod.mint("serve.request", kind="serve")
    a.event("serve.admit", t0, 0.002, cat="serve", tenant="default", seq=1).flow("s", t0)
    b = mod.mint("serve.request", kind="serve")
    b.event("serve.admit", t0 + 0.001, 0.002, cat="serve", tenant="default", seq=2)
    b.flow("s", t0 + 0.001)
    grp = mod.group("serve.batch", [a, b, None], tenant="default", requests=2)
    grp.event("serve.assemble", t0 + 0.010, 0.004, tenant="default", requests=2, rows=24)
    for ctx in (a, b):
        ctx.flow("t", t0 + 0.010)
    with grp.active():
        mod.mark_fault("serve.dispatch", "stall")
    grp.event("serve.h2d", t0 + 0.014, 0.001)
    grp.event("serve.dispatch", t0 + 0.015, 0.003, tries=1)
    mod.mark("serve.swap", tenant="default", in_flight_at_flip=2)
    grp.event("serve.readback", t0 + 0.020, 0.001, rows=24)
    a.flow("f", t0 + 0.020).finish("ok", e2e_s=0.021)
    b.flow("f", t0 + 0.020).finish("deadline", e2e_s=0.030)
    shed = mod.mint("serve.request", kind="serve")
    shed.event("serve.admit", t0 + 0.030, 0.001, cat="serve").flow("s", t0 + 0.030)
    shed.instant("serve.shed", reason="queue_full")
    shed.finish("shed:queue_full", e2e_s=0.001)
    with mod.mint("score.chunk", kind="score").active():
        mod.mark_fault("scoring.chunk", "unavailable")
    for _ in range(3):
        mod.mint("score.chunk", kind="score").finish("ok", e2e_s=0.004)
    assert mod.active() is buf
    return mod.chrome_trace({"config": "scripted"})


def test_scripted_sequence_gives_the_jax_document(monkeypatch):
    for mod, o in ((jcausal, jobs), (causal, obs)):
        monkeypatch.setattr(mod, "time", _Clock())
        monkeypatch.setattr(o.get_tracer(), "pid", 0)
        monkeypatch.setattr(o.get_tracer(), "epoch_ns", 0)
    want, got = _scripted(jcausal), _scripted(causal)
    assert causal.validate_chrome_trace(got) == []
    assert got == want
    assert len(got["otherData"]["causal_tracing"]["traces"]) == 5


_MALFORMED = {
    "not_a_list": {"traceEvents": {}},
    "missing_keys": {"traceEvents": [{"ph": "X", "ts": 0.0, "dur": 1.0}]},
    "unknown_phase": {"traceEvents": [{"name": "x", "ph": "B", "pid": 1, "tid": 1, "ts": 0.0}]},
    "no_ts": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "dur": 1.0}]},
    "negative_dur": {"traceEvents": [{"name": "x", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
                                      "dur": -2.0}]},
    "bad_instant_scope": {"traceEvents": [{"name": "i", "ph": "i", "pid": 1, "tid": 1,
                                           "ts": 0.0, "s": "x"}]},
    "flow_without_id": {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
                                         "dur": 5.0},
                                        {"name": "f", "ph": "s", "pid": 1, "tid": 1,
                                         "ts": 1.0}]},
    "dangling_start": {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
                                        "dur": 5.0},
                                       {"name": "f", "ph": "f", "pid": 1, "tid": 1, "ts": 1.0,
                                        "id": 3}]},
    "flow_off_track": {"traceEvents": [{"name": "a", "ph": "X", "pid": 1, "tid": 1, "ts": 0.0,
                                        "dur": 5.0},
                                       {"name": "f", "ph": "s", "pid": 1, "tid": 1, "ts": 1.0,
                                        "id": 4},
                                       {"name": "f", "ph": "f", "pid": 1, "tid": 2, "ts": 2.0,
                                        "id": 4}]},
}


@pytest.mark.parametrize("case", sorted(_MALFORMED))
def test_validators_agree_on_malformed_documents(case):
    doc = _MALFORMED[case]
    errs = causal.validate_chrome_trace(doc)
    assert errs, "a malformed document validated"
    assert errs == jcausal.validate_chrome_trace(doc)


# -- serving engine: fan-in, flows, stage enum ------------------------------


def _serve(requests, registry_model, *, cap=64):
    """Submit every request, THEN start the engine, so they fan into one
    micro-batch; returns the answers."""
    reg = _registry()
    reg.register("default", registry_model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    q = AdmissionQueue(cap=cap, default_deadline_s=30.0, max_rows=BATCH_ROWS)
    engine = ServingEngine(reg, q, batch_rows=BATCH_ROWS, poll_s=0.02)
    futs = [q.submit(r) for r in requests]
    engine.start()
    try:
        return [fut.result(timeout=10) for fut in futs]
    finally:
        engine.stop()


def test_engine_fan_in_dedups_batch_slices_and_flows_resolve():
    obs.enable()
    causal.install(sample_n=1)
    model, chunks = _workload(seed=0, num_requests=4)
    _serve([slice_game_data(c, 0, 10) for c in chunks[:3]], model)

    doc = causal.chrome_trace()
    assert causal.validate_chrome_trace(doc) == []
    summaries = doc["otherData"]["causal_tracing"]["traces"]
    assert len(summaries) == 3
    assert all(s["outcome"] == "ok" for s in summaries)
    evs = doc["traceEvents"]
    # 3 requests fanned into ONE micro-batch: the shared batch slices
    # appear exactly once (the exporter dedups the group by identity)
    for name in ("serve.assemble", "serve.h2d", "serve.dispatch", "serve.pipeline",
                 "serve.readback"):
        assert sum(e["name"] == name for e in evs) == 1, name
    # per-request chain: every trace id has a resolving s→t→f flow
    flow_ids = {e["id"] for e in evs if e["ph"] in ("s", "t", "f")}
    assert flow_ids == {s["trace_id"] for s in summaries}
    # the admit slice is per-request: one per member
    assert sum(e["name"] == "serve.admit" for e in evs) == 3


def test_engine_chains_equal_jax_engine():
    """The same requests through JAX's engine and the port's, tracing
    armed: each request's chain holds the same events and flow phases,
    and each batch's slices are exported once."""
    from photon_tpu.game.data import slice_game_data as j_slice
    from photon_tpu.serve.admission import AdmissionQueue as JQueue
    from photon_tpu.serve.engine import ServingEngine as JEngine
    from photon_tpu.serve.registry import ModelRegistry as JRegistry

    jscorer, jchunks = _jax_workload(seed=0, num_requests=4)
    model, chunks = _workload(seed=0, num_requests=4)
    rows = (10, 7, 12)
    jcausal.install(sample_n=1)
    jreg = JRegistry()
    jreg.register("default", jscorer.model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    jq = JQueue(cap=64, default_deadline_s=30.0, max_rows=BATCH_ROWS)
    jengine = JEngine(jreg, jq, batch_rows=BATCH_ROWS, poll_s=0.02)
    jfuts = [jq.submit(j_slice(c, 0, n)) for c, n in zip(jchunks, rows)]
    jengine.start()
    for fut in jfuts:
        fut.result(timeout=10)
    jengine.stop()
    want = jcausal.chrome_trace()

    causal.install(sample_n=1)
    _serve([slice_game_data(c, 0, n) for c, n in zip(chunks, rows)], model)
    got = causal.chrome_trace()

    assert causal.validate_chrome_trace(got) == [] == jcausal.validate_chrome_trace(want)
    ids = [t["trace_id"] for t in got["otherData"]["causal_tracing"]["traces"]]
    assert ids == [t["trace_id"] for t in want["otherData"]["causal_tracing"]["traces"]]
    assert len(ids) == len(rows)
    for tid in ids:
        chain = _chain(got, tid)
        assert chain == _chain(want, tid)
        assert [ph for _, ph in chain if ph in ("s", "t", "f")] == ["s", "t", "f"]
    for doc in (got, want):
        names = [e["name"] for e in doc["traceEvents"]]
        for name in ("serve.assemble", "serve.h2d", "serve.dispatch", "serve.readback"):
            assert names.count(name) == 1, name


def test_serve_stage_histogram_keys_are_bounded():
    obs.enable()
    model, chunks = _workload(seed=0, num_requests=2)
    for c in chunks:
        _serve([slice_game_data(c, 0, 8)], model)
    hists = obs.get_registry().snapshot()["histograms"]
    stage_keys = [k for k in hists if k.startswith("serve.stage_seconds.")]
    assert stage_keys, "engine emitted no stage histograms"
    for k in stage_keys:
        assert k.rsplit(".", 1)[1] in SERVE_STAGES, k


def test_shed_and_faulted_requests_are_exemplars():
    obs.enable()
    causal.install(sample_n=1000)  # retention must come from exemplars
    _, chunks = _workload(seed=0, num_requests=2)
    q = AdmissionQueue(cap=1, default_deadline_s=30.0, max_rows=8)
    fut = q.submit(slice_game_data(chunks[0], 0, 8))
    with pytest.raises(Exception):
        q.submit(slice_game_data(chunks[0], 0, 32))  # oversize: shed
    _, _, _, stats = causal.active().export_state()
    assert stats["retained_exemplars"] == 1
    (shed,) = causal.active().traces()
    assert shed.outcome.startswith("shed:")
    assert any(e["name"] == "serve.shed" for e in shed.events)
    # a fault at the door closes the request's trace with the fault in it
    with faults.injected("serve.admit@1=error"), pytest.raises(faults.InjectedFault):
        q.submit(slice_game_data(chunks[0], 0, 4))
    faulted = [t for t in causal.active().traces() if t.outcome == "fault"]
    assert len(faulted) == 1
    assert any(e["name"] == "fault.injected" for e in faulted[0].events)
    del fut


def test_swap_instant_and_dispatch_fault_land_on_the_timeline():
    """An applied hot swap is a global ``serve.swap`` instant; an injected
    transient ``serve.dispatch`` fault lands inside the batch group."""
    obs.enable()
    causal.install(sample_n=1)
    model_a, chunks = _workload(seed=0, num_requests=2)
    model_b, _ = _workload(seed=1, num_requests=2)
    from photon_tpu_torch.serve.registry import model_fingerprint

    reg = _registry()
    reg.register("default", model_a, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    reg.begin_swap("default", model_b, expect_fingerprint=model_fingerprint(model_b))
    q = AdmissionQueue(cap=8, default_deadline_s=30.0, max_rows=BATCH_ROWS)
    engine = ServingEngine(reg, q, batch_rows=BATCH_ROWS, poll_s=0.02)
    with faults.injected("serve.dispatch@1=unavailable"):
        fut = q.submit(slice_game_data(chunks[0], 0, 8))
        engine.start()
        got = fut.result(timeout=10)
        engine.stop()
    np.testing.assert_array_equal(got, _scorer(model_b).score_data(slice_game_data(chunks[0],
                                                                                   0, 8)))
    doc = causal.chrome_trace()
    assert causal.validate_chrome_trace(doc) == []
    names = [e["name"] for e in doc["traceEvents"]]
    assert names.count("serve.swap") == 1
    (fault,) = [e for e in doc["traceEvents"] if e["name"] == "fault.injected"]
    assert fault["args"] == {"point": "serve.dispatch", "kind": "unavailable"}
    (dispatch,) = [e for e in doc["traceEvents"] if e["name"] == "serve.dispatch"]
    assert dispatch["args"]["tries"] == 2


# -- streaming scorer and trainer: end-to-end chains -----------------------


def test_scoring_stream_chain_validates_with_faults():
    obs.enable()
    causal.install(sample_n=1)
    faults.install("scoring.chunk@2=stall:0.01")
    model, chunks = _workload(seed=1, num_requests=4)
    _scorer(model).stream(iter(chunks))
    doc = causal.chrome_trace()
    assert causal.validate_chrome_trace(doc) == []
    evs = doc["traceEvents"]
    names = {e["name"] for e in evs}
    assert {"score.decode", "score.assemble", "score.h2d", "score.dispatch",
            "score.readback"} <= names
    # the injected stall landed INSIDE a victim's chain, not globally
    assert any(e["name"] == "fault.injected" for e in evs)
    victims = [t for t in causal.active().traces()
               if any(e["name"] == "fault.injected" for e in t.events)]
    assert victims, "no retained trace carries the injected fault"
    flow_ids = {e["id"] for e in evs if e["ph"] in ("s", "t", "f")}
    assert len(flow_ids) >= len(chunks) - 1


def test_training_stream_chain_validates_with_faults(monkeypatch):
    """One ``train.chunk`` trace per streamed chunk, the producer's and
    the consumer's slices stitched by flows, an injected chunk stall
    inside a chain, and the coefficients of the disarmed fit bit for bit."""
    from test_torch_streaming_fit import _data, _re_est

    monkeypatch.delenv("PHOTON_STREAM_CHUNK_ROWS", raising=False)
    base = _re_est(descent_iterations=1).fit(_data(), stream=128)[0]
    causal.install(sample_n=1, ring=256)
    faults.install("train.stream.chunk@2=stall:0.01")
    est = _re_est(descent_iterations=1)
    traced = est.fit(_data(), stream=128)[0]
    doc = causal.chrome_trace()
    assert causal.validate_chrome_trace(doc) == []
    chunks = est.last_fit_stats["stream"]["chunks"]
    summaries = doc["otherData"]["causal_tracing"]["traces"]
    assert [s["name"] for s in summaries] == ["train.chunk"] * chunks
    assert all(s["outcome"] == "ok" for s in summaries)
    evs = doc["traceEvents"]
    for name in ("train.produce", "train.h2d", "train.dispatch", "train.readback"):
        assert sum(e["name"] == name for e in evs) == chunks, name
    assert len({e["id"] for e in evs if e["ph"] == "f"}) == chunks
    assert sum(e["name"] == "fault.injected" for e in evs) == 1
    for a, b in zip(base.model["user"].buckets, traced.model["user"].buckets):
        np.testing.assert_array_equal(a.coefficients, b.coefficients)


# -- the tracer's record_function argument ----------------------------------


def test_span_carries_the_trace_id_into_record_function(monkeypatch, tmp_path):
    """A recorded span enters ``record_function`` with its name alone
    (torch's exported trace drops an argument string); inside an active
    trace its record keeps the ``trace_id``, and the profiler's exported
    range, joined back to the records (``export.annotate_device_trace``),
    carries the span's id and that ``trace_id``."""
    from photon_tpu_torch.obs.export import annotate_device_trace

    seen = []
    real = torch.profiler.record_function

    def spy(name, args=None):
        seen.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", spy)
    obs.enable()
    causal.install(sample_n=1)
    ctx = causal.mint("req")
    with ctx.active():
        assert causal.current_trace_id() == ctx.trace_id
        with obs.span("unprofiled"):
            pass
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            with obs.span("unit_phase") as sp:
                torch.ones(4).sum()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof2:
        with obs.span("outside") as sp2:
            pass
    assert seen == [("unprofiled", None), ("unit_phase", None), ("outside", None)]
    assert causal.current_trace_id() is None
    recs = {r.name: r for r in obs.get_tracer().spans()}
    assert recs["unit_phase"].trace_id == ctx.trace_id and recs["outside"].trace_id is None
    for p, name, span, trace_id in ((prof, "unit_phase", sp, ctx.trace_id),
                                    (prof2, "outside", sp2, None)):
        path = tmp_path / f"{name}.json"
        p.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
        joined, join = annotate_device_trace(events, obs.get_tracer().spans())
        (ann,) = [e for e in joined if e.get("cat") == "user_annotation"]
        assert ann["name"] == name and ann["args"]["span_id"] == span.span_id
        assert ann["args"].get("trace_id") == trace_id
        assert join["unmatched_events"] == 0


# -- concurrent scrapes under live traffic ----------------------------------


def test_concurrent_slo_and_trace_scrapes_during_traffic():
    from photon_tpu_torch.obs.http import TelemetryServer

    obs.enable()
    causal.install(sample_n=1)
    slo.install("p99<=30s@60s")
    model, chunks = _workload(seed=2, num_requests=8)
    server = TelemetryServer(0)
    port = server.start()
    failures: list[str] = []
    scrapes = {"/slo": 0, "/trace": 0}
    stop = threading.Event()

    def scrape(path: str):
        while not stop.is_set():
            try:
                with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                            timeout=5) as resp:
                    if resp.status != 200:
                        failures.append(f"{path}: HTTP {resp.status}")
                    json.loads(resp.read().decode())
                    scrapes[path] += 1
            except Exception as exc:  # torn read / invalid JSON
                failures.append(f"{path}: {exc!r}")
            time.sleep(0.005)

    threads = [threading.Thread(target=scrape, args=(p,), daemon=True) for p in scrapes]
    try:
        for t in threads:
            t.start()
        _scorer(model).stream(iter(chunks))
        time.sleep(0.05)  # one more scrape cycle against the settled state
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=5)
        server.stop()
    assert failures == []
    assert min(scrapes.values()) >= 1
    doc = causal.chrome_trace()
    assert causal.validate_chrome_trace(doc) == []
    assert doc["otherData"]["causal_tracing"]["finished"] >= len(chunks)
