"""The port's host-sync counter, the solver and host-build spans, and the
join of a device trace to the span records, on a small GAME fit.

No JAX here: the ``cuda`` test at the end runs on the card
(``pytest -m cuda tests/test_torch_sync_counter.py``), where it checks
that torch's sync debug mode warns exactly as often as the counter counts.
The join runs on a trace recorded on an H100
(``port_bench/tests/fixtures/spans_two_threads.json``: two threads of
port spans and kernels launched outside any span, with the tracer's
records of the same interval).
"""
from __future__ import annotations

import json
import os
import sys
import threading
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.game import (
    CSRMatrix,
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    GameData,
    GameEstimator,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.obs.export import annotate_device_trace, chrome_trace, join_device_trace
from photon_tpu_torch.obs.tracer import SpanRecord, Tracer
from photon_tpu_torch.optimize import lbfgs as lbfgs_mod
from photon_tpu_torch.optimize import problem as problem_mod
from photon_tpu_torch.optimize.common import OptimizerConfig, record_optimize_metrics
from photon_tpu_torch.optimize.problem import (
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import TaskType

FIXTURE = (Path(__file__).resolve().parents[1] / "port_bench" / "tests" / "fixtures"
           / "spans_two_threads.json")
ORDER = ["fixed", "user", "item"]
SWEEPS = 2


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    obs.disable()
    yield
    obs.reset()
    obs.disable()


def _data(seed=0, n=1500, users=30, items=9, fe_dim=48):
    rng = np.random.default_rng(seed)
    nnz = 4
    cols = rng.integers(1, fe_dim, size=(n, nnz))
    cols[:, 0] = 0
    vals = np.ones((n, nnz))
    user = rng.integers(0, users, size=n)
    item = rng.integers(0, items, size=n)
    margin = 0.3 * rng.normal(size=fe_dim)[cols].sum(1) + rng.normal(size=users)[user]
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    shards = {"global": CSRMatrix(indptr=np.arange(n + 1) * nnz, indices=cols.ravel(),
                                  values=vals.ravel(), num_cols=fe_dim)}
    for name, k, d in (("user", user, 3), ("item", item, 1)):
        x = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], axis=1)
        shards[f"per_{name}"] = CSRMatrix.from_dense(x)
    tags = {"user": [f"u{i}" for i in user], "item": [f"i{i}" for i in item]}
    return GameData.build(labels=labels, feature_shards=shards, id_tags=tags)


def _estimator(device="cpu", dtype=torch.float64):
    l2 = RegularizationContext(RegularizationType.L2)

    def opt(iters):
        return GLMProblemConfig(optimizer_config=OptimizerConfig(max_iterations=iters,
                                                                 ls_max_iterations=8),
                                regularization=l2)

    cfgs = {"fixed": FixedEffectCoordinateConfig(
        feature_shard="global", optimization=opt(6), regularization_weights=(1.0,),
        representation=FeatureRepresentation.SPARSE, column_windows=True)}
    for name, ub in (("user", 32), ("item", 128)):
        cfgs[name] = RandomEffectCoordinateConfig(
            random_effect_type=name, feature_shard=f"per_{name}", optimization=opt(4),
            regularization_weights=(1.0,), active_data_upper_bound=ub)
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=cfgs,
                         update_sequence=ORDER, descent_iterations=SWEEPS, dtype=dtype,
                         seed=3, device=device, keep_coordinates=True)


@pytest.fixture(scope="module")
def coordinates():
    return _estimator()._build_coordinates(_data())


def _spy_solves(monkeypatch):
    """Each L-BFGS solve's own count of its loop's checks (its iterations,
    plus the check that ended the loop early) and each line search's (its
    trials, likewise): what the counter must count."""
    seen = {"lbfgs.iteration": 0, "linesearch.trial": 0, "solves": 0, "searches": 0}
    real_solve, real_search = lbfgs_mod.minimize_lbfgs, lbfgs_mod.wolfe_search_phi

    def solve(vg, x0, config, **kw):
        res = real_solve(vg, x0, config, **kw)
        n = int(res.iterations.max())
        seen["lbfgs.iteration"] += n + (n < config.max_iterations)
        seen["solves"] += 1
        return res

    def search(*a, max_iterations, **kw):
        res = real_search(*a, max_iterations=max_iterations, **kw)
        n = int(res.num_evals.max())
        seen["linesearch.trial"] += n + (n < max_iterations)
        seen["searches"] += 1
        return res

    monkeypatch.setattr(problem_mod, "minimize_lbfgs", solve)
    monkeypatch.setattr(lbfgs_mod, "wolfe_search_phi", search)
    return seen


def test_sync_counts_equal_the_solves_own_counts(coordinates, monkeypatch):
    seen = _spy_solves(monkeypatch)
    snap = obs.sync_snapshot()
    cd = run_coordinate_descent(coordinates, ORDER, SWEEPS)
    counts, waits = obs.syncs_since(snap)
    assert seen["solves"] == SWEEPS * (1 + sum(len(coordinates[c].device_buckets)
                                               for c in ("user", "item")))
    assert counts == {"lbfgs.iteration": seen["lbfgs.iteration"],
                      "linesearch.trial": seen["linesearch.trial"],
                      "descent.barrier": SWEEPS}
    # telemetry off: counted, not timed
    assert waits == {} and obs.sync_snapshot()[1] == snap[1]
    sweeps = [r for r in cd.tracker if "sweep_seconds" in r]
    steps = [r for r in cd.tracker if "coordinate" in r]
    assert all("sync_wait_s" not in r for r in cd.tracker)
    assert sum(sum(r["host_syncs"].values()) for r in sweeps) == sum(counts.values())
    for s in sweeps:
        mine = [r for r in steps if r["iteration"] == s["iteration"]]
        assert sum(sum(r["host_syncs"].values()) for r in mine) + 1 == \
            sum(s["host_syncs"].values())
        assert s["host_syncs"]["descent.barrier"] == 1


def test_sync_waits_are_timed_only_with_telemetry_on(coordinates):
    obs.enable()
    snap = obs.sync_snapshot()
    cd = run_coordinate_descent(coordinates, ORDER, SWEEPS)
    counts, waits = obs.syncs_since(snap)
    assert set(waits) == set(counts) and all(w > 0 for w in waits.values())
    reg = obs.get_registry().snapshot()["counters"]
    for site, n in counts.items():
        assert reg[f"sync.{site}"] == n
        assert reg[f"sync_wait_s.{site}"] == pytest.approx(waits[site])
    sweeps = [r for r in cd.tracker if "sweep_seconds" in r]
    assert all(set(r["sync_wait_s"]) == set(r["host_syncs"]) for r in sweeps)
    coords = [s for s in obs.get_tracer().spans() if s.name == "descent.coordinate"]
    steps = [r for r in cd.tracker if "coordinate" in r]
    assert [s.args["host_syncs"] for s in coords] == \
        [sum(r["host_syncs"].values()) for r in steps]


def test_host_sync_launches_nothing_and_counts_a_failed_read():
    from torch.profiler import ProfilerActivity, profile

    before = obs.sync_snapshot()[0].get("unit.site", 0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with obs.host_sync("unit.site"):
            pass
    assert [e for e in prof.events() if not e.name.startswith("ProfilerStep")] == []
    with pytest.raises(RuntimeError), obs.host_sync("unit.site"):
        raise RuntimeError("the read failed")
    counts, waits = obs.sync_snapshot()
    assert counts["unit.site"] == before + 2 and "unit.site" not in waits


def test_host_sync_loses_no_count_across_threads():
    """More threads than cores count at once at two sites, telemetry on
    for half of the run; no increment is lost."""
    workers = 2 * (os.cpu_count() or 2) + 2
    per = 1500
    c0 = obs.sync_snapshot()[0]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work(i):
        for j in range(per):
            if i == 0 and j == per // 2:
                obs.enable()
            with obs.host_sync("stress.a" if i % 2 else "stress.b"):
                pass

    try:
        threads = [threading.Thread(target=work, args=(i,)) for i in range(workers)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    c1 = obs.sync_snapshot()[0]
    for site, n in (("stress.a", workers // 2), ("stress.b", workers - workers // 2)):
        assert c1[site] - c0.get(site, 0) == n * per


def test_the_solve_counters_read_is_a_sync_site():
    from photon_tpu_torch.optimize.common import OptimizeResult

    res = OptimizeResult(*(torch.tensor(3) for _ in range(10)))
    before = obs.sync_snapshot()[0].get("optimize.counters", 0)
    record_optimize_metrics(res)  # telemetry off: no read at all
    assert obs.sync_snapshot()[0].get("optimize.counters", 0) == before
    obs.enable()
    record_optimize_metrics(res)
    assert obs.sync_snapshot()[0]["optimize.counters"] == before + 1
    assert obs.get_registry().snapshot()["counters"]["optimize.iterations"] == 3


def _by_id(spans):
    return {s.span_id: s for s in spans}


def test_solver_spans_nest_and_carry_their_args(coordinates, monkeypatch):
    seen = _spy_solves(monkeypatch)
    obs.enable()
    run_coordinate_descent(coordinates, ORDER, SWEEPS)
    spans = obs.get_tracer().spans()
    ids = _by_id(spans)

    def named(n):
        return [s for s in spans if s.name == n]

    for name in ("coordinate.train", "coordinate.score"):
        got = named(name)
        assert [s.args["coordinate"] for s in got] == ORDER * SWEEPS
        assert all(ids[s.parent_id].name == "descent.coordinate"
                   and ids[s.parent_id].args["coordinate"] == s.args["coordinate"] for s in got)
    buckets = named("re.bucket")
    shapes = [tuple(db.features.shape) for c in ("user", "item")
              for db in coordinates[c].device_buckets]
    assert [(b.args["lanes"], b.args["rows"], b.args["d"]) for b in buckets] == shapes * SWEEPS
    assert all(ids[b.parent_id].name == "coordinate.train" for b in buckets)
    solves = named("lbfgs.solve")
    assert len(solves) == seen["solves"]
    assert sorted(ids[s.parent_id].name for s in solves) == sorted(
        ["coordinate.train"] * SWEEPS + ["re.bucket"] * len(buckets))
    assert all(s.args["lanes"] >= 1 and s.args["d"] >= 1 for s in solves)
    searches = named("lbfgs.linesearch")
    assert len(searches) == seen["searches"]
    assert all(ids[s.parent_id].name == "lbfgs.solve" for s in searches)
    # no span per line-search trial
    assert not [s for s in spans if "trial" in s.name]


def test_build_stages_are_spans_and_fit_stats(monkeypatch):
    data = _data(seed=1)
    est = _estimator()
    est.fit(data)
    off = est.last_fit_stats["build_stages"]
    assert set(off) == {"fit.shape_profile", "build.pad", "build.re_dataset",
                        "build.fe_windows", "build.placement"}
    assert 0 < sum(off.values()) <= est.last_fit_stats["build_s"]
    assert obs.get_tracer().spans() == []  # telemetry off: walls, no records
    obs.enable()
    est = _estimator()
    est.fit(data)
    stages = est.last_fit_stats["build_stages"]
    spans = obs.get_tracer().spans()
    for name, wall in stages.items():
        mine = [s for s in spans if s.name == name]
        assert sum(s.dur_ns for s in mine) / 1e9 == pytest.approx(wall)
    ids = _by_id(spans)
    (build,) = [s for s in spans if s.name == "fit.data_build"]

    def under_build(s):
        while s.parent_id is not None:
            s = ids[s.parent_id]
            if s is build:
                return True
        return False

    stage_spans = [s for s in spans if s.name in stages]
    assert stage_spans and all(under_build(s) for s in stage_spans)
    re = [s.args["coordinate"] for s in spans if s.name == "build.re_dataset"]
    assert re == ["user", "item"]
    placed = [s.args for s in spans if s.name == "build.placement"]
    assert {"random_effect": "user"} in placed and {"random_effect": "item"} in placed
    assert sum(a.get("shard") == "global" for a in placed) == 2


# -- the join of a device trace to the span records ---------------------------


@pytest.fixture(scope="module")
def recorded():
    with open(FIXTURE) as f:
        doc = json.load(f)
    fields = set(SpanRecord.__dataclass_fields__)
    return doc["traceEvents"], [SpanRecord(**{k: v for k, v in r.items() if k in fields})
                                for r in doc["records"]]


def test_join_pairs_each_annotation_with_its_record(recorded):
    events, records = recorded
    join = join_device_trace(events, records)
    anns = [e for e in events if e.get("cat") == "user_annotation"]
    assert len({e["tid"] for e in anns}) == 2
    assert join["unmatched_events"] == 0 and len(join["pairs"]) == len(anns)
    # the records from before the profiled interval stay out of the join
    assert join["unmatched_records"] == len(records) - len(anns)
    for e, r in join["pairs"]:
        assert (e["name"], e["tid"]) == (r.name, r.native_tid)
        # one offset for every pair, to within the annotation's entry cost
        assert float(e["ts"]) - r.t0_ns / 1e3 == pytest.approx(join["offset_us"], abs=200.0)
        assert abs(float(e["dur"]) - r.dur_ns / 1e3) < 200.0


def test_annotated_ranges_carry_the_records_args(recorded):
    events, records = recorded
    joined, _ = annotate_device_trace(events, records)
    coords = [e for e in joined if e.get("name") == "descent.coordinate"]
    assert [e["args"]["coordinate"] for e in sorted(coords, key=lambda e: e["ts"])] == \
        ["fixed", "user"]
    by_id = {r.span_id: r for r in records}
    for e in joined:
        if e.get("cat") == "user_annotation":
            rec = by_id[e["args"]["span_id"]]
            assert rec.name == e["name"] and e["args"]["parent_id"] == rec.parent_id
    assert len(joined) == len(events)


def test_one_timeline_holds_the_spans_and_the_kernels(recorded, tmp_path):
    events, records = recorded
    tracer = Tracer(enabled=False)
    tracer._spans.extend(records)
    tracer.epoch_ns = min(r.t0_ns for r in records)
    doc = chrome_trace(tracer, obs.MetricsRegistry(), device_trace=events)
    offset = doc["otherData"]["device_offset_us"]
    assert offset == join_device_trace(events, records)["offset_us"]
    out = doc["traceEvents"]
    kernels = [e for e in out if e.get("cat") == "kernel"]
    calls = {e["args"]["correlation"]: e for e in out if e.get("cat") == "cuda_runtime"}
    spans = [e for e in out if e.get("args", {}).get("span_id") is not None]
    assert kernels and {s["tid"] for s in spans} == {r.tid for r in records}
    # each kernel's launch lands, on the tracer's clock, inside the span
    # whose annotation covered it in the device trace, on its thread's track
    src_calls = {e["args"]["correlation"]: e for e in events if e.get("cat") == "cuda_runtime"}
    anns = [e for e in events if e.get("cat") == "user_annotation"]
    checked = 0
    for k in kernels:
        call, src = calls[k["args"]["correlation"]], src_calls[k["args"]["correlation"]]
        assert call["ts"] == pytest.approx(float(src["ts"]) - offset - tracer.epoch_ns / 1e3)
        inside = [a for a in anns if a["tid"] == src["tid"]
                  and a["ts"] <= src["ts"] <= a["ts"] + a["dur"]]
        for a in inside:
            on_tracer = [s for s in spans if s["name"] == a["name"] and s["tid"] == call["tid"]
                         and s["ts"] - 200 <= call["ts"] <= s["ts"] + s["dur"] + 200]
            assert on_tracer, (a["name"], k["name"])
            checked += 1
    assert checked
    path = tmp_path / "timeline.json.gz"
    obs.write_chrome_trace(path, tracer, obs.MetricsRegistry(), device_trace=events)
    import gzip

    with gzip.open(path, "rt") as f:
        assert len(json.load(f)["traceEvents"]) == len(out)


# -- on the card ---------------------------------------------------------------


@pytest.mark.cuda
def test_sync_debug_mode_warns_as_often_as_the_counter_counts():
    """A small fit's descent on the card (sweep granularity, as the
    benchmark's untraced fits run) under ``torch.cuda.set_sync_debug_mode
    ("warn")``: the syncs torch warns of equal the counter's total. (The
    debug mode does not see ``torch.cuda.synchronize``, which the descent
    calls only at coordinate granularity.)"""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    est = _estimator(device="cuda", dtype=torch.float32)
    coords = est._build_coordinates(_data())
    run_coordinate_descent(coords, ORDER, SWEEPS)  # warm
    torch.cuda.synchronize()
    snap = obs.sync_snapshot()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            run_coordinate_descent(coords, ORDER, SWEEPS)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    counts, _ = obs.syncs_since(snap)
    warned = sum(1 for w in caught if "synchroniz" in str(w.message))
    print(f"syncs warned {warned}, counted {sum(counts.values())}: {counts}")
    assert warned == sum(counts.values()) > 0
