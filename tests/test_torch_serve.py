"""Port parity of the serving path: the admission queue, the model
registry with hot swap, the spool, the serving engine and the serving
driver (photon_tpu_torch/serve, photon_tpu_torch/cli/game_serving.py).

Every case of tests/test_serve.py is ported (knobs, typed and counted
sheds, the 2x overload pinned at the cap, packing and dequeue shedding,
leases and drain eviction, swap rollbacks, hot swap under load, the
unknown tenant, a transient ``serve.dispatch`` fault, spool stop and swap
files). The cross-package cases hold the two packages interchangeable:
``model_fingerprint`` of one model directory, ``registry.json``, spool
requests and results, and the engine's answers (bit for bit the port's
``score_data``, within 1e-5 of JAX's engine, float32 on both sides). The
driver runs on the CPU with ``--max-requests``, an applied and a
rolled-back swap and ``--resume``, and is held to JAX's driver.

The workload is scripts/load_harness.build_workload's (a fixed effect, a
per-user random effect and a user × item MF coordinate), carried into the
port through numpy.
"""
from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import pytest

from photon_tpu.data.index_map import DefaultIndexMap as JIndexMap
from photon_tpu.data.index_map import feature_key as j_feature_key
from photon_tpu.game.recovery import classify_failure as j_classify
from photon_tpu.io.model_io import load_game_model as j_load_game_model
from photon_tpu.io.model_io import read_model_feature_keys as j_read_keys
from photon_tpu.io.model_io import save_game_model as j_save_game_model
from photon_tpu.serve import spool as jspool
from photon_tpu.serve.admission import DeadlineExceeded as JDeadlineExceeded
from photon_tpu.serve.registry import ModelRegistry as JModelRegistry
from photon_tpu.serve.registry import SwapValidationError as JSwapValidationError
from photon_tpu.serve.registry import model_fingerprint as j_fingerprint
from photon_tpu_torch import obs
from photon_tpu_torch.game.data import GameData, slice_game_data
from photon_tpu_torch.game.recovery import classify_failure
from photon_tpu_torch.game.scoring import GameScorer
from photon_tpu_torch.io.data_reader import FeatureShardConfig
from photon_tpu_torch.io.model_io import load_game_model, read_model_feature_keys
from photon_tpu_torch.serve import spool
from photon_tpu_torch.serve.admission import (
    AdmissionQueue,
    AdmissionRejected,
    DeadlineExceeded,
    ServeFuture,
    serve_deadline_s,
    serve_queue_cap,
)
from photon_tpu_torch.serve.engine import SERVE_STAGES, ServingEngine
from photon_tpu_torch.serve.registry import (
    ModelRegistry,
    ServeMemoryBudgetError,
    SwapValidationError,
    model_fingerprint,
    serve_mem_budget_bytes,
)
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.util import faults
from test_torch_game import _numpy_model
from test_torch_scoring_stream import _port_data

SCRIPTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts")
if SCRIPTS not in sys.path:
    sys.path.insert(0, SCRIPTS)

BATCH_ROWS = 32
SHARD_ARG = "name=global,feature.bags=features,intercept=false"


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    for var in ("PHOTON_SERVE_QUEUE_CAP", "PHOTON_SERVE_DEADLINE_S", "PHOTON_SERVE_MEM_BYTES",
                "PHOTON_SLO_SPEC", "PHOTON_FAULTS", "PHOTON_OBS"):
        monkeypatch.delenv(var, raising=False)
    obs.reset()
    faults.clear()
    yield
    faults.clear()
    obs.reset()
    obs.disable()
    obs.slo.clear()


def _counters():
    return obs.get_registry().snapshot()["counters"]


def _chunk(rows: int = 4, seed: int = 0) -> GameData:
    """A featureless chunk: the offsets carry the signal."""
    rng = np.random.default_rng(seed)
    return GameData.build(labels=np.zeros(rows), offsets=rng.normal(size=rows),
                          feature_shards={}, id_tags={})


_WORKLOADS: dict = {}


def _jax_workload(seed: int = 0, num_requests: int = 6):
    """(JAX scorer, JAX chunks) of load_harness.build_workload, cached."""
    import load_harness

    key = (seed, num_requests)
    if key not in _WORKLOADS:
        _WORKLOADS[key] = load_harness.build_workload(
            num_requests=num_requests, batch_rows=BATCH_ROWS, d=8, nnz=4, users=8, items=4,
            seed=seed,
        )
    return _WORKLOADS[key]


def _workload(seed: int = 0, num_requests: int = 6):
    """(port model, port chunks) of the same workload."""
    jscorer, jchunks = _jax_workload(seed, num_requests)
    return (_numpy_model(jscorer.model, TaskType.LOGISTIC_REGRESSION),
            [_port_data(c) for c in jchunks])


def _scorer(model) -> GameScorer:
    return GameScorer(model, device="cpu", batch_rows=BATCH_ROWS)


def _start_engine(reg, *, cap=64, poll_s=0.02):
    q = AdmissionQueue(cap=cap, default_deadline_s=30.0, max_rows=BATCH_ROWS)
    engine = ServingEngine(reg, q, batch_rows=BATCH_ROWS, poll_s=poll_s)
    engine.start()
    return engine, q


def _registry(**kw) -> ModelRegistry:
    return ModelRegistry(device="cpu", **kw)


# -- knobs ------------------------------------------------------------------


def test_serve_knobs_env_wins_and_bad_values_raise(monkeypatch):
    assert serve_queue_cap() == 64
    assert serve_queue_cap(10) == 10
    monkeypatch.setenv("PHOTON_SERVE_QUEUE_CAP", "7")
    assert serve_queue_cap(10) == 7
    monkeypatch.setenv("PHOTON_SERVE_QUEUE_CAP", "0")
    with pytest.raises(ValueError):
        serve_queue_cap()
    monkeypatch.delenv("PHOTON_SERVE_QUEUE_CAP")
    assert serve_deadline_s() == 30.0
    monkeypatch.setenv("PHOTON_SERVE_DEADLINE_S", "2.5")
    assert serve_deadline_s(9.0) == 2.5
    monkeypatch.setenv("PHOTON_SERVE_DEADLINE_S", "-1")
    with pytest.raises(ValueError):
        serve_deadline_s()
    monkeypatch.delenv("PHOTON_SERVE_DEADLINE_S")
    assert serve_mem_budget_bytes() is None
    monkeypatch.setenv("PHOTON_SERVE_MEM_BYTES", "1024")
    assert serve_mem_budget_bytes(4) == 1024
    monkeypatch.setenv("PHOTON_SERVE_MEM_BYTES", "0")
    with pytest.raises(ValueError):
        serve_mem_budget_bytes()


def test_serve_future_timeout_and_exception():
    fut = ServeFuture()
    with pytest.raises(TimeoutError):
        fut.result(timeout=0.01)
    fut.set_exception(DeadlineExceeded("too late"))
    assert fut.done()
    with pytest.raises(DeadlineExceeded):
        fut.result(timeout=0)
    ok = ServeFuture()
    ok.set_result(np.arange(3))
    assert ok.exception() is None
    np.testing.assert_array_equal(ok.result(timeout=0), np.arange(3))


def test_serving_failure_kinds_equal_jax():
    """load_shed and rollback are never restart fuel, in both packages."""
    from photon_tpu.serve.admission import AdmissionRejected as JAdmissionRejected

    pairs = [(DeadlineExceeded("late"), JDeadlineExceeded("late")),
             (AdmissionRejected("full"), JAdmissionRejected("full")),
             (SwapValidationError("bad fp"), JSwapValidationError("bad fp"))]
    kinds = [classify_failure(t) for t, _ in pairs]
    assert kinds == [j_classify(j) for _, j in pairs] == ["load_shed", "load_shed", "rollback"]


# -- admission and shedding -------------------------------------------------


def test_admission_sheds_are_typed_and_counted():
    obs.enable()
    q = AdmissionQueue(cap=2, default_deadline_s=30.0, max_rows=8)
    with pytest.raises(AdmissionRejected):
        q.submit(_chunk(rows=9))  # oversize: can never fit a batch
    with pytest.raises(DeadlineExceeded):  # born already dead
        q.submit(_chunk(), arrival_t=time.perf_counter() - 5.0, deadline_s=1.0)
    q.submit(_chunk())
    q.submit(_chunk())
    with pytest.raises(AdmissionRejected):
        q.submit(_chunk())  # queue_full at the cap
    q.close()
    with pytest.raises(AdmissionRejected):
        q.submit(_chunk())  # closed
    assert q.shed_count == 4
    c = _counters()
    assert c.get("serve.shed") == 4
    for reason in ("oversize", "deadline", "queue_full", "closed"):
        assert c.get(f"serve.shed.{reason}") == 1, reason
    assert c.get("serve.shed.tenant.default") == 4
    assert c.get("serve.admitted") == 2


def test_overload_2x_queue_pinned_at_cap_with_synchronous_rejections():
    obs.enable()
    cap = 8
    q = AdmissionQueue(cap=cap, default_deadline_s=30.0, max_rows=64)
    admitted = rejected = 0
    for i in range(2 * cap):
        t0 = time.perf_counter()
        try:
            q.submit(_chunk(seed=i))
            admitted += 1
        except AdmissionRejected:
            rejected += 1
            assert time.perf_counter() - t0 < 1.0  # answered inside the call
        assert q.depth() <= cap
    assert (admitted, rejected, q.depth()) == (cap, cap, cap)
    assert _counters().get("serve.shed.queue_full") == cap


def test_admit_fault_point_fires_inside_submit():
    q = AdmissionQueue(cap=4, default_deadline_s=30.0)
    with faults.injected("serve.admit@2=error"):
        q.submit(_chunk())
        with pytest.raises(faults.InjectedFault, match="serve.admit"):
            q.submit(_chunk())
    assert q.depth() == 1


def test_next_batch_packs_same_tenant_within_max_rows():
    q = AdmissionQueue(cap=16, default_deadline_s=30.0, max_rows=16)
    q.submit(_chunk(rows=6), tenant="a")
    q.submit(_chunk(rows=6), tenant="a")
    q.submit(_chunk(rows=6), tenant="b")
    q.submit(_chunk(rows=4), tenant="a")
    batch = q.next_batch(max_rows=16, timeout=0.1)
    assert [r.tenant for r in batch] == ["a", "a", "a"]
    assert sum(r.chunk.num_samples for r in batch) == 16
    assert [r.tenant for r in q.next_batch(max_rows=16, timeout=0.1)] == ["b"]
    assert q.next_batch(max_rows=16, timeout=0.05) is None  # timeout tick
    q.close()
    assert q.next_batch(max_rows=16, timeout=0.05) == []  # drained and closed


def test_next_batch_sheds_expired_requests_at_dequeue():
    obs.enable()
    q = AdmissionQueue(cap=8, default_deadline_s=30.0, max_rows=16)
    dead = q.submit(_chunk(), deadline_s=0.01)
    live = q.submit(_chunk(), deadline_s=30.0)
    time.sleep(0.05)
    batch = q.next_batch(max_rows=16, timeout=0.1)
    assert len(batch) == 1 and batch[0].future is live is not dead
    with pytest.raises(DeadlineExceeded):
        dead.result(timeout=0)
    assert _counters().get("serve.shed.deadline") == 1 and q.shed_count == 1


# -- registry: pricing, leases, hot swap ------------------------------------


def test_registry_register_prices_and_rejects_duplicates():
    model, _ = _workload()
    reg = _registry()
    info = reg.register("t1", model, batch_rows=BATCH_ROWS)
    # the tables on the scorer's device (here the host): 8 FE + 9x8 RE +
    # 9x4 + 5x4 MF float32 values and an 8x9 int64 RE column map
    assert info["table_bytes"] == 4 * (8 + 72 + 36 + 20) + 8 * 72
    assert info["fingerprint"] == model_fingerprint(model)
    assert reg.tenants() == ["t1"]
    with pytest.raises(ValueError, match="begin_swap"):
        reg.register("t1", model, batch_rows=BATCH_ROWS)


def test_registry_memory_budget_refuses_loudly():
    model, _ = _workload()
    reg = _registry(mem_budget_bytes=1)
    with pytest.raises(ServeMemoryBudgetError, match="PHOTON_SERVE_MEM_BYTES"):
        reg.register("t1", model, batch_rows=BATCH_ROWS)
    assert reg.tenants() == []


def test_registry_leases_and_drain_evict():
    obs.enable()
    model_a, _ = _workload(seed=0)
    model_b, _ = _workload(seed=1)
    reg = _registry()
    reg.register("t", model_a, batch_rows=BATCH_ROWS)
    old = reg.acquire("t")
    assert reg.in_flight("t") == 1
    reg.begin_swap("t", model_b, batch_rows=BATCH_ROWS)
    assert reg.has_pending_swap("t")
    with faults.injected("serve.evict@*=stall:0"):
        assert reg.apply_pending_swap("t")
        assert faults.active()._counts.get("serve.evict", 0) == 0  # pinned by the lease
        assert _counters().get("serve.evicted") is None
        assert reg.snapshot()["t"]["draining"] == 1
        fresh = reg.acquire("t")
        assert fresh is not old
        reg.release("t", fresh)
        reg.release("t", old)  # the last old lease retires: tables dropped
        assert faults.active()._counts["serve.evict"] == 1
    assert _counters().get("serve.evicted") == 1
    snap = reg.snapshot()["t"]
    assert (snap["draining"], snap["swaps"]) == (0, 1)


def test_swap_validation_failures_roll_back():
    obs.enable()
    model_a, _ = _workload(seed=0)
    model_b, _ = _workload(seed=1)
    reg = _registry()
    reg.register("t", model_a, batch_rows=BATCH_ROWS)
    fp_before = reg.snapshot()["t"]["fingerprint"]
    with pytest.raises(SwapValidationError, match="fingerprints"):
        reg.begin_swap("t", model_b, expect_fingerprint="0" * 64, batch_rows=BATCH_ROWS)

    def torn_loader():
        raise OSError("torn checkpoint mid-read")

    with pytest.raises(SwapValidationError, match="torn checkpoint"):
        reg.begin_swap("t", torn_loader, batch_rows=BATCH_ROWS)
    assert not reg.has_pending_swap("t")
    assert reg.snapshot()["t"]["fingerprint"] == fp_before
    assert reg.snapshot()["t"]["swaps"] == 0
    assert _counters().get("serve.swap_rollbacks") == 2


def test_registry_manifest_roundtrip_and_torn_manifest_raises(tmp_path):
    model, _ = _workload()
    path = str(tmp_path / "registry.json")
    reg = _registry(manifest_path=path)
    reg.register("t", model, model_dir="/models/t/best", batch_rows=BATCH_ROWS)
    doc = ModelRegistry.load_manifest(path)
    assert doc["t"]["model_dir"] == "/models/t/best"
    assert doc["t"]["fingerprint"] == model_fingerprint(model)
    with open(path, "w") as f:
        f.write('{"t": {"model_dir"')  # a torn write
    with pytest.raises(json.JSONDecodeError):
        ModelRegistry.load_manifest(path)


def test_registry_manifest_interchanges_with_jax(tmp_path):
    """registry.json written by either package reads back the same in the
    other: same keys, model dirs and fingerprints."""
    jscorer, _ = _jax_workload()
    model, _ = _workload()
    jpath, tpath = str(tmp_path / "jax.json"), str(tmp_path / "port.json")
    jreg = JModelRegistry(manifest_path=jpath)
    jreg.register("t", jscorer.model, model_dir="/models/t", batch_rows=BATCH_ROWS)
    treg = _registry(manifest_path=tpath)
    treg.register("t", model, model_dir="/models/t", batch_rows=BATCH_ROWS)
    jdoc, tdoc = JModelRegistry.load_manifest(tpath), ModelRegistry.load_manifest(jpath)
    assert set(jdoc["t"]) == set(tdoc["t"]) == {"model_dir", "fingerprint", "table_bytes", "swaps"}
    for key in ("model_dir", "fingerprint", "swaps"):
        assert jdoc["t"][key] == tdoc["t"][key], key


# -- the engine end to end --------------------------------------------------


def test_engine_parity_zero_compiles_and_drain():
    obs.enable()
    model, chunks = _workload(seed=0, num_requests=4)
    requests = [slice_game_data(c, 0, 10) for c in chunks]
    expected = [_scorer(model).score_data(r) for r in requests]
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    futs = [q.submit(r) for r in requests]
    stats = engine.stop()
    for fut, exp in zip(futs, expected):
        np.testing.assert_array_equal(fut.result(timeout=5), exp)
    assert stats.samples == sum(r.num_samples for r in requests)
    assert stats.shed == 0
    # the gate: no one-time cost inside the traffic window
    assert stats.compiles["backend_compiles"] == 0 and reg.swap_build_compiles == 0
    summary = engine.summary()
    assert summary["requests"] == len(requests)
    assert summary["compiles"]["backend_compiles"] == 0
    assert set(stats.stage_walls_s) <= set(SERVE_STAGES)


def test_engine_counts_a_dispatch_at_an_unwarmed_shape():
    """A request wider than the warmed ELL width is served, and the gate
    counts its one-time cost (the port's cold dispatch)."""
    model, chunks = _workload(seed=0, num_requests=2)
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    wide = slice_game_data(chunks[0], 0, 4)
    m = wide.feature_shards["global"]
    # 16 nonzeros in row 0 (duplicate columns sum): ELL width 16, not 8
    indices = np.concatenate([np.tile(m.indices[:4], 4), m.indices[4:]])
    values = np.concatenate([np.tile(m.values[:4] / 4, 4), m.values[4:]])
    indptr = m.indptr.copy()
    indptr[1:] += 12
    shard = type(m)(indptr=indptr, indices=indices, values=values, num_cols=m.num_cols)
    wide = GameData(labels=wide.labels, offsets=wide.offsets, weights=wide.weights,
                    feature_shards={"global": shard}, id_tags=wide.id_tags)
    fut = q.submit(wide)
    stats = engine.stop()
    np.testing.assert_allclose(fut.result(timeout=5), _scorer(model).score_data(wide),
                               rtol=1e-6, atol=1e-6)
    assert stats.compiles["cold_dispatches"] == stats.compiles["backend_compiles"] == 1


def test_engine_answers_equal_jax_engine():
    """The same requests through both engines, float32 on both sides."""
    from photon_tpu.serve.admission import AdmissionQueue as JQueue
    from photon_tpu.serve.engine import ServingEngine as JEngine

    jscorer, jchunks = _jax_workload(seed=0, num_requests=4)
    model, chunks = _workload(seed=0, num_requests=4)
    rows = (10, 7, 32, 1)
    jreg = JModelRegistry()
    jreg.register("default", jscorer.model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    jq = JQueue(cap=64, default_deadline_s=30.0, max_rows=BATCH_ROWS)
    jengine = JEngine(jreg, jq, batch_rows=BATCH_ROWS, poll_s=0.02)
    jengine.start()
    from photon_tpu.game.data import slice_game_data as j_slice

    jfuts = [jq.submit(j_slice(c, 0, n)) for c, n in zip(jchunks, rows)]
    jengine.stop()
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    futs = [q.submit(slice_game_data(c, 0, n)) for c, n in zip(chunks, rows)]
    engine.stop()
    for fut, jfut in zip(futs, jfuts):
        got, want = fut.result(timeout=5), np.asarray(jfut.result(timeout=5))
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_engine_hot_swap_under_load_answers_everything():
    obs.enable()
    model_a, chunks = _workload(seed=0, num_requests=6)
    model_b, _ = _workload(seed=1, num_requests=6)
    requests = [slice_game_data(c, 0, 8) for c in chunks]
    exp_a = [_scorer(model_a).score_data(r) for r in requests]
    exp_b = [_scorer(model_b).score_data(r) for r in requests]
    reg = _registry()
    reg.register("default", model_a, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    pre = [q.submit(r) for r in requests[:3]]
    reg.begin_swap("default", model_b, expect_fingerprint=model_fingerprint(model_b))
    deadline = time.perf_counter() + 10
    while reg.has_pending_swap("default"):
        assert time.perf_counter() < deadline, "engine never applied the flip"
        time.sleep(0.005)
    post = [q.submit(r) for r in requests[3:]]
    stats = engine.stop()
    # a request admitted before the flip may dispatch after it
    for i, fut in enumerate(pre):
        got = fut.result(timeout=5)
        assert np.array_equal(got, exp_a[i]) or np.array_equal(got, exp_b[i])
    for i, fut in enumerate(post, start=3):
        np.testing.assert_array_equal(fut.result(timeout=5), exp_b[i])
    assert stats.shed == 0
    assert stats.compiles["backend_compiles"] == reg.swap_build_compiles == 0
    assert engine.last_swap is not None and engine.last_swap["tenant"] == "default"
    assert _counters().get("serve.swaps") == 1


def test_engine_unknown_tenant_answered_not_wedged():
    obs.enable()
    model, chunks = _workload(seed=0, num_requests=2)
    req = slice_game_data(chunks[0], 0, 6)
    expected = _scorer(model).score_data(req)
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    ghost = q.submit(req, tenant="ghost")
    good = q.submit(req, tenant="default")
    engine.stop()
    with pytest.raises(KeyError):
        ghost.result(timeout=5)
    np.testing.assert_array_equal(good.result(timeout=5), expected)
    assert _counters().get("serve.dispatch_failures") == 1


def test_engine_transient_dispatch_fault_retries_in_place():
    obs.enable()
    model, chunks = _workload(seed=0, num_requests=2)
    req = slice_game_data(chunks[0], 0, 6)
    expected = _scorer(model).score_data(req)
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    with faults.injected("serve.dispatch@1=unavailable"):
        engine, q = _start_engine(reg)
        fut = q.submit(req)
        stats = engine.stop()
    np.testing.assert_array_equal(fut.result(timeout=5), expected)
    assert stats.batch_retries >= 1
    c = _counters()
    assert c.get("retry.attempts.serve_batch") == 1 and c.get("serve.batch_retries") == 1


def test_engine_poisoned_batch_answers_every_future_and_keeps_serving():
    obs.enable()
    model, chunks = _workload(seed=0, num_requests=2)
    req = slice_game_data(chunks[0], 0, 6)
    expected = _scorer(model).score_data(req)
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    with faults.injected("serve.dispatch@1=error"):
        engine, q = _start_engine(reg)
        bad = q.submit(req)
        with pytest.raises(faults.InjectedFault):
            bad.result(timeout=5)
        good = q.submit(req)
        engine.stop()
    np.testing.assert_array_equal(good.result(timeout=5), expected)
    assert _counters().get("serve.dispatch_failures") == 1
    assert reg.in_flight("default") == 0


def test_engine_feeds_the_slo_per_request():
    obs.enable()
    obs.slo.install("p99<=10s@60s")
    model, chunks = _workload(seed=0, num_requests=3)
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    for c in chunks:
        q.submit(slice_game_data(c, 0, 5))
    engine.stop()
    doc = obs.slo.report()
    assert doc["batches"] == 3 and doc["violations"] == 0 and doc["objective"]["ok"]
    assert set(doc["waterfall"]) <= set(SERVE_STAGES) and "queue" in doc["waterfall"]
    assert doc["counters"]["serve.requests"] == 3


# -- the spool transport ----------------------------------------------------


def test_spool_request_roundtrip_and_result_retires_request(tmp_path):
    _, chunks = _workload(seed=0, num_requests=2)
    chunk = slice_game_data(chunks[0], 0, 5)
    spool_dir = str(tmp_path / "spool")
    path = spool.write_request(spool_dir, 3, chunk, tenant="t", deadline_s=9.0,
                               arrival_wall=123.5)
    assert spool.pending_requests(spool_dir) == [path]
    assert spool.request_seq(path) == 3
    back, meta = spool.read_request(path)
    assert meta == {"seq": 3, "tenant": "t", "deadline_s": 9.0, "arrival_wall": 123.5}
    assert back.num_samples == chunk.num_samples
    np.testing.assert_array_equal(back.labels, chunk.labels)
    np.testing.assert_array_equal(back.offsets, chunk.offsets)
    for name, m in chunk.feature_shards.items():
        np.testing.assert_array_equal(back.feature_shards[name].indptr, m.indptr)
        np.testing.assert_array_equal(back.feature_shards[name].values, m.values)
    for tag, col in chunk.id_tags.items():
        np.testing.assert_array_equal(back.id_tags[tag], np.asarray(col, dtype=str))
    res = spool.write_result(spool_dir, 3, scores=np.arange(5.0))
    assert not os.path.exists(path)
    out = spool.read_result(res)
    assert out["seq"] == 3
    np.testing.assert_array_equal(out["scores"], np.arange(5.0))
    out = spool.read_result(spool.write_result(spool_dir, 4, error=DeadlineExceeded("late")))
    assert out["error_type"] == "DeadlineExceeded" and "late" in out["error_message"]


def test_spool_rebase_arrival_preserves_age():
    rebased = spool.rebase_arrival(time.time() - 2.0)
    assert time.perf_counter() - rebased == pytest.approx(2.0, abs=0.2)


def test_spool_swap_command_and_stop_files(tmp_path):
    d = str(tmp_path / "spool")
    cmd_path = spool.write_swap_command(d, "t", "/models/new", expect_fingerprint="abc")
    cmds = spool.read_swap_command(d)
    assert len(cmds) == 1
    assert (cmds[0]["model_dir"], cmds[0]["expect_fingerprint"], cmds[0]["_path"]) == (
        "/models/new", "abc", cmd_path)
    spool.write_swap_outcome(d, "t", {"status": "applied"}, command_path=cmd_path)
    assert spool.read_swap_command(d) == []
    with open(os.path.join(d, "swap-t.done.json")) as f:
        assert json.load(f)["status"] == "applied"
    assert not spool.stop_requested(d)
    spool.request_stop(d)
    assert spool.stop_requested(d)
    # each package reads the other's control files
    assert jspool.stop_requested(d)
    jpath = jspool.write_swap_command(d, "u", "/m", expect_fingerprint="f")
    assert [(c["tenant"], c["_path"]) for c in spool.read_swap_command(d)] == [("u", jpath)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_spool_requests_and_results_interchange(tmp_path, writer):
    """A request written by one package is served by the port's engine and
    its result read by the other package's read_result (and the port reads
    JAX's results)."""
    from photon_tpu.game.data import slice_game_data as j_slice

    jscorer, jchunks = _jax_workload(seed=0, num_requests=2)
    model, chunks = _workload(seed=0, num_requests=2)
    d = str(tmp_path / "spool")
    if writer == "jax":
        jspool.write_request(d, 1, j_slice(jchunks[0], 0, 9), tenant="default", deadline_s=30.0)
    else:
        spool.write_request(d, 1, slice_game_data(chunks[0], 0, 9), deadline_s=30.0)
    chunk, meta = spool.read_request(spool.pending_requests(d)[0])
    jchunk, jmeta = jspool.read_request(jspool.pending_requests(d)[0])
    assert meta == jmeta
    reg = _registry()
    reg.register("default", model, batch_rows=BATCH_ROWS, ell_widths={"global": 4})
    engine, q = _start_engine(reg)
    fut = q.submit(chunk, tenant=meta["tenant"], arrival_t=spool.rebase_arrival(
        meta["arrival_wall"]), deadline_s=meta["deadline_s"])
    engine.stop()
    spool.write_result(d, 1, scores=fut.result(timeout=5))
    got = jspool.read_result(spool.result_path(d, 1))
    np.testing.assert_array_equal(got["scores"], _scorer(model).score_data(chunk))
    np.testing.assert_allclose(got["scores"], np.asarray(jscorer.score_data(jchunk)),
                               rtol=1e-5, atol=1e-5)
    jspool.write_result(d, 2, error=JDeadlineExceeded("late"))
    back = spool.read_result(spool.result_path(d, 2))
    assert back["error_type"] == "DeadlineExceeded" and back["seq"] == 2


# -- model directories: fingerprints and the driver -------------------------


def _save_models(root) -> dict:
    """Workload models A (seed 0) and B (seed 1) saved in the reference
    layout by the JAX package; the shard's features are ``f0..f7``, so the
    request columns index the maps both packages rebuild from the model."""
    maps = {"global": JIndexMap.from_keys([j_feature_key(f"f{i}") for i in range(8)],
                                          add_intercept=False)}
    dirs = {}
    for name, seed in (("a", 0), ("b", 1)):
        jscorer, _ = _jax_workload(seed=seed)
        dirs[name] = str(root / name)
        j_save_game_model(dirs[name], jscorer.model, maps)
    return dirs


def _load_both(model_dir):
    from photon_tpu.io.data_reader import FeatureShardConfig as JShard

    jmodel = j_load_game_model(model_dir, j_read_keys(
        model_dir, {"global": JShard(feature_bags=("features",), has_intercept=False)}))
    tmodel = load_game_model(model_dir, read_model_feature_keys(
        model_dir, {"global": FeatureShardConfig(feature_bags=("features",),
                                                 has_intercept=False)}))
    return jmodel, tmodel


def test_model_fingerprint_equal_across_packages(tmp_path):
    dirs = _save_models(tmp_path)
    fps = {}
    for name, d in dirs.items():
        jmodel, tmodel = _load_both(d)
        fps[name] = model_fingerprint(tmodel)
        assert fps[name] == j_fingerprint(jmodel), name
    assert fps["a"] != fps["b"]
    # the in-memory model and its carried copy hash the same too
    jscorer, _ = _jax_workload(seed=0)
    assert model_fingerprint(_workload(seed=0)[0]) == j_fingerprint(jscorer.model)


def _serve_argv(out, spool_dir, *extra):
    return ["--root-output-directory", str(out), "--spool-directory", str(spool_dir),
            "--feature-shard-configurations", SHARD_ARG, "--score-batch-rows", str(BATCH_ROWS),
            "--precompile-nnz", "global=4", "--queue-cap", "512", "--poll-s", "0.01", *extra]


def _drive(run, argv, spool_dir, requests, swaps, tmp_path, tag):
    """Run a serving driver in a thread; write ``requests`` (a list of
    (seq, chunk) writers) in waves, a swap command between the waves, and
    wait for every answer and swap outcome."""
    import threading

    result: dict = {}
    err: list = []

    def target():
        try:
            result.update(run(argv))
        except BaseException as e:  # reported below
            err.append(e)

    t = threading.Thread(target=target, daemon=True)
    t.start()
    for wave, swap in zip(requests, swaps + [None]):
        for seq, write in wave:
            write(spool_dir, seq)
        _wait(lambda: all(os.path.exists(spool.result_path(spool_dir, s)) for s, _ in wave),
              err, f"{tag}: answers")
        if swap is not None:
            tenant, model_dir, fp = swap
            done = os.path.join(spool_dir, f"swap-{tenant}.done.json")
            if os.path.exists(done):
                os.remove(done)
            spool.write_swap_command(spool_dir, tenant, model_dir, expect_fingerprint=fp)
            _wait(lambda: os.path.exists(done), err, f"{tag}: swap outcome")
            with open(done) as f:
                result.setdefault("swaps", []).append(json.load(f))
    t.join(60)
    assert not err, err
    assert not t.is_alive()
    return result


def _wait(cond, err, what, timeout=60.0):
    deadline = time.perf_counter() + timeout
    while not cond():
        assert not err, err
        assert time.perf_counter() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def test_serving_driver_swaps_resumes_and_equals_jax(tmp_path):
    """The port's driver and JAX's on the same model directories and the
    same request envelopes: 4 requests on A, a rolled-back swap (wrong
    fingerprint), an applied swap to B, 4 more requests; then a --resume
    relaunch into the port's root serves 2 requests left on disk with the
    manifest's tenant (B). Every request is answered once; the summary has
    JAX's keys; the scores agree within 1e-5 (float32 on both sides)."""
    from photon_tpu.cli import game_serving as j_serving
    from photon_tpu.game.data import slice_game_data as j_slice
    from photon_tpu_torch.cli import game_serving as t_serving

    dirs = _save_models(tmp_path)
    jmodel_a, tmodel_a = _load_both(dirs["a"])
    jmodel_b, tmodel_b = _load_both(dirs["b"])
    fp_b = model_fingerprint(tmodel_b)
    _, jchunks = _jax_workload(seed=0, num_requests=6)
    rows = [5, 9, 13, 32, 1, 20, 7, 11, 16, 3]

    def writers(pkg):
        out = []
        for i, n in enumerate(rows):
            c = jchunks[i % len(jchunks)]
            if pkg == "jax":
                out.append((i + 1, lambda d, s, c=c, n=n: jspool.write_request(
                    d, s, j_slice(c, 0, n), deadline_s=120.0)))
            else:
                out.append((i + 1, lambda d, s, c=_port_data(c), n=n: spool.write_request(
                    d, s, slice_game_data(c, 0, n), deadline_s=120.0)))
        return out

    runs = {}
    for pkg, run in (("jax", j_serving.run),
                     ("port", lambda argv: t_serving.run(argv, device="cpu"))):
        spool_dir = tmp_path / pkg / "spool"
        w = writers(pkg)
        argv = _serve_argv(tmp_path / pkg / "out", spool_dir, "--model", f"default={dirs['a']}",
                           "--max-requests", "8")
        swaps = [None, ("default", dirs["b"], "0" * 64), ("default", dirs["b"], fp_b)]
        # waves: 4 requests, (rolled-back swap), nothing, (applied swap), 4 more
        runs[pkg] = _drive(run, argv, str(spool_dir), [w[:4], [], w[4:8]], swaps[1:],
                           tmp_path, pkg)
    # the JAX driver's 8 answers on A then B (float32) hold the port's
    for pkg in runs:
        assert runs[pkg]["answered"] == 8
        assert [s["status"] for s in runs[pkg]["swaps"]] == ["rolled_back", "applied"]
        assert runs[pkg]["swaps"][1]["fingerprint"] == fp_b
    sj = json.loads((tmp_path / "jax" / "out" / "serve-summary.json").read_text())
    st = json.loads((tmp_path / "port" / "out" / "serve-summary.json").read_text())
    assert set(st) == set(sj)
    assert set(st["registry"]["default"]) == set(sj["registry"]["default"])
    assert st["registry"]["default"]["fingerprint"] == fp_b[:16]
    assert (st["shed"], st["dispatch_failures"], st["requests"]) == (0, 0, 8)
    assert st["compiles"]["backend_compiles"] == st["swap_build_compiles"] == 0
    for seq in range(1, 9):
        got = spool.read_result(spool.result_path(str(tmp_path / "port" / "spool"), seq))
        want = jspool.read_result(jspool.result_path(str(tmp_path / "jax" / "spool"), seq))
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-5)
        model = tmodel_a if seq <= 4 else tmodel_b
        chunk = slice_game_data(_port_data(jchunks[(seq - 1) % len(jchunks)]), 0, rows[seq - 1])
        np.testing.assert_array_equal(got["scores"], _scorer(model).score_data(chunk))
    obs_dir = tmp_path / "port" / "out" / "obs"
    for name in ("trace.json", "metrics.json", "manifest.jsonl", "series.jsonl",
                 "memory_report.json", "summary.txt", "slo_report.json"):
        assert (obs_dir / name).exists(), name
    with open(obs_dir / "metrics.json") as f:
        counters = json.load(f)["metrics"]["counters"]
    assert counters["recovery.failures.rollback"] == 1 and counters["serve.swaps"] == 1
    manifest = ModelRegistry.load_manifest(str(tmp_path / "port" / "out" / "registry.json"))
    assert manifest["default"]["model_dir"] == dirs["b"] and manifest["default"]["swaps"] == 1

    # --resume: two requests left on disk are served by the manifest's B
    spool_dir = str(tmp_path / "port" / "spool")
    w = writers("port")
    res = _drive(lambda argv: t_serving.run(argv, device="cpu"),
                 _serve_argv(tmp_path / "port" / "out", spool_dir, "--resume",
                             "--max-requests", "2"),
                 spool_dir, [w[8:]], [], tmp_path, "resume")
    assert res["answered"] == 2
    for seq in (9, 10):
        got = spool.read_result(spool.result_path(spool_dir, seq))
        chunk = slice_game_data(_port_data(jchunks[(seq - 1) % len(jchunks)]), 0, rows[seq - 1])
        np.testing.assert_array_equal(got["scores"], _scorer(tmodel_b).score_data(chunk))
    assert spool.pending_requests(spool_dir) == []
