"""Port fault injection, retry and supervised restarts, against the JAX
package.

The fault plan grammar and its occurrence counting, the failure
classifier, the retry policy and the restart loop (restarts counted
through ``on_restart`` and the log) behave as JAX's. In a GLMix fit at
float64 on the CPU, a transient fault at a sweep and a NaN injected into
a coordinate's state are recovered by a supervised restart from the
newest checkpoint: the model equals the uninterrupted fit's bit for bit,
and JAX's uninterrupted fit's within 1e-9.
"""
from __future__ import annotations

import errno
import functools
import gc
import logging
import random
import time

import jax
import numpy as np
import pytest

import photon_tpu_torch.game.estimator as estimator_mod
from photon_tpu.game import data as jdata
from photon_tpu.game.recovery import classify_failure as j_classify
from photon_tpu.obs.health import DivergenceError as JDivergenceError
from photon_tpu.util import faults as jfaults
from photon_tpu.util import retry as jretry
from photon_tpu_torch import obs
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.recovery import (
    classify_failure,
    max_restarts_from_env,
    run_with_recovery,
)
from photon_tpu_torch.obs.health import DivergenceError
from photon_tpu_torch.util import faults, retry
from photon_tpu_torch.util.faults import InjectedCrash, InjectedFault, InjectedIOError
from test_torch_checkpoint import _arrays, _data, _jax, _port, assert_models_close, \
    assert_models_identical


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the JAX programs this module compiled when it ends: each keeps
    memory maps of its code, and one process running many such modules
    would reach the kernel's limit on maps (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear()
    yield
    faults.clear()


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------


SPECS = [
    "descent.sweep@2=unavailable",
    "descent.coordinate@3=nan;checkpoint.write@*=io_error",
    " checkpoint.replace@1=crash ; descent.sweep@7=stall:0.5 ",
    "a.b@1=error;a.b@2=kill",
]


@pytest.mark.parametrize("spec", SPECS)
def test_plan_parse_round_trip_equals_jax(spec):
    plan = faults.parse_plan(spec)
    assert plan.render() == jfaults.parse_plan(spec).render()
    assert faults.parse_plan(plan.render()).render() == plan.render()


@pytest.mark.parametrize("bad", ["", ";", "p@1", "p=nan", "@1=nan", "p@0=nan", "p@1=boom",
                                 "p@x=nan"])
def test_plan_parse_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jfaults.parse_plan(bad)
    with pytest.raises(ValueError):
        faults.parse_plan(bad)


def test_occurrence_matching_is_deterministic():
    with faults.injected("p@2=io_error;q@*=nan"):
        assert faults.fault_point("p") is None  # occurrence 1
        with pytest.raises(InjectedIOError):
            faults.fault_point("p")  # occurrence 2
        assert faults.fault_point("p") is None  # occurrence 3
        assert faults.fault_point("other") is None  # a point the plan does not name
        assert all(faults.fault_point("q").kind == "nan" for _ in range(3))
    assert faults.active() is None
    assert faults.fault_point("p") is None  # no plan: nothing fires


@pytest.mark.parametrize("kind,exc", [
    ("unavailable", InjectedFault), ("io_error", OSError), ("error", InjectedFault),
    ("crash", InjectedCrash),
])
def test_raising_kinds(kind, exc):
    with faults.injected(f"x@1={kind}"):
        with pytest.raises(exc) as e:
            faults.fault_point("x")
    assert ("UNAVAILABLE" in str(e.value)) == (kind == "unavailable")
    assert not isinstance(e.value, Exception) or kind != "crash"


def test_stall_sleeps_and_returns_the_clause():
    with faults.injected("x@1=stall:0.05"):
        t0 = time.perf_counter()
        clause = faults.fault_point("x")
        assert time.perf_counter() - t0 >= 0.05
    assert (clause.kind, clause.param) == ("stall", "0.05")


def test_install_from_env_and_nested_injection(monkeypatch):
    monkeypatch.setenv("PHOTON_FAULTS", "a@1=nan")
    plan = faults.install_from_env()
    assert plan.render() == "a@1=nan" and faults.active() is plan
    with faults.injected("b@1=nan"):
        assert faults.active().render() == "b@1=nan"
    assert faults.active() is plan  # the previous plan comes back
    monkeypatch.delenv("PHOTON_FAULTS")
    assert faults.install_from_env() is None and faults.active() is None


# ---------------------------------------------------------------------------
# classification, retry policy, the restart loop
# ---------------------------------------------------------------------------


def _pairs():
    """(port exception, the same exception of the JAX package)."""
    return [
        (InjectedFault("UNAVAILABLE: flake"), jfaults.InjectedFault("UNAVAILABLE: flake")),
        (InjectedIOError("torn read"), jfaults.InjectedIOError("torn read")),
        (RuntimeError("DEADLINE_EXCEEDED: slow"), RuntimeError("DEADLINE_EXCEEDED: slow")),
        (FileNotFoundError("gone"), FileNotFoundError("gone")),
        (OSError(errno.ENOSPC, "full"), OSError(errno.ENOSPC, "full")),
        (OSError(errno.EIO, "io"), OSError(errno.EIO, "io")),
        (ValueError("bad shape"), ValueError("bad shape")),
        (DivergenceError("c", 3, {"loss": float("nan")}),
         JDivergenceError("c", 3, {"loss": float("nan")})),
    ]


def test_classify_failure_equals_jax():
    kinds = [classify_failure(t) for t, _ in _pairs()]
    assert kinds == [j_classify(j) for _, j in _pairs()]
    assert kinds == ["transient", "transient", "transient", "fatal", "fatal", "transient",
                     "fatal", "divergent"]
    for t, j in _pairs():
        assert retry.is_transient(t) == jretry.is_transient(j)
        assert retry.is_transient_io(t) == jretry.is_transient_io(j)


def test_retry_policy_waits_equal_jax():
    policy = retry.RetryPolicy(attempts=5, base_s=0.5, multiplier=3.0, cap_s=4.0, jitter=0.2)
    jpolicy = jretry.RetryPolicy(attempts=5, base_s=0.5, multiplier=3.0, cap_s=4.0, jitter=0.2)
    a, b = random.Random(7), random.Random(7)
    assert [policy.wait_s(k, a) for k in range(6)] == [jpolicy.wait_s(k, b) for k in range(6)]
    assert retry.RetryPolicy(jitter=0.0).wait_s(10, a) == 60.0
    for bad in (dict(attempts=0), dict(jitter=1.0)):
        with pytest.raises(ValueError):
            retry.RetryPolicy(**bad)
    assert retry.jitter_rng() is retry.jitter_rng()


def test_run_with_recovery_restarts_transients_and_counts(caplog):
    calls, restarts, waits = [], [], []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise InjectedFault("UNAVAILABLE: flake")
        return "ok"

    obs.reset()
    obs.enable()
    try:
        with caplog.at_level(logging.INFO):
            out = run_with_recovery(
                flaky, max_restarts=2, sleep=waits.append,
                on_restart=lambda i, e: restarts.append((i, type(e).__name__)))
        counters = obs.get_registry().snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert out == "ok" and len(calls) == 3
    assert restarts == [(1, "InjectedFault"), (2, "InjectedFault")]
    assert len(waits) == 2 and 1.8 <= waits[0] <= 2.2 and 3.6 <= waits[1] <= 4.4
    assert "restart 1/2" in caplog.text and "recovered after 2 restart(s)" in caplog.text
    # the decisions are counted with the JAX package's names
    assert counters == {"recovery.failures.transient": 2, "recovery.restarts": 2,
                        "recovery.recovered": 1}


def test_run_with_recovery_fatal_and_exhausted(caplog):
    calls = []

    def broken():
        calls.append(1)
        raise ValueError("a real bug")

    with pytest.raises(ValueError):
        run_with_recovery(broken, max_restarts=5, sleep=lambda s: None)
    assert len(calls) == 1
    calls.clear()

    def diverging():
        calls.append(1)
        raise DivergenceError("c", 0, {"loss": float("nan")})

    obs.reset()
    obs.enable()
    try:
        with pytest.raises(DivergenceError):
            run_with_recovery(diverging, max_restarts=2, sleep=lambda s: None)
        counters = obs.get_registry().snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert len(calls) == 3  # two restarts spent, then the budget is out
    assert "after exhausting 2 restart(s)" in caplog.text
    assert counters == {"recovery.failures.divergent": 3, "recovery.restarts": 2,
                        "recovery.giveup": 1}
    with pytest.raises(ValueError):
        run_with_recovery(lambda: None, max_restarts=-1)


def test_max_restarts_env(monkeypatch):
    assert max_restarts_from_env() == 0
    assert max_restarts_from_env(3) == 3
    monkeypatch.setenv("PHOTON_MAX_RESTARTS", "2")
    assert max_restarts_from_env(5) == 2
    assert _port(max_restarts=5).max_restarts == 2
    monkeypatch.setenv("PHOTON_MAX_RESTARTS", "-1")
    with pytest.raises(ValueError):
        max_restarts_from_env()


# ---------------------------------------------------------------------------
# supervised restarts of a fit, bit-exact
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def uninterrupted():
    """(train data, the port's fit, JAX's fit): one λ, 3 sweeps."""
    arrays = _arrays(n=300, d_fe=8, users=15, seed=3)
    train = _data(tdata, arrays)
    port = _port(grid=(1.0,), validation=False).fit(train)[0]
    jax_res = _jax(grid=(1.0,), validation=False).fit(_data(jdata, arrays))[0]
    assert_models_close(port.model, jax_res.model)
    return train, port, jax_res


@pytest.fixture
def no_backoff(monkeypatch):
    monkeypatch.setattr(estimator_mod, "run_with_recovery",
                        functools.partial(estimator_mod.run_with_recovery,
                                          sleep=lambda s: None))


@pytest.mark.parametrize("plan,kind", [
    ("descent.sweep@2=unavailable", "InjectedFault"),  # the start of sweep 1
    ("descent.coordinate@3=nan", "DivergenceError"),  # sweep 1, the fixed effect
])
def test_fault_auto_resumes_bit_exact(uninterrupted, tmp_path, no_backoff, plan, kind, caplog):
    train, port, jax_res = uninterrupted
    est = _port(grid=(1.0,), validation=False, max_restarts=1)
    with faults.injected(plan), caplog.at_level(logging.INFO):
        got = est.fit(train, checkpoint_dir=str(tmp_path / "ckpt"))[0]
    assert [e.split(":")[0] for e in est.last_fit_stats["restarts"]] == [kind]
    assert est.last_fit_stats["resumed_from"] == (0, 0)
    assert "resuming from checkpoint: grid 0, sweep 0" in caplog.text
    assert_models_identical(port.model, got.model)
    np.testing.assert_array_equal(port.scores, got.scores)
    assert_models_close(got.model, jax_res.model)


def test_fault_without_restart_budget_raises(uninterrupted, tmp_path):
    train, *_ = uninterrupted
    with faults.injected("descent.sweep@2=unavailable"):
        with pytest.raises(InjectedFault, match="UNAVAILABLE"):
            _port(grid=(1.0,), validation=False).fit(train, checkpoint_dir=str(tmp_path / "c"))
    with faults.injected("descent.coordinate@3=nan"):
        with pytest.raises(DivergenceError, match="'fixed' diverged at sweep 1"):
            _port(grid=(1.0,), validation=False).fit(train)


def test_restart_without_checkpoints_retrains_from_scratch(uninterrupted, no_backoff, caplog):
    train, port, _ = uninterrupted
    est = _port(grid=(1.0,), validation=False, max_restarts=1)
    with faults.injected("descent.sweep@3=unavailable"), caplog.at_level(logging.WARNING):
        got = est.fit(train)[0]
    assert "retrains from scratch" in caplog.text
    assert est.last_fit_stats["resumed_from"] is None
    assert_models_identical(port.model, got.model)


def test_fatal_fault_is_not_restarted(uninterrupted, tmp_path, no_backoff):
    train, *_ = uninterrupted
    with faults.injected("descent.sweep@2=error"):
        with pytest.raises(InjectedFault, match="injected fatal"):
            _port(grid=(1.0,), validation=False, max_restarts=3).fit(
                train, checkpoint_dir=str(tmp_path / "c"))
