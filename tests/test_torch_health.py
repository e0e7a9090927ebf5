"""Port parity: the divergence monitor of the descent loop against the JAX
package, at float64 on the CPU.

The input is the config-5-shaped data of tests/test_torch_game.py
(``_arrays(seed=1)``) with one offset set to NaN: the fixed effect's loss
and gradient go non-finite in sweep 0. Under ``raise`` both packages
raise DivergenceError for 'fixed' at sweep 0; under ``warn`` and
``halt_coordinate`` both fit to the end, and their per-sweep health rows
agree where finite, their finite flags exactly. A NaN injected into
one coordinate's state through the fault plan (``descent.coordinate``)
checks ``halt_coordinate`` where the fixed effect stays finite: the same
health rows, and the same final model within 1e-9.

Both packages define the health loss and gradient norm as float32 values.
The loss is a float64 sum rounded to float32, so it agrees within 1e-9
relative. The gradient norm is a float32 sum of squares, and the two
packages sum in different orders, so it is held to two float32 ulps
(2⁻²² relative): on this input one row differs by one ulp.
"""
from __future__ import annotations

import gc
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.obs.health import DivergenceError as JDivergenceError
from photon_tpu.types import TaskType as JTask
from photon_tpu.util import faults as jfaults
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.obs.health import (
    DIVERGENCE_POLICIES,
    DivergenceError,
    resolve_policy,
    sweep_health,
)
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import faults as tfaults
from test_torch_game import UPDATE, _arrays, _game_data, _jax_configs, _torch_configs

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the JAX programs this module compiled when it ends: each keeps
    memory maps of its code, and one process running many such modules
    would reach the kernel's limit on maps (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()

#: two float32 ulps, relative: the float32 gradient norm's resolution
GNORM_TOL = 2.0**-22


def _c1_arrays():
    labels, offsets, shards, ids = _arrays(seed=1)
    offsets = offsets.copy()
    offsets[7] = np.nan
    return labels, offsets, shards, ids


def _fit_pair(arrays, policy, plan=None):
    """(jax result, port result) of the same 2-sweep fit; ``plan`` is a
    fault plan installed in both packages for their fits."""
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
        jest = JEstimator(
            task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
            update_sequence=UPDATE, descent_iterations=2, dtype=jnp.float64,
            on_divergence=policy,
        )
        if plan:
            with jfaults.injected(plan):
                jres = jest.fit(jd)[0]
        else:
            jres = jest.fit(jd)[0]
    test = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
        update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64,
        device="cpu", on_divergence=policy,
    )
    if plan:
        with tfaults.injected(plan):
            tres = test.fit(td)[0]
    else:
        tres = test.fit(td)[0]
    return jres, tres


def _health_rows(result):
    return [r["health"] for r in result.tracker if "health" in r]


def _assert_same_health(jres, tres):
    jrows, trows = _health_rows(jres), _health_rows(tres)
    assert len(jrows) == len(trows) == 2
    for jrow, trow in zip(jrows, trows):
        assert list(trow) == list(jrow)
        for cid in jrow:
            assert trow[cid]["finite"] == jrow[cid]["finite"], cid
            for key in ("loss", "gnorm"):
                want, got = jrow[cid][key], trow[cid][key]
                if math.isfinite(want):
                    rel = TOL if key == "loss" else GNORM_TOL
                    assert got == pytest.approx(want, rel=rel, abs=0), (cid, key)
                else:
                    assert not math.isfinite(got), (cid, key)


def _model_arrays(model, fe_means):
    out = {"fixed": np.asarray(fe_means(model["fixed"]), dtype=np.float64)}
    for cid in ("user", "item"):
        for j, b in enumerate(model[cid].buckets):
            out[f"{cid}/{j}"] = np.asarray(b.coefficients, dtype=np.float64)
    return out


@pytest.fixture(scope="module")
def c1_data():
    return _c1_arrays()


def test_c1_input_raises_divergence_for_fixed_at_sweep_0(c1_data):
    with pytest.raises(JDivergenceError) as jerr:
        _fit_pair(c1_data, "raise")
    td = _game_data(tdata, c1_data)
    with pytest.raises(DivergenceError) as terr:
        TEstimator(
            task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
            update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64, device="cpu",
        ).fit(td)
    assert (terr.value.coordinate, terr.value.iteration) == ("fixed", 0)
    assert (jerr.value.coordinate, jerr.value.iteration) == ("fixed", 0)
    assert str(terr.value) == str(jerr.value)
    assert "coordinate 'fixed' diverged at sweep 0" in str(terr.value)


@pytest.mark.parametrize("policy", ["warn", "halt_coordinate"])
def test_c1_input_policies_match_jax(c1_data, policy):
    jres, tres = _fit_pair(c1_data, policy)
    _assert_same_health(jres, tres)
    assert not _health_rows(tres)[0]["fixed"]["finite"]
    if policy == "halt_coordinate":
        # the offender was re-initialized and frozen: zeros, as in JAX
        got = tres.model["fixed"].coefficients.means
        want = np.asarray(jres.model["fixed"].model.coefficients.means)
        np.testing.assert_array_equal(got, want)
        assert not np.any(got)
        # the halted coordinate took no step in sweep 1
        steps = [r["coordinate"] for r in tres.tracker if r.get("iteration") == 1
                 and "coordinate" in r]
        jsteps = [r["coordinate"] for r in jres.tracker if r.get("iteration") == 1
                  and "coordinate" in r]
        assert steps == jsteps and "fixed" not in steps


def test_injected_nan_halts_one_coordinate_like_jax():
    # occurrence 5 = sweep 1, coordinate 'user' (3 coordinates per sweep);
    # the NaN scores of 'user' reach 'item' through the total in both
    # packages, so both are halted, 'fixed' keeps training
    jres, tres = _fit_pair(_arrays(seed=1), "halt_coordinate", plan="descent.coordinate@5=nan")
    _assert_same_health(jres, tres)
    rows = _health_rows(tres)
    assert rows[0]["user"]["finite"] and not rows[1]["user"]["finite"]
    assert rows[1]["fixed"]["finite"]
    got = _model_arrays(tres.model, lambda m: m.coefficients.means)
    want = _model_arrays(jres.model, lambda m: m.model.coefficients.means)
    assert got.keys() == want.keys()
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=TOL, atol=TOL, err_msg=key)
    assert not any(np.any(got[k]) for k in got if k.startswith("user/"))


def test_env_override_and_validation(monkeypatch, c1_data):
    assert resolve_policy(None) == "raise"
    assert resolve_policy("warn") == "warn"
    with pytest.raises(ValueError, match="on_divergence"):
        resolve_policy("ignore")
    monkeypatch.setenv("PHOTON_ON_DIVERGENCE", "halt_coordinate")
    assert resolve_policy(None) == "halt_coordinate"
    assert resolve_policy("raise") == "raise"  # the argument wins
    kw = dict(task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
              update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64, device="cpu")
    assert TEstimator(**kw).on_divergence == "halt_coordinate"
    monkeypatch.setenv("PHOTON_ON_DIVERGENCE", "warn")
    res = TEstimator(**kw).fit(_game_data(tdata, c1_data))[0]  # no raise
    assert not np.all(np.isfinite(res.model["fixed"].coefficients.means))
    monkeypatch.setenv("PHOTON_ON_DIVERGENCE", "bogus")
    with pytest.raises(ValueError, match="on_divergence"):
        TEstimator(**kw)
    assert DIVERGENCE_POLICIES == ("raise", "warn", "halt_coordinate")


def test_health_rides_the_one_host_copy_per_sweep(monkeypatch):
    """The triples of all coordinates come home in one stacked copy per
    sweep, and sweep_health matches its definition."""
    td = _game_data(tdata, _arrays(seed=2))
    est = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
        update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64, device="cpu",
    )
    coords = est._build_coordinates(td)
    copies = []
    real_stack = torch.stack

    def counting_stack(tensors, *a, **kw):
        out = real_stack(tensors, *a, **kw)
        if len(tensors) == 3 * len(UPDATE):
            copies.append(out)
        return out

    monkeypatch.setattr(torch, "stack", counting_stack)
    cd = run_coordinate_descent(coords, UPDATE, 2)
    monkeypatch.setattr(torch, "stack", real_stack)
    assert len(copies) == 2
    info = [r["info"] for r in cd.tracker if r.get("coordinate") == "user"][-1]
    h = sweep_health(cd.states["user"], info)
    grads = torch.cat([r.gradient.reshape(-1) for r in info]).to(torch.float32)
    assert float(h["gnorm"]) == pytest.approx(float(torch.linalg.vector_norm(grads)), rel=1e-6)
    assert float(h["loss"]) == pytest.approx(sum(float(r.value.sum()) for r in info), rel=1e-6)
    assert bool(h["finite"])
    assert cd.tracker[-1]["health"]["user"]["loss"] == float(h["loss"])
