"""Port parity: L-BFGS and the margin-space line search against
photon_tpu/optimize/lbfgs.py, solo and lane-batched, float64.

The cases are those of tests/test_optimizers.py and
tests/test_margin_linesearch.py; both packages must agree on iteration
count, feature passes, x and f (rtol 1e-8).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import losses as jl
from photon_tpu.ops.normalization import NormalizationContext as JNorm
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optimize import OptimizerConfig as JConfig
from photon_tpu.optimize import minimize_lbfgs as jmin
from photon_tpu.types import LabeledBatch as JDense
from photon_tpu_torch.ops import losses as tl
from photon_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_tpu_torch.optimize.common import ConvergenceReason
from photon_tpu_torch.optimize.common import OptimizerConfig as TConfig
from photon_tpu_torch.optimize.lbfgs import minimize_lbfgs as tmin
from photon_tpu_torch.types import LabeledBatch as TDense

RTOL = 1e-8
D = 8


def _same(tres, jres, *, iters=True):
    if iters:
        assert int(tres.iterations) == int(jres.iterations)
        assert int(tres.n_feature_passes) == int(jres.n_feature_passes)
        assert int(tres.n_evals) == int(jres.n_evals)
        assert int(tres.reason) == int(jres.reason)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(
        tres.loss_history.numpy(), np.asarray(jres.loss_history), rtol=RTOL, atol=1e-12
    )


def _batches(x, y, off, w):
    return (
        JDense(*(jnp.asarray(a) for a in (x, y, off, w))),
        TDense(*(torch.as_tensor(a) for a in (x, y, off, w))),
    )


def test_quadratic_blackbox():
    center = np.arange(1.0, D + 1)
    jres = jmin(lambda x: (0.5 * jnp.dot(x - center, x - center), x - center), jnp.zeros(D))
    c = torch.as_tensor(center)
    tres = tmin(lambda x: (0.5 * ((x - c) ** 2).sum(-1), x - c), torch.zeros(D, dtype=torch.float64))
    _same(tres, jres)
    assert int(tres.reason) in (
        ConvergenceReason.FUNCTION_VALUES_CONVERGED,
        ConvergenceReason.GRADIENT_CONVERGED,
    )


def _ridge(seed=0, n=200, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = x @ rng.normal(size=d) + rng.normal(scale=0.1, size=n)
    return _batches(x, y, np.zeros(n), np.ones(n))


def _logistic(seed=1, n=300, d=D):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, d))
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-x @ rng.normal(size=d)))).astype(float)
    return _batches(x, y, np.zeros(n), np.ones(n))


@pytest.mark.parametrize("oracle", [False, True])
@pytest.mark.parametrize("case", ["ridge", "logistic"])
def test_glm_solves(case, oracle):
    jb, tb = _ridge() if case == "ridge" else _logistic()
    loss, l2 = ("SquaredLoss", 0.5) if case == "ridge" else ("LogisticLoss", 1.0)
    jo = JObjective(loss=getattr(jl, loss), l2_weight=l2)
    to = TObjective(loss=getattr(tl, loss), l2_weight=l2)
    jc, tc = JConfig(tolerance=1e-13), TConfig(tolerance=1e-13)
    z = np.zeros(D)
    if oracle:
        jres = jmin(None, jnp.asarray(z), jc, oracle=jo.directional_oracle(jb))
        tres = tmin(None, torch.as_tensor(z), tc, oracle=to.directional_oracle(tb))
    else:
        jres = jmin(lambda w: jo.value_and_gradient(w, jb), jnp.asarray(z), jc)
        tres = tmin(lambda w: to.value_and_gradient(w, tb), torch.as_tensor(z), tc)
    _same(tres, jres)


@pytest.mark.parametrize("poisson", [False, True])
@pytest.mark.parametrize("normalized", [False, True])
def test_oracle_matches_jax(poisson, normalized):
    """tests/test_margin_linesearch.py::test_oracle_matches_blackbox inputs."""
    rng = np.random.default_rng(0)
    n, d = 400, 24
    x = rng.standard_normal((n, d))
    x[:, 0] = 1.0
    z = x @ (rng.standard_normal(d) * 0.4)
    if poisson:
        y = rng.poisson(np.exp(np.clip(z - 1.0, -4, 3))).astype(float)
    else:
        y = (rng.uniform(size=n) < 1 / (1 + np.exp(-z))).astype(float)
    jb, tb = _batches(x, y, 0.1 * rng.standard_normal(n), rng.uniform(0.5, 2.0, size=n))
    jn, tn = JNorm(), TNorm()
    if normalized:
        shifts = 0.2 * rng.standard_normal(d)
        factors = 1.0 + 0.2 * rng.uniform(size=d)
        shifts[0], factors[0] = 0.0, 1.0
        jn = JNorm(factors=jnp.asarray(factors), shifts=jnp.asarray(shifts), intercept_index=0)
        tn = TNorm(factors=torch.as_tensor(factors), shifts=torch.as_tensor(shifts), intercept_index=0)
    loss = "PoissonLoss" if poisson else "LogisticLoss"
    jo = JObjective(loss=getattr(jl, loss), l2_weight=0.7, normalization=jn)
    to = TObjective(loss=getattr(tl, loss), l2_weight=0.7, normalization=tn)
    jres = jmin(None, jnp.zeros(d), JConfig(max_iterations=60, tolerance=1e-8),
                oracle=jo.directional_oracle(jb))
    tres = tmin(None, torch.zeros(d, dtype=torch.float64),
                TConfig(max_iterations=60, tolerance=1e-8), oracle=to.directional_oracle(tb))
    _same(tres, jres)
    # two feature passes per iteration + init + the final re-evaluation
    assert int(tres.n_feature_passes) == 4 + 2 * int(tres.iterations) + 2


def test_sparse_windows_oracle_matches_jax(monkeypatch):
    """tests/test_margin_linesearch.py::test_oracle_sparse_batch_with_windows."""
    from photon_tpu.ops.sparse_windows import build_column_windows as jbuild
    from photon_tpu.types import SparseBatch as JSparse
    from photon_tpu_torch.ops.sparse_windows import build_column_windows as tbuild
    from photon_tpu_torch.types import SparseBatch as TSparse

    monkeypatch.setenv("PHOTON_SPARSE_RMATVEC", "onehot")
    rng = np.random.default_rng(3)
    n, k, d = 300, 5, 256
    idx = rng.integers(1, d, size=(n, k)).astype(np.int32)
    idx[:, 0] = 0
    val = rng.standard_normal((n, k)) / np.sqrt(k)
    val[:, 0] = 1.0
    y = (rng.uniform(size=n) > 0.5).astype(float)
    cols = (y, np.zeros(n), np.ones(n))
    jb = JSparse(jnp.asarray(idx), jnp.asarray(val), *map(jnp.asarray, cols),
                 jbuild(idx, val, d, window=64))
    tb = TSparse(torch.as_tensor(idx).long(), torch.as_tensor(val),
                 *map(torch.as_tensor, cols), tbuild(idx, val, d, window=64, dtype=torch.float64))
    jo = JObjective(loss=jl.LogisticLoss, l2_weight=0.5)
    to = TObjective(loss=tl.LogisticLoss, l2_weight=0.5)
    jres = jmin(None, jnp.zeros(d), JConfig(max_iterations=40), oracle=jo.directional_oracle(jb))
    tres = tmin(None, torch.zeros(d, dtype=torch.float64), TConfig(max_iterations=40),
                oracle=to.directional_oracle(tb))
    _same(tres, jres)


def _lanes(e=5, n=60, d=6, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((e, n, d))
    # lanes separable to different degrees converge after different counts
    x *= np.linspace(0.3, 3.0, e)[:, None, None]
    y = (rng.uniform(size=(e, n)) > 0.5).astype(float)
    return x, y, np.zeros((e, n)), np.ones((e, n))


def test_batched_lanes_match_jax_vmap():
    """tests/test_margin_linesearch.py::test_oracle_under_vmap: the lane
    axis written out equals JAX's vmap over the while-loop."""
    x, y, off, w = _lanes()
    e, _, d = x.shape
    jo = JObjective(loss=jl.LogisticLoss, l2_weight=1.0)
    to = TObjective(loss=tl.LogisticLoss, l2_weight=1.0)

    def solve(f, l, o, wt):
        return jmin(None, jnp.zeros(d), JConfig(max_iterations=25),
                    oracle=jo.directional_oracle(JDense(f, l, o, wt)))

    jres = jax.vmap(solve)(*(jnp.asarray(a) for a in (x, y, off, w)))
    tb = TDense(*(torch.as_tensor(a) for a in (x, y, off, w)))
    tres = tmin(None, torch.zeros((e, d), dtype=torch.float64), TConfig(max_iterations=25),
                oracle=to.directional_oracle(tb))
    np.testing.assert_array_equal(tres.iterations.numpy(), np.asarray(jres.iterations))
    np.testing.assert_array_equal(
        tres.n_feature_passes.numpy(), np.asarray(jres.n_feature_passes)
    )
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=RTOL, atol=1e-12)
    np.testing.assert_allclose(tres.value.numpy(), np.asarray(jres.value), rtol=RTOL)


def test_batched_lanes_equal_solo_solves():
    """Five lanes that converge at different iterations equal five solo
    solves lane by lane: a converged lane keeps its state."""
    x, y, off, w = _lanes()
    e, _, d = x.shape
    to = TObjective(loss=tl.LogisticLoss, l2_weight=1.0)
    cfg = TConfig(max_iterations=50, tolerance=1e-10)
    tb = TDense(*(torch.as_tensor(a) for a in (x, y, off, w)))
    batched = tmin(None, torch.zeros((e, d), dtype=torch.float64), cfg,
                   oracle=to.directional_oracle(tb))
    assert len(set(batched.iterations.tolist())) > 1
    for i in range(e):
        solo_b = TDense(*(torch.as_tensor(a[i]) for a in (x, y, off, w)))
        solo = tmin(None, torch.zeros(d, dtype=torch.float64), cfg,
                    oracle=to.directional_oracle(solo_b))
        assert int(solo.iterations) == int(batched.iterations[i])
        assert int(solo.n_feature_passes) == int(batched.n_feature_passes[i])
        assert int(solo.n_evals) == int(batched.n_evals[i])
        np.testing.assert_allclose(batched.x[i].numpy(), solo.x.numpy(), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(batched.value[i]), float(solo.value), rtol=1e-12)
