"""Port parity: the hyperparameter package against the JAX package's.

The port's ``hyperparameter/*`` modules are copies of numpy/scipy code,
so on the same inputs and seeds each function gives JAX's values within
1e-12: kernels and their likelihoods, the slice sampler, the GP fit and
its predictions, the acquisition criteria, the rescaling, the Sobol
engine, random and Bayesian search, and prior (de)serialization with
the shrunk search range.
"""
from __future__ import annotations

import numpy as np
import pytest

from photon_tpu import hyperparameter as jhp
from photon_tpu.hyperparameter import evaluation as jev
from photon_tpu.hyperparameter import qmc_compat as jqmc
from photon_tpu.hyperparameter import serialization as jser
from photon_tpu_torch import hyperparameter as thp
from photon_tpu_torch.hyperparameter import evaluation as tev
from photon_tpu_torch.hyperparameter import qmc_compat as tqmc
from photon_tpu_torch.hyperparameter import serialization as tser

TOL = 1e-12


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, float), np.asarray(b, float), rtol=TOL, atol=TOL)


def _points(seed=0, n=9, d=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=(n, d))
    y = np.sin(3 * x[:, 0]) + x[:, 1] ** 2 - 0.5 * x[:, -1] + 0.01 * rng.normal(size=n)
    return x, y


def test_the_package_exports_the_same_names():
    assert sorted(thp.__all__) == sorted(jhp.__all__)


@pytest.mark.parametrize("name", ["RBF", "Matern52"])
def test_kernels_equal_jax(name):
    x, y = _points(1)
    x2, _ = _points(2, n=4)
    kw = dict(amplitude=1.7, noise=0.05, length_scale=np.array([0.3, 1.2, 2.0]))
    tk, jk = getattr(thp, name)(**kw), getattr(jhp, name)(**kw)
    _close(tk.train_covariance(x), jk.train_covariance(x))
    _close(tk.cross_covariance(x, x2), jk.cross_covariance(x, x2))
    _close(tk.log_likelihood(x, y), jk.log_likelihood(x, y))
    _close(tk.theta, jk.theta)
    _close(tk.initial_kernel(y).theta, jk.initial_kernel(y).theta)
    theta = np.array([0.8, 0.02, 0.5, 0.6, 0.7])
    _close(tk.with_theta(theta).log_likelihood(x, y), jk.with_theta(theta).log_likelihood(x, y))


def test_slice_sampler_equals_jax():
    def logp(v):
        return -0.5 * float(np.sum((v - 1.0) ** 2 / np.array([1.0, 4.0])))

    ts, js = thp.SliceSampler(seed=4), jhp.SliceSampler(seed=4)
    a = b = np.zeros(2)
    for _ in range(20):
        a, b = ts.draw(a, logp), js.draw(b, logp)
        _close(a, b)
        a, b = ts.draw_dimension_wise(a, logp), js.draw_dimension_wise(b, logp)
        _close(a, b)


@pytest.mark.parametrize("kw", [{}, dict(normalize_labels=True, noisy_target=True)])
def test_gaussian_process_equals_jax(kw):
    x, y = _points(5)
    pool, _ = _points(6, n=17)
    tm = thp.GaussianProcessEstimator(seed=3, burn_in_samples=20, num_samples=5, **kw).fit(x, y)
    jm = jhp.GaussianProcessEstimator(seed=3, burn_in_samples=20, num_samples=5, **kw).fit(x, y)
    for got, want in zip(tm.predict(pool), jm.predict(pool)):
        _close(got, want)


@pytest.mark.parametrize("maximize", [True, False])
def test_criteria_equal_jax(maximize):
    rng = np.random.default_rng(8)
    means, variances = rng.normal(size=12), rng.uniform(0.01, 2.0, size=12)
    _close(thp.expected_improvement(0.3, maximize=maximize)(means, variances),
           jhp.expected_improvement(0.3, maximize=maximize)(means, variances))
    _close(thp.confidence_bound(1.5, maximize=maximize)(means, variances),
           jhp.confidence_bound(1.5, maximize=maximize)(means, variances))


def test_rescaling_equals_jax():
    ranges_t = [(1e-4, 1e4, tev.HyperparameterScale.LOG), (0.0, 2.0, tev.HyperparameterScale.LINEAR)]
    ranges_j = [(1e-4, 1e4, jev.HyperparameterScale.LOG), (0.0, 2.0, jev.HyperparameterScale.LINEAR)]
    vals = np.array([3.0, 0.5])
    fwd = tev.rescale_forward(vals, ranges_t)
    _close(fwd, jev.rescale_forward(vals, ranges_j))
    _close(tev.rescale_backward(fwd, ranges_t), jev.rescale_backward(fwd, ranges_j))
    _close(tev.rescale_backward(fwd, ranges_t), vals)


def test_sobol_engine_equals_jax():
    _close(tqmc.sobol_engine(3, seed=11).random(16), jqmc.sobol_engine(3, seed=11).random(16))


def _objective(c):
    return float(-np.sum((np.asarray(c, float) - np.array([0.3, 0.7])) ** 2))


@pytest.mark.parametrize("search", ["RandomSearch", "GaussianProcessSearch"])
def test_search_equals_jax(search):
    """Same candidates and values, with discrete parameters and priors."""
    priors = [(np.array([0.1, 0.9]), -0.4), (np.array([0.5, 0.5]), -0.08)]
    out = {}
    for name, pkg, ev in (("port", thp, tev), ("jax", jhp, jev)):
        s = getattr(pkg, search)(2, ev.CallableEvaluationFunction(_objective), seed=5,
                                 discrete_params={1: 4})
        out[name] = s.find_with_prior_observations(4, priors)
    assert len(out["port"]) == len(out["jax"]) == 4
    for (ca, va), (cb, vb) in zip(out["port"], out["jax"]):
        _close(ca, cb)
        assert va == vb


def test_priors_json_and_shrink_range_equal_jax():
    obs = [({"global": 1.0, "user": 10.0}, 0.71), ({"global": 0.1, "user": 1.0}, 0.74),
           ({"global": 100.0, "user": 3.0}, 0.69)]
    text = tser.priors_to_json(obs)
    assert text == jser.priors_to_json(obs)
    names, defaults = ["global", "user", "item"], {"global": 1.0, "user": 1.0, "item": 5.0}
    assert tser.priors_from_json(text, names, defaults) == jser.priors_from_json(
        text, names, defaults)
    pts, vals = _points(9, n=6, d=2)
    for maximize in (True, False):
        got = tser.shrink_search_range(pts, vals, radius=0.2, maximize=maximize, seed=2,
                                       candidate_pool_size=64)
        want = jser.shrink_search_range(pts, vals, radius=0.2, maximize=maximize, seed=2,
                                        candidate_pool_size=64)
        for a, b in zip(got, want):
            _close(a, b)
