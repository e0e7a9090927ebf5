"""Port parity: the GLM objective against photon_tpu/ops/objective.py.

Value, gradient, the directional oracle's φ/φ′/accept and diag(H) on
dense, sparse and sparse + windows batches, with and without
normalization, at float64 (rtol 1e-10).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import losses as jl
from photon_tpu.ops.normalization import NormalizationContext as JNorm
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.ops.sparse_windows import build_column_windows as jbuild
from photon_tpu.types import LabeledBatch as JDense
from photon_tpu.types import SparseBatch as JSparse
from photon_tpu_torch.ops import losses as tl
from photon_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_tpu_torch.ops.sparse_windows import build_column_windows as tbuild
from photon_tpu_torch.types import LabeledBatch as TDense
from photon_tpu_torch.types import SparseBatch as TSparse

RTOL = 1e-10
N, D, K = 240, 48, 6


def _data(layout, seed=0):
    rng = np.random.default_rng(seed)
    y = (rng.uniform(size=N) > 0.5).astype(np.float64)
    off = 0.1 * rng.standard_normal(N)
    w = rng.uniform(0.5, 2.0, size=N)
    if layout == "dense":
        x = rng.standard_normal((N, D))
        x[:, 0] = 1.0
        jb = JDense(*(jnp.asarray(a) for a in (x, y, off, w)))
        tb = TDense(*(torch.as_tensor(a) for a in (x, y, off, w)))
        return jb, tb
    idx = rng.integers(1, D, size=(N, K)).astype(np.int32)
    idx[:, 0] = 0
    val = rng.standard_normal((N, K)) / np.sqrt(K)
    val[:, 0] = 1.0
    val[rng.uniform(size=(N, K)) < 0.15] = 0.0
    val[:, 0] = 1.0
    jw = tw = None
    if layout == "windows":
        kw = dict(window=16, instance_cap=64, chunk=16)
        jw = jbuild(idx, val, D, **kw)
        tw = tbuild(idx, val, D, dtype=torch.float64, **kw)
    jb = JSparse(jnp.asarray(idx), jnp.asarray(val), *(jnp.asarray(a) for a in (y, off, w)), jw)
    tb = TSparse(
        torch.as_tensor(idx).long(), torch.as_tensor(val),
        *(torch.as_tensor(a) for a in (y, off, w)), tw,
    )
    return jb, tb


def _norm(normalized, seed=1):
    if not normalized:
        return JNorm(), TNorm()
    rng = np.random.default_rng(seed)
    shifts = 0.2 * rng.standard_normal(D)
    factors = 1.0 + 0.3 * rng.uniform(size=D)
    shifts[0], factors[0] = 0.0, 1.0
    return (
        JNorm(factors=jnp.asarray(factors), shifts=jnp.asarray(shifts), intercept_index=0),
        TNorm(factors=torch.as_tensor(factors), shifts=torch.as_tensor(shifts), intercept_index=0),
    )


def _objectives(loss, normalized):
    jn, tn = _norm(normalized)
    return (
        JObjective(loss=getattr(jl, loss), l2_weight=0.7, normalization=jn),
        TObjective(loss=getattr(tl, loss), l2_weight=0.7, normalization=tn),
    )


def _coef(seed=2):
    return 0.3 * np.random.default_rng(seed).standard_normal(D)


LAYOUTS = ["dense", "sparse", "windows"]
LOSSES = ["LogisticLoss", "PoissonLoss"]


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL, atol=1e-12)


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("loss", LOSSES)
def test_value_and_gradient(loss, layout, normalized):
    jb, tb = _data(layout)
    jo, to = _objectives(loss, normalized)
    c = _coef()
    jf, jg = jo.value_and_gradient(jnp.asarray(c), jb)
    tf, tg = to.value_and_gradient(torch.as_tensor(c), tb)
    _close(tf, jf)
    _close(tg, jg)
    _close(to.margins(torch.as_tensor(c), tb), jo.margins(jnp.asarray(c), jb))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_directional_oracle(layout, normalized):
    jb, tb = _data(layout)
    jo, to = _objectives("LogisticLoss", normalized)
    x, d = _coef(2), _coef(3)
    j_or, t_or = jo.directional_oracle(jb), to.directional_oracle(tb)
    jf, jg, jz = j_or.full(jnp.asarray(x))
    tf, tg, tz = t_or.full(torch.as_tensor(x))
    _close(tf, jf)
    _close(tg, jg)
    _close(tz, jz)
    jphi, jacc = j_or.dir_setup(jz, jnp.asarray(x), jnp.asarray(d))
    tphi, tacc = t_or.dir_setup(tz, torch.as_tensor(x), torch.as_tensor(d))
    for alpha in (0.0, 0.37, 1.0, 2.5):
        a_t = torch.tensor(alpha, dtype=torch.float64)
        jv, jdv, _ = jphi(jnp.asarray(alpha))
        tv, tdv, _ = tphi(a_t)
        _close(tv, jv)
        _close(tdv, jdv)
        jg2, jz2 = jacc(jnp.asarray(alpha))
        tg2, tz2 = tacc(a_t)
        _close(tg2, jg2)
        _close(tz2, jz2)
    # φ(α) is the objective at x + αd
    tv, _, _ = tphi(torch.tensor(0.37, dtype=torch.float64))
    _close(tv, to.value(torch.as_tensor(x + 0.37 * d), tb))


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_hessian_diagonal(layout, normalized):
    jb, tb = _data(layout)
    jo, to = _objectives("LogisticLoss", normalized)
    c = _coef()
    _close(to.hessian_diagonal(torch.as_tensor(c), tb), jo.hessian_diagonal(jnp.asarray(c), jb))


def test_lane_batched_dense_objective_matches_per_lane():
    """A dense batch [E, N, D] with coefficients [E, D] is E objectives."""
    rng = np.random.default_rng(4)
    e, n, d = 3, 50, 7
    x = rng.standard_normal((e, n, d))
    y = (rng.uniform(size=(e, n)) > 0.5).astype(np.float64)
    off = rng.standard_normal((e, n)) * 0.1
    w = rng.uniform(0.5, 1.5, size=(e, n))
    c = rng.standard_normal((e, d)) * 0.2
    to = TObjective(loss=tl.LogisticLoss, l2_weight=0.3)
    jo = JObjective(loss=jl.LogisticLoss, l2_weight=0.3)
    tb = TDense(*(torch.as_tensor(a) for a in (x, y, off, w)))
    tf, tg = to.value_and_gradient(torch.as_tensor(c), tb)
    for i in range(e):
        jf, jg = jo.value_and_gradient(
            jnp.asarray(c[i]), JDense(*(jnp.asarray(a[i]) for a in (x, y, off, w)))
        )
        _close(tf[i], jf)
        _close(tg[i], jg)
