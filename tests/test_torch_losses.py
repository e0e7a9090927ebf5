"""Port parity: pointwise losses and both margin derivatives against the JAX
package (photon_tpu/ops/losses.py), on margins out to ±1e3, float64."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import losses as jl
from photon_tpu_torch.ops import losses as tl

#: XLA flushes subnormal results to zero and torch keeps them: values below
#: the smallest normal float64 compare as equal to zero
TINY = np.finfo(np.float64).tiny

NAMES = ["LogisticLoss", "SquaredLoss", "PoissonLoss", "SmoothedHingeLoss"]


def _inputs(name):
    rng = np.random.default_rng(0)
    z = np.concatenate([
        rng.uniform(-1e3, 1e3, 200),
        rng.standard_normal(200) * 3.0,
        [-1e3, -100.0, -1.0, 0.0, 0.5, 1.0, 100.0, 1e3],
    ])
    if name == "PoissonLoss":
        y = rng.integers(0, 6, size=z.shape).astype(np.float64)
    else:
        y = rng.integers(0, 2, size=z.shape).astype(np.float64)
    return z, y


@pytest.mark.parametrize("fn", ["loss", "d1", "d2"])
@pytest.mark.parametrize("name", NAMES)
def test_loss_functions_match_jax(name, fn):
    z, y = _inputs(name)
    want = np.asarray(getattr(getattr(jl, name), fn)(jnp.asarray(z), jnp.asarray(y)))
    got = getattr(getattr(tl, name), fn)(torch.as_tensor(z), torch.as_tensor(y)).numpy()
    if name != "PoissonLoss":  # exp(1e3) overflows to inf in both packages
        assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=TINY)


@pytest.mark.parametrize("name", NAMES)
def test_loss_and_d1_match_jax(name):
    z, y = _inputs(name)
    jv, jd = getattr(jl, name).loss_and_d1(jnp.asarray(z), jnp.asarray(y))
    tv, td = getattr(tl, name).loss_and_d1(torch.as_tensor(z), torch.as_tensor(y))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-12, atol=TINY)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-12, atol=TINY)


@pytest.mark.parametrize("label", [-1.0, 0.0, 1.0])
def test_label_threshold_and_sign_conventions(label):
    """{-1, 1} and {0, 1} labels: positive means y > 0.5 in both packages."""
    z = np.linspace(-5, 5, 21)
    y = np.full_like(z, label)
    for name in ("LogisticLoss", "SmoothedHingeLoss"):
        want = np.asarray(getattr(jl, name).d1(jnp.asarray(z), jnp.asarray(y)))
        got = getattr(tl, name).d1(torch.as_tensor(z), torch.as_tensor(y)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=TINY)


def test_sigmoid_and_log1p_exp_tails():
    z = np.array([-1e3, -50.0, -1e-8, 0.0, 1e-8, 50.0, 1e3])
    np.testing.assert_allclose(
        tl.sigmoid(torch.as_tensor(z)).numpy(),
        np.asarray(jl.sigmoid(jnp.asarray(z))),
        rtol=1e-12,
    )
    np.testing.assert_allclose(
        tl.log1p_exp(torch.as_tensor(z)).numpy(),
        np.asarray(jl.log1p_exp(jnp.asarray(z))),
        rtol=1e-12,
    )


def test_loss_for_task_dispatch():
    from photon_tpu.types import TaskType as JT
    from photon_tpu_torch.types import TaskType as TT

    for t in TT:
        assert tl.loss_for_task(t).name == jl.loss_for_task(JT[t.name]).name
