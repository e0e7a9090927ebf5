"""Port parity of the matrix-factorization coordinate against the JAX
package (mirrors tests/test_mf.py): the joint factor objective's value and
gradient against ``jax.value_and_grad`` of the same body (rtol 1e-12), a
fixed-effect + MF fit (factors and fixed effect at rtol 1e-7, equal L-BFGS
counters), cold scoring of unseen entities, a warm start from a prior
model, and the config refusals. Float64 on the CPU throughout.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.ops.losses import loss_for_task as jloss_for_task
from photon_tpu.optimize import problem as jprob
from photon_tpu.optimize.common import OptimizerConfig as JOptConfig
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.coordinate import MatrixFactorizationCoordinate
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.optimize.common import OptimizerConfig as TOptConfig
from photon_tpu_torch.types import OptimizerType as TOpt
from photon_tpu_torch.types import TaskType as TTask
from test_torch_game import _numpy_model

K_TRUE = 3
PKG = {
    "jax": (jcfg, jdata, jprob, JOptConfig, JTask, JEstimator, {"dtype": jnp.float64}),
    "torch": (tcfg, tdata, tprob, TOptConfig, TTask, TEstimator,
              {"dtype": torch.float64, "device": "cpu"}),
}


def mf_arrays(seed=0, n=800, users=15, items=10, d_fixed=5, noise=0.05):
    rng = np.random.default_rng(seed)
    u_true = rng.normal(size=(users, K_TRUE)) / np.sqrt(K_TRUE)
    v_true = rng.normal(size=(items, K_TRUE)) / np.sqrt(K_TRUE)
    uid = rng.integers(0, users, size=n)
    iid = rng.integers(0, items, size=n)
    x = rng.normal(size=(n, d_fixed))
    y = x @ rng.normal(size=d_fixed) + np.einsum("nk,nk->n", u_true[uid], v_true[iid])
    y = y + rng.normal(scale=noise, size=n)
    ids = {"userId": [f"u{i}" for i in uid], "itemId": [f"m{i}" for i in iid]}
    return y, x, ids


def mf_data(side, arrays):
    y, x, ids = arrays
    data = PKG[side][1]
    return data.GameData.build(
        labels=y, feature_shards={"global": data.CSRMatrix.from_dense(x)}, id_tags=ids
    )


def mf_configs(side, num_factors=4, mf_l2=0.3, iters=40):
    cfg, _, prob, Opt, Task, _, _ = PKG[side]
    opt = prob.GLMProblemConfig(
        task=Task.LINEAR_REGRESSION,
        optimizer_config=Opt(max_iterations=iters, tolerance=1e-9),
    )
    return {
        "fixed": cfg.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=opt, regularization_weights=(0.0,)
        ),
        "mf": cfg.MatrixFactorizationCoordinateConfig(
            row_entity_type="userId", col_entity_type="itemId", optimization=opt,
            num_factors=num_factors, regularization_weights=(mf_l2,),
        ),
    }


def mf_fit(side, data, iters=2, **fit_kw):
    *_, Task, Est, kw = PKG[side]
    return Est(
        task=Task.LINEAR_REGRESSION, coordinate_configs=mf_configs(side),
        update_sequence=["fixed", "mf"], descent_iterations=iters, seed=1, **kw,
    ).fit(data, **fit_kw)[0]


@pytest.fixture(scope="module")
def fits():
    arrays = mf_arrays()
    jd, td = mf_data("jax", arrays), mf_data("torch", arrays)
    return jd, td, mf_fit("jax", jd), mf_fit("torch", td)


@pytest.mark.parametrize("task", ["LINEAR_REGRESSION", "LOGISTIC_REGRESSION"])
def test_mf_value_and_gradient_match_jax(task):
    """The port's autograd value and gradient equal jax.value_and_grad of
    the JAX coordinate's objective body at float64."""
    arrays = mf_arrays(seed=2)
    td = mf_data("torch", arrays)
    if task == "LOGISTIC_REGRESSION":
        td.labels[:] = (td.labels > 0).astype(np.float64)
    cfg = dataclasses.replace(
        mf_configs("torch")["mf"],
        optimization=tprob.GLMProblemConfig(task=TTask[task]),
    )
    coord = MatrixFactorizationCoordinate.build(
        td, cfg, dtype=torch.float64, device=torch.device("cpu"), seed=4
    )
    u0, v0 = coord.initial_state()
    rng = np.random.default_rng(3)
    residual = rng.normal(size=td.num_samples)
    x = np.concatenate([u0.numpy().ravel(), v0.numpy().ravel()]) + 0.3 * rng.normal(
        size=u0.numel() + v0.numel()
    )
    f, g = coord.value_and_grad_fn(
        torch.as_tensor(residual), (tuple(u0.shape), tuple(v0.shape))
    )(torch.as_tensor(x))

    loss = jloss_for_task(JTask[task])
    r, k = u0.shape
    row_idx, col_idx = coord.row_idx.numpy(), coord.col_idx.numpy()
    offsets = td.offsets + residual

    def value(xj):
        u = xj[: r * k].reshape(r, k)
        v = xj[r * k :].reshape(-1, k)
        margin = offsets + jnp.einsum("nk,nk->n", u[row_idx], v[col_idx])
        return jnp.sum(td.weights * loss.loss(margin, td.labels)) + 0.5 * 0.3 * jnp.sum(xj * xj)

    fj, gj = jax.value_and_grad(value)(jnp.asarray(x))
    np.testing.assert_allclose(float(f), float(fj), rtol=1e-12)
    np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-12, atol=1e-13)


def test_mf_fit_matches_jax(fits):
    """Factors, the fixed effect and the L-BFGS counters of every step."""
    jd, td, jres, tres = fits
    jm, tm = jres.model["mf"], tres.model["mf"]
    np.testing.assert_array_equal(tm.row_vocab, jm.row_vocab)
    np.testing.assert_array_equal(tm.col_vocab, jm.col_vocab)
    np.testing.assert_allclose(tm.row_factors, jm.row_factors, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(tm.col_factors, jm.col_factors, rtol=1e-7, atol=1e-10)
    np.testing.assert_allclose(
        tres.model["fixed"].coefficients.means,
        np.asarray(jres.model["fixed"].model.coefficients.means), rtol=1e-7, atol=1e-10,
    )
    steps = [
        (r["coordinate"], int(r["info"].iterations), int(r["info"].n_evals))
        for r in tres.tracker if "coordinate" in r
    ]
    want = [
        (r["coordinate"], int(r["info"].iterations), int(r["info"].n_evals))
        for r in jres.tracker if "coordinate" in r
    ]
    assert steps == want
    np.testing.assert_allclose(tres.model.score(td), jres.model.score(jd), rtol=1e-7, atol=1e-9)


def test_mf_coordinate_improves_over_fixed_effect(fits):
    _, td, _, tres = fits
    mse_full = float(np.mean((tres.model.score(td) - td.labels) ** 2))
    mse_fe = float(np.mean((tres.model["fixed"].score(td) - td.labels) ** 2))
    assert mse_full < mse_fe / 4


def test_mf_cold_scoring_unseen_entities_contribute_zero(fits):
    _, _, jres, tres = fits
    ids = {
        "userId": ["u0", "u-unseen", "u1", "u-unseen"],
        "itemId": ["m-unseen", "m0", "m1", "m-unseen"],
    }
    cold = {
        side: PKG[side][1].GameData.build(
            labels=np.zeros(4),
            feature_shards={"global": PKG[side][1].CSRMatrix.from_dense(np.zeros((4, 5)))},
            id_tags=ids,
        )
        for side in PKG
    }
    s = tres.model["mf"].score_cold(cold["torch"])
    assert s[0] == 0.0 and s[1] == 0.0 and s[3] == 0.0 and s[2] != 0.0
    np.testing.assert_allclose(s, jres.model["mf"].score_cold(cold["jax"]), rtol=1e-7)


def test_mf_warm_start_matches_jax(fits):
    """A one-sweep fit started from the JAX model (carried across)."""
    jd, td, jres, _ = fits
    jw = mf_fit("jax", jd, iters=1, initial_model=jres.model)
    tw = mf_fit("torch", td, iters=1, initial_model=_numpy_model(jres.model, TTask.LINEAR_REGRESSION))
    np.testing.assert_allclose(
        tw.model["mf"].row_factors, jw.model["mf"].row_factors, rtol=1e-7, atol=1e-10
    )
    mse = {
        "prior": float(np.mean((jres.model.score(jd) - jd.labels) ** 2)),
        "warm": float(np.mean((tw.model.score(td) - td.labels) ** 2)),
    }
    assert mse["warm"] <= mse["prior"] * 1.05


def test_mf_required_id_tags_and_config_refusals(fits):
    _, _, _, tres = fits
    assert tcfg.required_id_tags(mf_configs("torch").values()) == {"userId", "itemId"}
    assert tres.model.required_id_tags() == {"userId", "itemId"}
    base = tprob.GLMProblemConfig(task=TTask.LINEAR_REGRESSION)
    bad = {
        "LBFGS": dataclasses.replace(base, optimizer=TOpt.TRON),
        "L2": dataclasses.replace(
            base, regularization=tprob.RegularizationContext(tprob.RegularizationType.L1)
        ),
        "down-sampling": dataclasses.replace(base, down_sampling_rate=0.5),
    }
    for match, opt in bad.items():
        with pytest.raises(ValueError, match=match):
            tcfg.MatrixFactorizationCoordinateConfig(
                row_entity_type="a", col_entity_type="b", optimization=opt
            )
    with pytest.raises(ValueError, match="num_factors"):
        tcfg.MatrixFactorizationCoordinateConfig(
            row_entity_type="a", col_entity_type="b", optimization=base, num_factors=0
        )
