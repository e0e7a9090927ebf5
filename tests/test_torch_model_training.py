"""Port parity: the single-GLM training path against photon_tpu.

``train_glm_grid(device="cpu")`` walks a 3-λ grid with warm starts on the
same DataSet as the JAX ``train_glm_grid``, dense and sparse (the port's
sparse batch through the window layout), with STANDARDIZATION from
``BasicStatisticalSummary`` and SIMPLE variances, for LBFGS, TRON and
OWLQN: original-space means and variances at rtol 1e-7. Models carried
across by ``glm_from_numpy`` predict, and the evaluators score, at rtol
1e-9. The verify recipe (LIBSVM → validate → statistics → normalization
→ grid → predict → AUC) runs on the port alone.
"""
from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data import dataset as jds
from photon_tpu.data.stats import BasicStatisticalSummary as JStats
from photon_tpu.evaluation import evaluators as jev
from photon_tpu.model_training import train_glm_grid as jtrain
from photon_tpu.ops.normalization import NormalizationContext as JNorm
from photon_tpu.optimize import problem as jp
from photon_tpu.types import NormalizationType as JNormType
from photon_tpu.types import OptimizerType as JOpt
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.convert import glm_from_numpy
from photon_tpu_torch.data import dataset as tds
from photon_tpu_torch.data.libsvm import read_libsvm
from photon_tpu_torch.data.stats import BasicStatisticalSummary as TStats
from photon_tpu_torch.data.validators import validate
from photon_tpu_torch.evaluation import evaluators as tev
from photon_tpu_torch.model_training import train_glm_grid as ttrain
from photon_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_tpu_torch.optimize import problem as tp
from photon_tpu_torch.types import NormalizationType as TNormType
from photon_tpu_torch.types import OptimizerType as TOpt
from photon_tpu_torch.types import TaskType as TTask

N, D = 500, 40  # D includes the intercept, the last column
GRID = [10.0, 1.0, 0.1]
RTOL = 1e-7


def _x(seed=0, n=N):
    """a1a-shaped rows: ~8 active binary features and a constant intercept."""
    rng = np.random.default_rng(seed)
    x = (rng.uniform(size=(n, D)) < 8.0 / D).astype(np.float64)
    x[:, -1] = 1.0
    return x, rng


def _dataset(seed=0):
    x, rng = _x(seed)
    z = x @ (0.8 * rng.standard_normal(D))
    y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    return x, y


def _configs(opt, variance="SIMPLE", **kw):
    reg = "ELASTIC_NET" if opt == "OWLQN" else "L2"
    return [
        mod.GLMProblemConfig(
            task=Task.LOGISTIC_REGRESSION,
            optimizer=Opt[opt],
            regularization=mod.RegularizationContext(mod.RegularizationType[reg]),
            variance_computation=mod.VarianceComputationType[variance],
            **kw,
        )
        for mod, Task, Opt in ((jp, JTask, JOpt), (tp, TTask, TOpt))
    ]


def _normalizations(jd, td):
    js, ts = JStats.of(jd), TStats.of(td)
    np.testing.assert_array_equal(ts.variance, js.variance)
    jn = JNorm.build(
        JNormType.STANDARDIZATION, mean=js.mean, variance=js.variance,
        intercept_index=D - 1, dtype=jnp.float64,
    )
    tn = TNorm.build(
        TNormType.STANDARDIZATION, mean=ts.mean, variance=ts.variance,
        intercept_index=D - 1, dtype=torch.float64,
    )
    return jn, tn


def _fit(opt, layout, **kw):
    x, y = _dataset()
    jd, td = jds.DataSet.from_dense(x, y), tds.DataSet.from_dense(x, y)
    jn, tn = _normalizations(jd, td)
    jcfg, tcfg = _configs(opt, **kw)
    if layout == "dense":
        jdata, tdata, extra = jd, td, {}
    else:
        jdata = jds.to_device_sparse_batch(jd, dtype=jnp.float64)
        tdata = tds.to_device_sparse_batch(
            td, dtype=torch.float64, device="cpu", column_windows=True
        )
        assert tdata.windows is not None and jdata.windows is None
        extra = {"num_features": D}
    jres = jtrain(jdata, jcfg, GRID, normalization=jn, dtype=jnp.float64, **extra)
    tres = ttrain(
        tdata, tcfg, GRID, normalization=tn, dtype=torch.float64, device="cpu", **extra
    )
    return jres, tres, x, y


@pytest.mark.parametrize("layout", ["dense", "sparse-windows"])
@pytest.mark.parametrize("opt", ["LBFGS", "TRON", "OWLQN"])
def test_train_glm_grid_matches_jax(opt, layout):
    jres, tres, _, _ = _fit(opt, layout)
    assert [r.regularization_weight for r in tres] == GRID
    for j, t in zip(jres, tres):
        for name in ("iterations", "reason", "n_evals", "n_hvp", "n_feature_passes"):
            assert int(getattr(t.result, name)) == int(getattr(j.result, name)), name
        assert int(t.result.reason) in (2, 3)
        np.testing.assert_allclose(
            t.model.coefficients.means.numpy(), np.asarray(j.model.coefficients.means),
            rtol=RTOL, atol=1e-12,
        )
        np.testing.assert_allclose(
            t.model.coefficients.variances.numpy(), np.asarray(j.model.coefficients.variances),
            rtol=RTOL,
        )
        assert type(t.model).__name__ == type(j.model).__name__ == "LogisticRegressionModel"
    if opt == "OWLQN":
        assert (tres[0].model.coefficients.means.numpy() == 0).any()


def test_train_glm_grid_down_sampled_matches_jax():
    jres, tres, _, _ = _fit("LBFGS", "dense", down_sampling_rate=0.5)
    for j, t in zip(jres, tres):
        np.testing.assert_allclose(
            t.model.coefficients.means.numpy(), np.asarray(j.model.coefficients.means),
            rtol=RTOL, atol=1e-12,
        )


def test_predict_and_evaluators_match_jax():
    """One set of coefficients (a JAX fit's) scored by both packages."""
    jres, _, x, y = _fit("LBFGS", "dense")
    jm = jres[1].model
    tm = glm_from_numpy(
        TTask.LOGISTIC_REGRESSION, np.asarray(jm.coefficients.means),
        np.asarray(jm.coefficients.variances), device="cpu",
    )
    xt, _ = _x(seed=11, n=300)
    offsets = 0.1 * np.random.default_rng(12).standard_normal(300)
    np.testing.assert_allclose(
        tm.predict(torch.as_tensor(xt), torch.as_tensor(offsets)).numpy(),
        np.asarray(jm.predict(jnp.asarray(xt), jnp.asarray(offsets))), rtol=1e-9,
    )
    np.testing.assert_array_equal(
        tm.predict_class(torch.as_tensor(xt)).numpy(), np.asarray(jm.predict_class(jnp.asarray(xt)))
    )
    margins = x @ np.asarray(jm.coefficients.means)
    margins[:5] = margins[5]  # ties
    weights = np.ones(N)
    weights[-7:] = 0.0  # padding rows
    for ev in jev.EvaluatorType:
        for w in (None, weights):
            want = jev.evaluate(ev, jnp.asarray(margins), jnp.asarray(y), None if w is None else jnp.asarray(w))
            got = tev.evaluate(
                tev.EvaluatorType[ev.name], torch.as_tensor(margins), torch.as_tensor(y),
                None if w is None else torch.as_tensor(w),
            )
            np.testing.assert_allclose(float(got), float(want), rtol=1e-9, err_msg=ev.name)


@pytest.mark.parametrize("task", list(TTask))
def test_models_for_every_task_match_jax(task):
    from photon_tpu.models.coefficients import Coefficients as JCoef
    from photon_tpu.models.glm import model_for_task as jmodel

    rng = np.random.default_rng(13)
    w, xt = 0.3 * rng.standard_normal(6), rng.standard_normal((20, 6))
    jm = jmodel(JTask[task.name], JCoef(means=jnp.asarray(w)))
    tm = glm_from_numpy(task, w, device="cpu")
    assert type(tm).__name__ == type(jm).__name__
    np.testing.assert_allclose(
        tm.predict(torch.as_tensor(xt)).numpy(), np.asarray(jm.predict(jnp.asarray(xt))), rtol=1e-12
    )


def test_train_glm_grid_defaults_to_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    x, y = _dataset()
    _, tcfg = _configs("LBFGS")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain(tds.DataSet.from_dense(x, y), tcfg, GRID)
    batch = tds.to_device_batch(tds.DataSet.from_dense(x, y), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ttrain(batch, tcfg, GRID)


def test_verify_recipe_on_the_port(tmp_path):
    """read_libsvm → validate → BasicStatisticalSummary →
    NormalizationContext.build → train_glm_grid(device="cpu") → predict →
    AUC, on the port alone."""
    x, y = _dataset(seed=3)
    lines = []
    for row, label in zip(x[:, :-1], y):
        feats = " ".join(f"{j + 1}:{v:g}" for j, v in enumerate(row) if v != 0)
        lines.append(f"{'+1' if label > 0.5 else '-1'} {feats}")
    path = tmp_path / "train.libsvm"
    path.write_text("\n".join(lines) + "\n")
    data = read_libsvm(str(path), num_features=D - 1)
    assert data.num_features == D
    validate(data, TTask.LOGISTIC_REGRESSION)
    stats = TStats.of(data)
    norm = TNorm.build(
        TNormType.STANDARDIZATION, mean=stats.mean, variance=stats.variance,
        intercept_index=D - 1, dtype=torch.float64,
    )
    _, cfg = _configs("LBFGS")
    models = ttrain(data, cfg, GRID, normalization=norm, dtype=torch.float64, device="cpu")
    assert all(int(m.result.reason) in (2, 3) for m in models)
    scores = models[-1].model.predict(torch.as_tensor(data.to_dense(np.float64)))
    auc = float(tev.area_under_roc_curve(scores, torch.as_tensor(data.labels)))
    assert auc > 0.8


def test_variances_none_leave_the_model_without_variances():
    _, tres, _, _ = _fit("TRON", "dense", variance="NONE")
    assert all(r.model.coefficients.variances is None for r in tres)
    assert dataclasses.is_dataclass(tres[0])
