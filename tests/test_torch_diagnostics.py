"""Port parity: model diagnostics against photon_tpu/diagnostics.

The same numpy inputs go through both packages at float64:
- the host statistics (χ² survival, Hosmer–Lemeshow, Kendall τ, prediction-
  error independence, peak F1, the log-likelihood of all four tasks) and
  ``compute_metrics`` on dense and sparse batches agree within 1e-12;
- ``importance_from_batch`` (the sparse moments are a flat ``index_add_``
  here, a ``segment_sum`` in JAX) within 1e-12;
- the HTML and text renderers give identical strings for the same
  ``Document``;
- ``fitting_diagnostic`` and ``bootstrap_diagnostic`` retrain on identical
  weights (``default_rng(seed)`` in both): every retrain's coefficients
  and objective, the intervals and the metrics within 1e-6;
- ``diagnose_models`` end to end on JAX's models carried across through
  ``convert.glm_from_numpy``, and the legacy driver with ``--diagnose``:
  the whole ``report.json`` within 1e-9 relative (float64 roundoff over
  the L-BFGS retrains reads ~1e-13), the text report the same but for its
  numbers.

The retrains keep the window layout through ``_replace`` (it holds no
weights), and a sparse retrain batch that should carry one and does not
raises. The JAX side is a few module-scoped fits, since each JAX retrain
compiles.
"""
from __future__ import annotations

import functools
import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu import model_training as j_mt
from photon_tpu.data import dataset as j_dataset
from photon_tpu.diagnostics import bootstrap as j_boot
from photon_tpu.diagnostics import diagnose_models as j_diagnose
from photon_tpu.diagnostics import fitting as j_fit
from photon_tpu.diagnostics import hl as j_hl
from photon_tpu.diagnostics import importance as j_imp
from photon_tpu.diagnostics import independence as j_ind
from photon_tpu.diagnostics import metrics as j_met
from photon_tpu.diagnostics import reporting as j_rep
from photon_tpu.model_training import train_glm_grid as j_train
from photon_tpu.models.coefficients import Coefficients as JCoefficients
from photon_tpu.models.glm import model_for_task as j_model_for_task
from photon_tpu.ops.normalization import NormalizationContext as JNorm
from photon_tpu.optimize.problem import GLMProblemConfig as JConfig
from photon_tpu.optimize.problem import RegularizationContext as JReg
from photon_tpu.optimize.problem import RegularizationType as JRegType
from photon_tpu.types import NormalizationType as JNormType
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch import convert
from photon_tpu_torch.data import dataset as t_dataset
from photon_tpu_torch.diagnostics import bootstrap as t_boot
from photon_tpu_torch.diagnostics import diagnose_models as t_diagnose
from photon_tpu_torch.diagnostics import fitting as t_fit
from photon_tpu_torch.diagnostics import hl as t_hl
from photon_tpu_torch.diagnostics import importance as t_imp
from photon_tpu_torch.diagnostics import independence as t_ind
from photon_tpu_torch.diagnostics import metrics as t_met
from photon_tpu_torch.diagnostics import reporting as t_rep
from photon_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_tpu_torch.optimize.problem import GLMProblemConfig as TConfig
from photon_tpu_torch.optimize.problem import RegularizationContext as TReg
from photon_tpu_torch.optimize.problem import RegularizationType as TRegType
from photon_tpu_torch.types import NormalizationType as TNormType
from photon_tpu_torch.types import TaskType as TTask

TASKS = ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION", "POISSON_REGRESSION",
         "SMOOTHED_HINGE_LOSS_LINEAR_SVM"]
RETRAIN_TOL = 1e-6  # L-BFGS retrains at float64: roundoff reads ~1e-13


def _labels(task, margin, rng):
    if task == "LINEAR_REGRESSION":
        return margin + 0.3 * rng.standard_normal(margin.shape[0])
    if task == "POISSON_REGRESSION":
        return rng.poisson(np.exp(np.clip(margin, -3.0, 2.0))).astype(np.float64)
    return (rng.uniform(size=margin.shape[0]) < 1.0 / (1.0 + np.exp(-margin))).astype(np.float64)


def _datasets(task="LOGISTIC_REGRESSION", n=300, d=6, seed=0, sparse=False):
    """The same rows as a JAX and a port DataSet (weights and offsets
    varied; ``sparse`` zeroes ~60% of the entries)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d))
    if sparse:
        x[rng.uniform(size=(n, d)) < 0.6] = 0.0
    x[:, -1] = 1.0
    w = 0.7 * rng.standard_normal(d)
    y = _labels(task, 0.5 * (x @ w), rng)
    offsets = 0.1 * rng.standard_normal(n)
    weights = rng.uniform(0.5, 2.0, size=n)
    return tuple(
        mod.DataSet.from_dense(x, y, offsets=offsets, weights=weights)
        for mod in (j_dataset, t_dataset)
    )


def _batches(task="LOGISTIC_REGRESSION", sparse=False, **kw):
    jds, tds = _datasets(task, sparse=sparse, **kw)
    if sparse:
        return (j_dataset.to_device_sparse_batch(jds, dtype=jnp.float64),
                t_dataset.to_device_sparse_batch(tds, dtype=torch.float64, device="cpu"))
    return (j_dataset.to_device_batch(jds, dtype=jnp.float64),
            t_dataset.to_device_batch(tds, dtype=torch.float64, device="cpu"))


def _models(task, means):
    """One coefficient vector as a JAX model and as the port's."""
    jm = j_model_for_task(JTask[task], JCoefficients(means=jnp.asarray(means)))
    return jm, convert.glm_from_numpy(TTask[task], means, device="cpu")


def _close(got, want, rtol, path=""):
    """Nested dicts/lists of numbers equal in structure, floats within
    ``rtol`` relative (absolute below 1e-300), everything else exactly."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _close(got[k], want[k], rtol, f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (a, b) in enumerate(zip(got, want)):
            _close(a, b, rtol, f"{path}[{i}]")
    elif isinstance(want, float):
        assert got == pytest.approx(want, rel=rtol, abs=1e-300), path
    else:
        assert got == want, path


# ---------------------------------------------------------------- the model


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("task", TASKS)
def test_glm_margin_batch_and_helpers_match_jax(task, sparse):
    """``compute_margin_batch`` (X·w + offsets on either layout, what every
    diagnostic scores with), ``update_coefficients`` and
    ``model_class_name`` as JAX's."""
    from photon_tpu_torch.models.coefficients import Coefficients as TCoefficients

    jb, tb = _batches(task, sparse=sparse, seed=19)
    means = np.random.default_rng(20).standard_normal(6)
    jm, tm = _models(task, means)
    np.testing.assert_allclose(tm.compute_margin_batch(tb).numpy(),
                               np.asarray(jm.compute_margin_batch(jb)), rtol=1e-12, atol=1e-14)
    assert tm.model_class_name == jm.model_class_name
    moved = tm.update_coefficients(TCoefficients(means=torch.zeros(6, dtype=torch.float64)))
    assert type(moved) is type(tm) and moved.task == tm.task
    np.testing.assert_array_equal(moved.compute_margin_batch(tb).numpy(), tb.offsets.numpy())
    assert float(tm.coefficients.means[0]) == means[0]  # the original is untouched


# ---------------------------------------------------------------- host statistics


@pytest.mark.parametrize("x,df", [(0.5, 1), (3.0, 4), (15.0, 8), (-1.0, 3), (2.0, 0)])
def test_chi_square_sf_matches_jax(x, df):
    want = j_hl.chi_square_sf(x, df)
    got = t_hl.chi_square_sf(x, df)
    assert (np.isnan(got) and np.isnan(want)) or got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("weighted", [False, True])
def test_hosmer_lemeshow_matches_jax(weighted):
    rng = np.random.default_rng(1)
    p = rng.uniform(size=800) ** 1.5
    y = (rng.uniform(size=800) < p).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=800) if weighted else None
    a, b = t_hl.hosmer_lemeshow(p, y, w), j_hl.hosmer_lemeshow(p, y, w)
    assert a.degrees_of_freedom == b.degrees_of_freedom
    assert a.well_calibrated == b.well_calibrated
    for got, want in [(a.chi_square, b.chi_square), (a.p_value, b.p_value)]:
        assert got == pytest.approx(want, rel=1e-12)
    for ba, bb in zip(a.bins, b.bins):
        _close(list(vars(ba).values()), list(vars(bb).values()), 1e-12)


@pytest.mark.parametrize("n", [300, 2500])  # 2500 > max_samples: the subsample
def test_kendall_tau_and_error_independence_match_jax(n):
    rng = np.random.default_rng(2)
    a = rng.standard_normal(n)
    b = 0.5 * a + rng.standard_normal(n)
    b[::7] = b[0]  # ties
    for fn in ("kendall_tau", "prediction_error_independence"):
        got = getattr(t_ind, fn)(a, b, seed=3)
        want = getattr(j_ind, fn)(a, b, seed=3)
        _close(list(vars(got).values()), list(vars(want).values()), 1e-12, fn)
        assert got.errors_independent == want.errors_independent


def test_peak_f1_matches_jax():
    rng = np.random.default_rng(5)
    scores = rng.standard_normal(400)
    scores[::5] = scores[1]  # tied scores
    labels = (rng.uniform(size=400) < 0.4).astype(np.float64)
    w = rng.uniform(0.5, 2.0, size=400)
    assert t_met.peak_f1(scores, labels, w) == pytest.approx(
        j_met.peak_f1(scores, labels, w), rel=1e-12)
    assert t_met.peak_f1(scores, 0 * labels, w) == j_met.peak_f1(scores, 0 * labels, w) == 0.0


@pytest.mark.parametrize("task", TASKS)
def test_log_likelihood_matches_jax(task):
    rng = np.random.default_rng(6)
    margins = rng.standard_normal(500)
    labels = _labels(task, margins, rng)
    w = rng.uniform(0.5, 2.0, size=500)
    got = t_met.log_likelihood(TTask[task], margins, labels, w)
    want = j_met.log_likelihood(JTask[task], margins, labels, w)
    assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
@pytest.mark.parametrize("task", TASKS)
def test_compute_metrics_matches_jax(task, sparse):
    jb, tb = _batches(task, sparse=sparse, seed=7)
    means = np.random.default_rng(8).standard_normal(6) * 0.5
    means[2] = 0.0  # AIC counts the nonzeros
    jm, tm = _models(task, means)
    got = t_met.compute_metrics(tm, tb, TTask[task], num_samples=300)
    want = j_met.compute_metrics(jm, jb, JTask[task], num_samples=300)
    _close(got, want, 1e-12)
    if task == "LOGISTIC_REGRESSION":
        assert t_met.AREA_UNDER_ROC in got and t_met.PEAK_F1 in got


@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "sparse"])
def test_importance_from_batch_matches_jax(sparse):
    jb, tb = _batches(sparse=sparse, seed=9)
    coefs = np.random.default_rng(10).standard_normal(6)
    want = j_imp.importance_from_batch(coefs, jb, num_samples=290, top_k=5)
    got = t_imp.importance_from_batch(coefs, tb, num_samples=290, top_k=5)
    assert [f.index for f in got.ranked] == [f.index for f in want.ranked]
    for a, b in zip(got.ranked, want.ranked):
        _close(list(vars(a).values()), list(vars(b).values()), 1e-12)
    _close(got.cumulative_share, want.cumulative_share, 1e-12)


def _document(mod):
    return mod.Document("diagnostics <t>", [
        mod.Chapter("System", [mod.Section("Dataset", [
            mod.Table(["samples", "features"], [["10", "3"]], caption="c & d"),
            mod.Text("hello <world>"),
        ])]),
        mod.Chapter("Model λ = 0.1", [mod.Section("Curves", [
            mod.LineChart("lc", "x", "y", [0.0, 0.5, 1.0],
                          {"model": [0.0, 0.7, 1.0], "chance": [0.0, 0.5, 1.0]}),
            mod.BarChart("bc", ["f1", "f2", "f3"], [3.0, -1.0, 0.25]),
            mod.LineChart("flat", "x", "y", [1.0], {"one": [2.0]}),
        ])]),
    ])


def test_render_html_and_text_identical():
    assert t_rep.render_html(_document(t_rep)) == j_rep.render_html(_document(j_rep))
    assert t_rep.render_text(_document(t_rep)) == j_rep.render_text(_document(j_rep))


# ---------------------------------------------------------------- retrains


def _norm_contexts(jds, tds):
    from photon_tpu.data.stats import BasicStatisticalSummary as JStats
    from photon_tpu_torch.data.stats import BasicStatisticalSummary as TStats

    sj, st = JStats.of(jds), TStats.of(tds)
    jn = JNorm.build(JNormType.STANDARDIZATION, mean=sj.mean, variance=sj.variance,
                     intercept_index=5, dtype=jnp.float64)
    tn = TNorm.build(TNormType.STANDARDIZATION, mean=st.mean, variance=st.variance,
                     intercept_index=5, dtype=torch.float64)
    return jn, tn


def _configs(lam=1.0):
    return tuple(
        cfg(task=task.LOGISTIC_REGRESSION, regularization=reg(rt.L2), regularization_weight=lam)
        for cfg, task, reg, rt in ((JConfig, JTask, JReg, JRegType),
                                   (TConfig, TTask, TReg, TRegType))
    )


def _recording(mp, module, sink):
    """Record every TrainedModel ``module.train_glm_grid`` returns."""
    fn = module.train_glm_grid

    def rec(*a, **kw):
        out = fn(*a, **kw)
        sink.extend(out)
        return out

    mp.setattr(module, "train_glm_grid", rec)


@pytest.fixture(scope="module")
def retrains():
    """fitting and bootstrap on identical batches in both packages, with
    STANDARDIZATION; every retrain recorded."""
    jds, tds = _datasets(seed=11)
    jv, tv = _datasets(seed=12, n=150)
    jn, tn = _norm_contexts(jds, tds)
    jcfg, tcfg = _configs()
    batch = {
        "jax": (j_dataset.to_device_batch(jds, dtype=jnp.float64),
                j_dataset.to_device_batch(jv, dtype=jnp.float64)),
        "port": (t_dataset.to_device_batch(tds, dtype=torch.float64, device="cpu"),
                 t_dataset.to_device_batch(tv, dtype=torch.float64, device="cpu")),
    }
    out = {}
    for side, fit_mod, boot_mod, cfg, task, norm in (
        ("jax", j_fit, j_boot, jcfg, JTask, jn), ("port", t_fit, t_boot, tcfg, TTask, tn)
    ):
        runs = []
        with pytest.MonkeyPatch.context() as mp:
            for mod in ((j_mt,) if side == "jax" else (t_fit, t_boot)):
                _recording(mp, mod, runs)
            train, valid = batch[side]
            fit = fit_mod.fitting_diagnostic(
                train, valid, cfg, task.LOGISTIC_REGRESSION, num_samples=300,
                num_test_samples=150, fractions=[0.25, 0.5, 1.0], normalization=norm, seed=4,
            )
            boot = boot_mod.bootstrap_diagnostic(
                train, valid, cfg, task.LOGISTIC_REGRESSION, num_samples=300,
                num_validation_samples=150, num_replicates=4, normalization=norm, seed=4,
            )
        out[side] = (fit, boot, runs)
    return out


def test_fitting_diagnostic_matches_jax(retrains):
    (tf, _, truns), (jf, _, jruns) = retrains["port"], retrains["jax"]
    assert tf.fractions == jf.fractions
    _close(tf.train_metrics, jf.train_metrics, RETRAIN_TOL)
    _close(tf.test_metrics, jf.test_metrics, RETRAIN_TOL)
    for a, b in zip(truns[:3], jruns[:3]):
        np.testing.assert_allclose(a.model.coefficients.means.numpy(),
                                   np.asarray(b.model.coefficients.means), rtol=RETRAIN_TOL,
                                   atol=RETRAIN_TOL)
        assert float(a.result.value) == pytest.approx(float(b.result.value), rel=RETRAIN_TOL)


def test_bootstrap_diagnostic_matches_jax(retrains):
    (_, tb, truns), (_, jb, jruns) = retrains["port"], retrains["jax"]
    assert len(truns) == len(jruns) == 3 + 1 + 4  # fractions, point, replicates
    for a, b in zip(truns[3:], jruns[3:]):
        np.testing.assert_allclose(a.model.coefficients.means.numpy(),
                                   np.asarray(b.model.coefficients.means), rtol=RETRAIN_TOL,
                                   atol=RETRAIN_TOL)
        assert float(a.result.value) == pytest.approx(float(b.result.value), rel=RETRAIN_TOL)
    assert tb.num_replicates == jb.num_replicates == 4
    assert [iv.index for iv in tb.intervals] == [iv.index for iv in jb.intervals]
    for a, b in zip(tb.intervals, jb.intervals):
        _close(list(vars(a).values()), list(vars(b).values()), RETRAIN_TOL)
        assert a.significant == b.significant
    _close(tb.metric_distributions, jb.metric_distributions, RETRAIN_TOL)
    assert tb.unstable_fraction == jb.unstable_fraction


def test_retrains_keep_the_window_layout_and_hold_no_weights():
    """A sparse batch with the window layout: each retrain replaces only
    ``weights`` (the layout object rides along unchanged) and equals the
    same retrain on the batch without a layout (the flat scatter), so no
    replicate reuses the point fit's weights through the layout."""
    _, tds = _datasets(seed=13, sparse=True)
    _, tv = _datasets(seed=14, n=100, sparse=True)
    (_, tcfg) = _configs(lam=0.5)
    with_w = t_dataset.to_device_sparse_batch(tds, dtype=torch.float64, device="cpu",
                                              column_windows=True)
    assert with_w.windows is not None
    w = np.linspace(0.0, 2.0, with_w.weights.shape[0])
    replaced = t_fit.reweighted(with_w, w)
    assert replaced.windows is with_w.windows and replaced.indices is with_w.indices
    np.testing.assert_array_equal(replaced.weights.numpy(), w)
    valid = t_dataset.to_device_sparse_batch(tv, dtype=torch.float64, device="cpu")
    reports = [
        t_boot.bootstrap_diagnostic(b, valid, tcfg, TTask.LOGISTIC_REGRESSION,
                                    num_samples=300, num_validation_samples=100,
                                    num_replicates=3, seed=5, num_features=6)
        for b in (with_w, with_w._replace(windows=None))
    ]
    for a, b in zip(*(r.intervals for r in reports)):
        _close(list(vars(a).values()), list(vars(b).values()), 1e-9)
    _close(reports[0].metric_distributions, reports[1].metric_distributions, 1e-9)


def test_sparse_retrain_without_its_layout_raises(monkeypatch):
    """Where the policy builds a layout (the card at d ≥ 1024, forced here)
    a windowless sparse retrain batch raises instead of taking the flat
    scatter."""
    _, tds = _datasets(seed=15, sparse=True)
    batch = t_dataset.to_device_sparse_batch(tds, dtype=torch.float64, device="cpu")
    monkeypatch.setattr(t_fit, "windows_wanted", lambda device, d: True)
    (_, tcfg) = _configs()
    for fn, kw in ((t_fit.fitting_diagnostic, {}), (t_boot.bootstrap_diagnostic, {})):
        with pytest.raises(ValueError, match="window layout"):
            fn(batch, batch, tcfg, TTask.LOGISTIC_REGRESSION, num_samples=300,
               num_features=6, **kw)


# ---------------------------------------------------------------- end to end


def _report_dicts(report):
    return {k: v for k, v in report.items() if k != "document"}


def _skeleton(text: str) -> str:
    """A rendered report with its numbers masked: the same chapters,
    sections, tables and rows in the same order. (Numbers print to 6
    digits, so a value that is 0 in one package and 3e-17 in the other —
    the spread of a constant column — reads differently; the JSON holds
    the numbers.)"""
    return re.sub(r"-?\d[\d.e+-]*", "#", text)


def test_diagnose_models_matches_jax(tmp_path, monkeypatch):
    """JAX's λ-grid models carried across as numpy; both packages' batches
    at float64 (JAX's diagnostics build theirs at float32 by default).
    report.json within 1e-9 relative, report.txt the same but for its
    numbers."""
    jds, tds = _datasets(seed=16, n=240)
    jv, tv = _datasets(seed=17, n=120)
    jcfg, tcfg = _configs()
    jn, tn = _norm_contexts(jds, tds)
    jmodels = j_train(jds, jcfg, [10.0, 1.0], normalization=jn, dtype=jnp.float64)
    tmodels = []
    for m in jmodels:
        t_glm = convert.glm_from_numpy(TTask.LOGISTIC_REGRESSION,
                                       np.asarray(m.model.coefficients.means), device="cpu")
        tmodels.append(type(m)(m.regularization_weight, t_glm, None, 0.0))
    monkeypatch.setattr(j_dataset, "to_device_auto_batch",
                        functools.partial(j_dataset.to_device_auto_batch, dtype=jnp.float64))
    kw = dict(train_data=None, best_index=1, bootstrap_replicates=3,
              fitting_fractions=(0.5, 1.0), seed=2)
    want = j_diagnose(jmodels, jv, JTask.LOGISTIC_REGRESSION, output_dir=str(tmp_path / "j"),
                      config=jcfg, normalization=jn, **{**kw, "train_data": jds})
    got = t_diagnose(tmodels, tv, TTask.LOGISTIC_REGRESSION, output_dir=str(tmp_path / "t"),
                     config=tcfg, normalization=tn, dtype=torch.float64, device="cpu",
                     **{**kw, "train_data": tds})
    _close(_report_dicts(got), _report_dicts(want), 1e-9)
    _close(json.loads((tmp_path / "t" / "report.json").read_text()),
           json.loads((tmp_path / "j" / "report.json").read_text()), 1e-9)
    assert _skeleton((tmp_path / "t" / "report.txt").read_text()) == _skeleton(
        (tmp_path / "j" / "report.txt").read_text())
    page = (tmp_path / "t" / "report.html").read_text()
    assert "Hosmer" in page and "Bootstrap" in page and "Regularization path" in page


def test_diagnose_models_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs on it")
    _, tds = _datasets(seed=18, n=40)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_diagnose([], tds, TTask.LOGISTIC_REGRESSION)


def test_legacy_driver_diagnose_matches_jax(tmp_path):
    """``--diagnose`` through both packages' legacy drivers on the same
    LIBSVM files, fits and diagnostics at float64: the stages end at
    DIAGNOSED, report.json within 1e-9 relative, report.txt the same but for
    its numbers."""
    from test_cli import _write_libsvm
    from test_torch_cli import _both, float64_drivers, j_ld, t_ld

    _write_libsvm(tmp_path / "a.libsvm", 0)
    _write_libsvm(tmp_path / "b.libsvm", 1)
    argv = [
        "--training-data-directory", str(tmp_path / "a.libsvm"),
        "--validating-data-directory", str(tmp_path / "b.libsvm"),
        "--output-directory", "{out}", "--input-format", "LIBSVM",
        "--task", "LOGISTIC_REGRESSION", "--regularization-type", "L2",
        "--regularization-weights", "0.1,1,10", "--normalization-type", "STANDARDIZATION",
        "--max-num-iterations", "50", "--diagnose",
    ]
    with float64_drivers(), pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_dataset, "to_device_auto_batch",
                   functools.partial(j_dataset.to_device_auto_batch, dtype=jnp.float64))
        jdrv, tdrv = _both(j_ld.run, t_ld.run, argv, tmp_path / "out")
    assert tdrv.stage.name == jdrv.stage.name == "DIAGNOSED"
    out = tmp_path / "out"
    assert json.loads((out / "port" / "metrics.json").read_text())["stages"][-1] == "DIAGNOSED"
    rj = json.loads((out / "jax" / "diagnostics" / "report.json").read_text())
    rt = json.loads((out / "port" / "diagnostics" / "report.json").read_text())
    _close(rt, rj, 1e-9)
    assert {"fitting", "bootstrap"} <= rt.keys() and rt["bootstrap"]["replicates"] == 8
    assert _skeleton((out / "port" / "diagnostics" / "report.txt").read_text()) == _skeleton(
        (out / "jax" / "diagnostics" / "report.txt").read_text())
    assert (out / "port" / "diagnostics" / "report.html").exists()
