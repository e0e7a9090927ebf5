"""Port parity: GLMProblem against photon_tpu/optimize/problem.py.

Every (optimizer × regularization) pair the JAX package accepts solves as
it does there (x at rtol 1e-8, equal iterations, reason and work
counters); the pairs it refuses raise ValueError in both packages.
Variances NONE, SIMPLE and FULL agree at rtol 1e-9, and the down-sampler
keeps the same rows with the same weights.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.data.dataset import DataSet as JDataSet
from photon_tpu.ops.normalization import NormalizationContext as JNorm
from photon_tpu.optimize import problem as jp
from photon_tpu.optimize.common import OptimizerConfig as JConfig
from photon_tpu.types import LabeledBatch as JDense
from photon_tpu.types import OptimizerType as JOpt
from photon_tpu.types import SparseBatch as JSparse
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.data.dataset import DataSet as TDataSet
from photon_tpu_torch.ops.normalization import NormalizationContext as TNorm
from photon_tpu_torch.ops.sparse_windows import build_column_windows as tbuild
from photon_tpu_torch.optimize import problem as tp
from photon_tpu_torch.optimize.common import OptimizerConfig as TConfig
from photon_tpu_torch.types import LabeledBatch as TDense
from photon_tpu_torch.types import OptimizerType as TOpt
from photon_tpu_torch.types import SparseBatch as TSparse
from photon_tpu_torch.types import TaskType as TTask

N, D, K = 240, 10, 5
COUNTERS = ("iterations", "reason", "n_evals", "n_hvp", "n_feature_passes")


def _dense(seed=0, task="LOGISTIC_REGRESSION"):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((N, D))
    x[:, 0] = 1.0
    z = x @ (0.5 * rng.standard_normal(D))
    if task == "LOGISTIC_REGRESSION":
        y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    else:
        y = z + 0.1 * rng.standard_normal(N)
    arrays = (x, y, 0.05 * rng.standard_normal(N), rng.uniform(0.5, 1.5, size=N))
    return JDense(*map(jnp.asarray, arrays)), TDense(*map(torch.as_tensor, arrays))


def _sparse(seed=1):
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, D, size=(N, K)).astype(np.int32)
    idx[:, 0] = 0
    val = rng.standard_normal((N, K))
    val[:, 0] = 1.0
    z = (val * (0.5 * rng.standard_normal(D))[idx]).sum(1)
    y = (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    cols = (y, np.zeros(N), np.ones(N))
    win = tbuild(idx, val, D, window=4, instance_cap=64, chunk=16, dtype=torch.float64)
    return (
        JSparse(jnp.asarray(idx), jnp.asarray(val), *map(jnp.asarray, cols)),
        TSparse(torch.as_tensor(idx), torch.as_tensor(val), *map(torch.as_tensor, cols), win),
    )


def _configs(opt, reg, *, task="LOGISTIC_REGRESSION", weight=3.0, variance="NONE", **opt_kw):
    out = []
    for mod, Config, Task, Opt in ((jp, JConfig, JTask, JOpt), (tp, TConfig, TTask, TOpt)):
        out.append(
            mod.GLMProblemConfig(
                task=Task[task],
                optimizer=Opt[opt],
                optimizer_config=Config(**opt_kw),
                regularization=mod.RegularizationContext(
                    mod.RegularizationType[reg], elastic_net_alpha=0.4
                ),
                regularization_weight=weight,
                variance_computation=mod.VarianceComputationType[variance],
            )
        )
    return out


def _box():
    """|x₃| ≤ 0.2, which binds at the solution; the others free."""
    lo, hi = np.full(D, -np.inf), np.full(D, np.inf)
    lo[3], hi[3] = -0.2, 0.2
    return lo, hi


OPTIMIZERS = ["LBFGS", "OWLQN", "LBFGSB", "TRON"]
REGULARIZATIONS = ["NONE", "L1", "L2", "ELASTIC_NET"]


@pytest.mark.parametrize("reg", REGULARIZATIONS)
@pytest.mark.parametrize("opt", OPTIMIZERS)
def test_every_pair_solves_or_refuses_as_jax(opt, reg):
    kw = {}
    if opt == "LBFGSB":
        kw = dict(zip(("lower_bounds", "upper_bounds"), _box()))
    jcfg, tcfg = _configs(opt, reg, **kw)
    try:
        jprob = jp.GLMProblem.build(jcfg)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:20]):
            tp.GLMProblem.build(tcfg)
        assert reg in ("L1", "ELASTIC_NET") and opt in ("LBFGSB", "TRON")
        return
    tprob = tp.GLMProblem.build(tcfg)
    assert tprob.objective.l1_weight == jprob.objective.l1_weight
    assert tprob.objective.l2_weight == jprob.objective.l2_weight
    jb, tb = _dense()
    jres = jprob.solve(jb, jnp.zeros(D))
    tres = tprob.solve(tb, torch.zeros(D, dtype=torch.float64))
    for name in COUNTERS:
        assert int(getattr(tres, name)) == int(getattr(jres, name)), name
    assert int(tres.reason) in (2, 3)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-8, atol=1e-12)
    if reg in ("L1", "ELASTIC_NET"):
        np.testing.assert_array_equal(tres.x.numpy() == 0, np.asarray(jres.x) == 0)


def test_tron_refuses_a_loss_without_second_derivative():
    jcfg, tcfg = _configs("TRON", "L2", task="SMOOTHED_HINGE_LOSS_LINEAR_SVM")
    with pytest.raises(ValueError, match="twice-differentiable"):
        jp.GLMProblem.build(jcfg)
    with pytest.raises(ValueError, match="twice-differentiable"):
        tp.GLMProblem.build(tcfg)


def test_tron_untouched_config_takes_tron_defaults():
    """An untouched OptimizerConfig becomes TRON's (15 iterations, 1e-5);
    a customised one is kept (here: it stops on the iteration cap)."""
    jb, tb = _dense(2, task="LINEAR_REGRESSION")
    for kw in ({}, {"max_iterations": 2}):
        jcfg, tcfg = _configs("TRON", "L2", task="LINEAR_REGRESSION", **kw)
        jres = jp.GLMProblem.build(jcfg).solve(jb, jnp.zeros(D))
        tres = tp.GLMProblem.build(tcfg).solve(tb, torch.zeros(D, dtype=torch.float64))
        for name in COUNTERS:
            assert int(getattr(tres, name)) == int(getattr(jres, name)), name
        np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-8)
    assert int(tres.iterations) == 2


def _imported(path):
    """Every module an ``import`` statement of ``path`` (a module of
    ``optimize/``) names, with its line: ``from a import b`` names a and
    a.b, a relative import its absolute name."""
    pkg = tp.__name__.rpartition(".")[0]
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            out += [(a.name, node.lineno) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module
            if node.level:
                base = ".".join(filter(None, [pkg.rsplit(".", node.level - 1)[0], base]))
            out += [(base, node.lineno)] + [(f"{base}.{a.name}", node.lineno)
                                            for a in node.names]
    return out


@pytest.mark.parametrize("module", ["lane_lbfgs", "solo_lbfgs"])
def test_the_kernel_modules_import_nothing_of_the_problem(module):
    """The dispatch rules ask the problem for its half
    (``GLMProblem.solver_reason``), so the kernel modules need nothing of
    ``optimize.problem`` and ``problem`` imports them at module level."""
    path = Path(tp.__file__).with_name(f"{module}.py")
    bad = [(name, line) for name, line in _imported(path)
           if name == tp.__name__ or name.startswith(tp.__name__ + ".")]
    assert not bad, f"{path.name} imports {bad}"


def test_the_problem_module_imports_nothing_inside_a_function():
    path = Path(tp.__file__)
    nested = [(node.lineno, fn.name) for fn in ast.walk(ast.parse(path.read_text()))
              if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef))
              for node in ast.walk(fn) if isinstance(node, (ast.Import, ast.ImportFrom))]
    assert not nested, f"{path.name} imports inside functions at {nested}"


def test_solve_with_reg_weight_and_extra_offsets():
    """λ passed at solve time and the residual folded into the offsets."""
    jb, tb = _dense(3)
    jcfg, tcfg = _configs("OWLQN", "ELASTIC_NET", weight=1.0)
    extra = 0.2 * np.random.default_rng(4).standard_normal(N)
    jres = jp.GLMProblem.build(jcfg).solve(
        jb, jnp.zeros(D), 4.0, extra_offsets=jnp.asarray(extra)
    )
    tres = tp.GLMProblem.build(tcfg).solve(
        tb, torch.zeros(D, dtype=torch.float64), 4.0, extra_offsets=torch.as_tensor(extra)
    )
    for name in COUNTERS:
        assert int(getattr(tres, name)) == int(getattr(jres, name)), name
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-8, atol=1e-12)


def _norms(normalized):
    if not normalized:
        return JNorm(), TNorm()
    rng = np.random.default_rng(9)
    shifts, factors = 0.2 * rng.standard_normal(D), 1.0 + 0.3 * rng.uniform(size=D)
    shifts[0], factors[0] = 0.0, 1.0
    return (
        JNorm(factors=jnp.asarray(factors), shifts=jnp.asarray(shifts), intercept_index=0),
        TNorm(factors=torch.as_tensor(factors), shifts=torch.as_tensor(shifts), intercept_index=0),
    )


@pytest.mark.parametrize("normalized", [False, True])
@pytest.mark.parametrize("layout", ["dense", "windows"])
@pytest.mark.parametrize("variance", ["NONE", "SIMPLE", "FULL"])
def test_variances_match_jax(variance, layout, normalized):
    jb, tb = _dense(5) if layout == "dense" else _sparse(6)
    jn, tn = _norms(normalized)
    jcfg, tcfg = _configs("LBFGS", "L2", weight=0.5, variance=variance)
    jprob, tprob = jp.GLMProblem.build(jcfg, jn), tp.GLMProblem.build(tcfg, tn)
    w = 0.3 * np.random.default_rng(8).standard_normal(D)
    jv = jprob.variances(jb, jnp.asarray(w))
    tv = tprob.variances(tb, torch.as_tensor(w))
    if variance == "NONE":
        assert jv is None and tv is None
        return
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-9)


def _dataset(pkg, task_seed=0, classification=True):
    rng = np.random.default_rng(task_seed)
    x = rng.standard_normal((300, 4))
    x[rng.uniform(size=x.shape) < 0.3] = 0.0
    y = (
        (rng.uniform(size=300) < 0.3).astype(np.float64)
        if classification
        else rng.standard_normal(300)
    )
    return pkg.from_dense(x, y, weights=rng.uniform(0.5, 2.0, 300))


@pytest.mark.parametrize("task", ["LOGISTIC_REGRESSION", "LINEAR_REGRESSION"])
@pytest.mark.parametrize("rate", [0.3, 0.75, 1.0])
def test_down_sampler_keeps_the_same_rows(task, rate):
    jcfg, tcfg = _configs("LBFGS", "L2", task=task)
    jcfg = dataclasses.replace(jcfg, down_sampling_rate=rate)
    tcfg = dataclasses.replace(tcfg, down_sampling_rate=rate)
    js = jp.GLMProblem.build(jcfg).down_sampler()
    ts = tp.GLMProblem.build(tcfg).down_sampler()
    if rate == 1.0:
        assert js is None and ts is None
        return
    assert type(ts).__name__ == type(js).__name__
    classification = task == "LOGISTIC_REGRESSION"
    for seed in (0, 3):
        jd = js.downsample(_dataset(JDataSet, classification=classification), seed=seed)
        td = ts.downsample(_dataset(TDataSet, classification=classification), seed=seed)
        assert td.num_samples == jd.num_samples < 300
        for f in ("indptr", "indices", "values", "labels", "offsets", "weights"):
            np.testing.assert_array_equal(getattr(td, f), getattr(jd, f), err_msg=f)
