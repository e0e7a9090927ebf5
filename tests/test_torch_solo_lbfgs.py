"""The fixed effect's fused L-BFGS iteration (``solo_head`` and
``solo_search`` in ``csrc/lane_lbfgs.cu``) and the rule that sends a
one-lane solve to it.

The CPU tests pin the dispatch rule of ``GLMProblem.solve``: which solves
take the kernels (``optimize.solo_lbfgs.plain_loop_reason`` returns None)
and which keep the plain loop, and the solve counts ``lbfgs.solo_fused`` /
``lbfgs.solo_plain``. The ``cuda`` tests hold the fused solve to the plain
loop (``optimize.lbfgs._minimize_lbfgs`` with the margin oracle, on the
same CUDA tensors) on the card: ``pytest -m cuda
tests/test_torch_solo_lbfgs.py``. No JAX here.
"""
from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.data.dataset import DataSet, to_device_sparse_batch
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optimize import lane_lbfgs, solo_lbfgs
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.lbfgs import _minimize_lbfgs
from photon_tpu_torch.optimize.problem import (
    GLMProblem,
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import LabeledBatch, OptimizerType, TaskType
from test_torch_lane_lbfgs import _estimator, _game_data

TASKS = [TaskType.LOGISTIC_REGRESSION, TaskType.LINEAR_REGRESSION,
         TaskType.POISSON_REGRESSION, TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM]
FIELDS = ("x", "value", "gradient", "iterations", "reason", "loss_history",
          "grad_norm_history", "n_evals", "n_hvp", "n_feature_passes")
COUNTS = ("iterations", "reason", "n_evals", "n_hvp", "n_feature_passes")


@pytest.fixture(autouse=True)
def _clean():
    obs.reset()
    yield
    obs.reset()


def _config(task=TaskType.LOGISTIC_REGRESSION, *, optimizer=OptimizerType.LBFGS,
            reg=RegularizationType.L2, iters=10, ls=10, m=10, tol=1e-7, **opt_kw):
    return GLMProblemConfig(
        task=task, optimizer=optimizer,
        optimizer_config=OptimizerConfig(max_iterations=iters, num_corrections=m,
                                          ls_max_iterations=ls, tolerance=tol, **opt_kw),
        regularization=RegularizationContext(reg), regularization_weight=1.0)


def _fixed_effect(n, d, task=TaskType.LOGISTIC_REGRESSION, *, dtype=torch.float64,
                  device="cpu", seed=0, scale=1.0, k=4):
    """A fixed effect's batch as the coordinates hold it: an intercept and
    k − 1 columns a row of ``d``, every value ``scale``, in padded ELL with
    the column-window layout (the windowed Xᵀr), rows padded with weight 0;
    offsets of a residual's scale, weights in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(1, d, size=(n, k))
    cols[:, 0] = 0
    beta = rng.normal(size=d) * 0.5
    margin = beta[cols].sum(1) * scale
    if task == TaskType.LINEAR_REGRESSION:
        labels = margin + 0.3 * rng.normal(size=n)
    elif task == TaskType.POISSON_REGRESSION:
        labels = rng.poisson(np.exp(np.clip(margin, -3.0, 3.0))).astype(np.float64)
    else:
        labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    ds = DataSet(indptr=np.arange(n + 1, dtype=np.int64) * k,
                 indices=cols.ravel().astype(np.int32), values=np.full(n * k, scale),
                 labels=labels, offsets=0.1 * rng.normal(size=n),
                 weights=rng.uniform(0.5, 2.0, size=n), num_features=d)
    return to_device_sparse_batch(ds, dtype=dtype, device=device, column_windows=True)


def _on_cuda(w0_dtype=torch.float32, dim=1):
    """A stand-in for a CUDA coefficient vector: the rule reads only its
    rank, type and device."""
    return SimpleNamespace(dim=lambda: dim, dtype=w0_dtype, device=torch.device("cuda"))


# -- the dispatch rule, on the CPU --------------------------------------------

ONE_LANE = SimpleNamespace(labels=torch.zeros(6))
DISPATCH = {
    # name: (config kwargs, normalization, mesh ranks (0: none), w0, want)
    "l2_logistic_on_cuda": ({}, None, 0, _on_cuda(), None),
    "float64_on_cuda": ({}, None, 0, _on_cuda(torch.float64), None),
    "lbfgsb_without_bounds": ({"optimizer": OptimizerType.LBFGSB}, None, 0, _on_cuda(),
                              None),
    "no_regularization": ({"reg": RegularizationType.NONE}, None, 0, _on_cuda(), None),
    "at_the_cap": ({"m": 32}, None, 0, _on_cuda(), None),
    "on_cpu": ({}, None, 0, torch.zeros(3), "on cpu"),
    "box": ({"lower_bounds": np.zeros(3)}, None, 0, _on_cuda(), "box bounds"),
    "upper_box": ({"upper_bounds": np.ones(3)}, None, 0, _on_cuda(), "box bounds"),
    "l1": ({"reg": RegularizationType.L1}, None, 0, _on_cuda(), "regularization L1"),
    "elastic_net": ({"reg": RegularizationType.ELASTIC_NET}, None, 0, _on_cuda(),
                    "regularization ELASTIC_NET"),
    "owlqn": ({"optimizer": OptimizerType.OWLQN}, None, 0, _on_cuda(), "optimizer OWLQN"),
    "tron": ({"optimizer": OptimizerType.TRON}, None, 0, _on_cuda(), "optimizer TRON"),
    "factors": ({}, "factors", 0, _on_cuda(), "normalization"),
    "shifts": ({}, "shifts", 0, _on_cuda(), "normalization"),
    "mesh_of_two": ({}, None, 2, _on_cuda(), "a mesh of 2 ranks"),
    "mesh_of_one": ({}, None, 1, _on_cuda(), None),
    "lanes": ({}, None, 0, _on_cuda(dim=2), "not one lane: w0 [D] over row vectors [N]"),
    "bfloat16": ({}, None, 0, _on_cuda(torch.bfloat16), "w0 torch.bfloat16"),
    "m_above_cap": ({"m": 33}, None, 0, _on_cuda(), "num_corrections 33 outside 1..32"),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_the_dispatch_rule(name):
    """A one-lane L-BFGS solve with L2 (or none) of float32 or float64 on
    the card takes the kernels, off a mesh or on a mesh of one rank;
    everything else names what keeps it on the plain loop, wherever it
    runs."""
    kw, norm, ranks, w0, want = DISPATCH[name]
    normalization = NormalizationContext()
    if norm == "factors":
        normalization = NormalizationContext(factors=torch.full((3,), 2.0, dtype=torch.float64))
    elif norm == "shifts":
        shifts = torch.tensor([0.0, 0.5, 0.5], dtype=torch.float64)
        normalization = NormalizationContext(shifts=shifts, intercept_index=0)
    # a mesh as the rule reads it: distributed, with its number of ranks
    mesh = SimpleNamespace(distributed=True, size=ranks)
    problem = GLMProblem.build(_config(**kw), normalization, **({"mesh": mesh} if ranks else {}))
    assert solo_lbfgs.plain_loop_reason(problem, ONE_LANE, w0) == want


@pytest.mark.parametrize("mode,want", [("full", "full line search"), (" FULL ", "full line search"),
                                       ("margin", None)])
def test_the_line_search_switch(monkeypatch, mode, want):
    monkeypatch.setenv("PHOTON_GLM_LINESEARCH", mode)
    assert solo_lbfgs.plain_loop_reason(GLMProblem.build(_config()), ONE_LANE,
                                        _on_cuda()) == want


def test_a_lane_batch_of_row_vectors_keeps_the_plain_loop():
    """A [D] coefficient vector over [B, rows] row vectors is no one-lane solve."""
    batch = SimpleNamespace(labels=torch.zeros((2, 6)))
    assert solo_lbfgs.plain_loop_reason(GLMProblem.build(_config()), batch, _on_cuda()) == \
        "not one lane: w0 [D] over row vectors [N]"


@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.name)
def test_a_one_lane_solve_on_the_cpu_is_the_plain_loop_and_counts_as_plain(task):
    """On the CPU every one-lane L-BFGS solve runs the plain loop, bit for
    bit what ``minimize_lbfgs`` gives on the margin oracle, and counts as
    ``lbfgs.solo_plain``, telemetry off as on."""
    b = _fixed_effect(300, 20, task, seed=2)
    w0 = torch.zeros(20, dtype=torch.float64)
    problem = GLMProblem.build(_config(task))
    launches = cuda_build.launch_count("solo_head", "solo_search")
    got = problem.solve(b, w0)
    want = _minimize_lbfgs(None, w0, problem.config.optimizer_config,
                           problem.objective.directional_oracle(b))
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    obs.enable()
    try:
        problem.solve(b, w0)
    finally:
        obs.disable()
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["lbfgs.solo_plain"] == 2 and "lbfgs.solo_fused" not in counters
    assert cuda_build.launch_count("solo_head", "solo_search") == launches


@pytest.mark.parametrize("kw,reason", [({}, "on cpu"),
                                       ({"optimizer": OptimizerType.LBFGSB,
                                         "upper_bounds": np.full(20, 10.0)}, "box bounds")])
def test_a_cpu_one_lane_solve_lands_in_the_route_record(kw, reason):
    """A CPU one-lane L-BFGS(-B) solve is recorded under ("solo", "cpu",
    its plain reason) in the process-lifetime route record, which an
    ``obs.reset()`` between two solves leaves counting both; the registry
    tally still counts each solve from the reset on."""
    b = _fixed_effect(200, 20, seed=6)
    w0 = torch.zeros(20, dtype=torch.float64)
    problem = GLMProblem.build(_config(**kw))
    key = ("solo", "cpu", reason)
    before = lane_lbfgs.routes[key]
    problem.solve(b, w0)
    assert obs.get_registry().snapshot()["counters"]["lbfgs.solo_plain"] == 1
    obs.reset()
    problem.solve(b, w0)
    assert lane_lbfgs.routes[key] - before == 2
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["lbfgs.solo_plain"] == 1 and "lbfgs.solo_fused" not in counters


def test_only_one_lane_lbfgs_solves_are_counted():
    """Lane batches ([B, d]), OWL-QN and TRON solves count in neither."""
    b = _fixed_effect(200, 12, seed=3)
    for opt, reg in ((OptimizerType.OWLQN, RegularizationType.L1),
                     (OptimizerType.TRON, RegularizationType.L2)):
        GLMProblem.build(_config(optimizer=opt, reg=reg)).solve(
            b, torch.zeros(12, dtype=torch.float64))
    lanes = LabeledBatch(features=torch.rand(3, 5, 4, dtype=torch.float64),
                         labels=torch.ones(3, 5, dtype=torch.float64),
                         offsets=torch.zeros(3, 5, dtype=torch.float64),
                         weights=torch.ones(3, 5, dtype=torch.float64))
    GLMProblem.build(_config()).solve(lanes, torch.zeros((3, 4), dtype=torch.float64))
    counters = obs.get_registry().snapshot()["counters"]
    assert "lbfgs.solo_plain" not in counters and "lbfgs.solo_fused" not in counters


def test_the_fused_side_of_the_dispatch_counts_as_fused(monkeypatch):
    """Where the rule finds nothing against a solve, ``GLMProblem.solve``
    hands it, and the objective at the solve's λ, to ``minimize_solo`` and
    counts it as ``lbfgs.solo_fused``."""
    b = _fixed_effect(200, 12, seed=4)
    w0 = torch.zeros(12, dtype=torch.float64)
    seen = []

    def fake(problem, batch, x0, objective):
        seen.append(objective.l2_weight)
        return _minimize_lbfgs(None, x0, problem.config.optimizer_config,
                               objective.directional_oracle(batch))

    monkeypatch.setattr(solo_lbfgs, "plain_loop_reason", lambda problem, batch, x0: None)
    monkeypatch.setattr(solo_lbfgs, "minimize_solo", fake)
    problem = GLMProblem.build(_config())
    problem.solve(b, w0)
    problem.solve(b, w0, reg_weight=3.0)
    assert seen == [1.0, 3.0]
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["lbfgs.solo_fused"] == 2 and "lbfgs.solo_plain" not in counters


def test_the_wrapper_raises_before_the_card():
    b = _fixed_effect(50, 6, seed=5)
    w0 = torch.zeros(6, dtype=torch.float64)
    with pytest.raises(ValueError, match="does not take this solve: on cpu"):
        solo_lbfgs.minimize_solo(GLMProblem.build(_config()), b, w0)
    with pytest.raises(ValueError, match="regularization L1"):
        solo_lbfgs.minimize_solo(GLMProblem.build(_config(reg=RegularizationType.L1)), b, w0)
    with pytest.raises(ValueError, match="not one lane"):
        solo_lbfgs.minimize_solo(GLMProblem.build(_config()), b, torch.zeros((2, 6)))


def test_a_fit_on_the_cpu_counts_every_fixed_effect_solve_as_plain():
    coords = _estimator()._build_coordinates(_game_data())
    run_coordinate_descent(coords, ["fixed", "user", "item"], 2)
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["lbfgs.solo_plain"] == 2 and "lbfgs.solo_fused" not in counters


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    return torch.device("cuda")


def _cpu(res):
    return {f: getattr(res, f).cpu() for f in FIELDS}


def _rel(a, b):
    return float(torch.linalg.vector_norm(a - b) / torch.linalg.vector_norm(b).clamp_min(1e-300))


#: (what it exercises, fixed-effect kwargs, config kwargs); found with the
#: plain loop on these data: "zoom" enters the zoom stage, "exhausted" ends
#: searches at ls_max_iterations (on the smoothed hinge and Poisson, a step
#: that fails), "converges" stops on the function values before its cap,
#: "skips" has sᵀy ≤ 1e-10 at every pair (features of 1e-6, no λ) and
#: exhausts every search on its best Armijo point, "ring" wraps m = 3
SOLVES = {
    "cap": ({}, {}),
    "zoom": ({"scale": 10.0}, {"iters": 12}),
    "exhausted": ({"scale": 3.0}, {"ls": 2}),
    "converges": ({}, {"iters": 100}),
    "skips": ({"scale": 1e-6}, {"reg": RegularizationType.NONE, "iters": 12, "tol": 1e-12}),
    "ring": ({}, {"m": 3, "iters": 15}),
    "one_iteration": ({}, {"iters": 1}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.name)
@pytest.mark.parametrize("case", list(SOLVES))
def test_the_kernels_match_the_plain_loop_at_float64(task, case):
    """Decision for decision: the same iterations, stopping reason, trials
    and feature passes; x and the loss history within 1e-10 of the plain
    loop's, relative. The value and gradient are the exact evaluation at
    the fused solve's x, bit for bit, so they differ from the plain loop's
    by what the Hessian makes of x's gap: the gradient is held within 1e-8
    of 1 + its norm (a converged Poisson solve, whose curvature sums
    exp(z) over the rows, reads 8e-10 on a 1e-12 gap in x)."""
    dev = _card()
    data_kw, cfg_kw = SOLVES[case]
    b = _fixed_effect(3000, 200, task, device=dev, seed=7, **data_kw)
    w0 = torch.zeros(200, dtype=torch.float64, device=dev)
    problem = GLMProblem.build(_config(task, **cfg_kw))
    fused = solo_lbfgs.minimize_solo(problem, b, w0)
    f_exact, g_exact = problem.objective.value_and_gradient(fused.x, b)
    assert torch.equal(fused.value, f_exact) and torch.equal(fused.gradient, g_exact)
    got = _cpu(fused)
    want = _cpu(_minimize_lbfgs(None, w0, problem.config.optimizer_config,
                                problem.objective.directional_oracle(b)))
    for f in COUNTS:
        assert torch.equal(got[f], want[f]), (f, got[f], want[f])
    assert _rel(got["x"], want["x"]) <= 1e-10
    assert _rel(got["loss_history"], want["loss_history"]) <= 1e-10
    assert float((got["value"] - want["value"]).abs() / want["value"].abs()) <= 1e-10
    scale = 1.0 + torch.linalg.vector_norm(want["gradient"])
    assert float(torch.linalg.vector_norm(got["gradient"] - want["gradient"]) / scale) <= 1e-8
    assert _rel(got["grad_norm_history"], want["grad_norm_history"]) <= 1e-9


@pytest.mark.cuda
def test_the_cases_cover_what_they_name():
    """The cases take the branches they are named for."""
    dev = _card()

    def solve(case, task=TaskType.LOGISTIC_REGRESSION):
        data_kw, cfg_kw = SOLVES[case]
        b = _fixed_effect(3000, 200, task, device=dev, seed=7, **data_kw)
        problem = GLMProblem.build(_config(task, **cfg_kw))
        return solo_lbfgs.minimize_solo(problem, b, torch.zeros(200, dtype=torch.float64,
                                                                device=dev))

    assert int(solve("converges").reason) == 2 and int(solve("converges").iterations) < 100
    skips = solve("skips")
    assert int(skips.n_evals) == 2 + 10 * 12 + 1  # every search exhausted
    exhausted = solve("exhausted", TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM)
    assert int(exhausted.n_evals) > 2 + int(exhausted.iterations) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.name)
def test_the_kernels_at_float32_reach_the_optimum_as_the_stopping_test_allows(task):
    """At float32 the kernels sum in float64 and the plain loop in float32,
    so the two may stop an iteration apart and are not compared decision
    for decision. The fused solve, run to convergence, is held against the
    exact optimum x* (the plain loop at float64 with tol 1e-12), objectives
    in float64: the gap f(x) − f(x*) within 100·tol·(1 + |f(0)|), and
    ‖x − x*‖² within what λ-strong convexity allows for it, 2·gap/λ."""
    dev = _card()
    b = _fixed_effect(20000, 500, task, dtype=torch.float32, device=dev, seed=11)
    w0 = torch.zeros(500, dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config(task, iters=100))
    got = solo_lbfgs.minimize_solo(problem, b, w0)
    b64 = b._replace(values=b.values.double(), labels=b.labels.double(),
                     offsets=b.offsets.double(), weights=b.weights.double(),
                     windows=b.windows._replace(vals=b.windows.vals.double()))
    exact = GLMProblem.build(_config(task, iters=300, tol=1e-12)).solve(b64, w0.double())
    f = problem.objective.value
    f_zero = f(w0.double(), b64)
    gap = float(f(got.x.double(), b64) - f(exact.x, b64))
    assert gap / (1.0 + float(f_zero.abs())) <= 100 * 1e-7
    dist2 = float(torch.linalg.vector_norm(got.x.double() - exact.x) ** 2)
    assert dist2 <= 2.0 * max(gap, 0.0) * 1.01 + 1e-12


@pytest.mark.cuda
def test_a_solve_repeats_bit_for_bit_and_each_launch_repeats_its_work():
    dev = _card()
    b = _fixed_effect(5000, 300, device=dev, dtype=torch.float32, seed=12)
    w0 = torch.zeros(300, dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config(iters=8))
    first = _cpu(solo_lbfgs.minimize_solo(problem, b, w0))
    again = _cpu(solo_lbfgs.minimize_solo(problem, b, w0))
    for f in FIELDS:
        assert torch.equal(first[f], again[f]), f
    # a head and a search issued again from the same state write the same
    # bits, and each launch counts where it is issued
    launches = cuda_build.launch_count("solo_head", "solo_search")
    solve = solo_lbfgs.SoloSolve(problem.objective, b, w0, problem.config.optimizer_config)
    names = ("x", "g", "d", "s_hist", "y_hist", "rho", "loss_hist", "gnorm_hist", "sc", "si",
             "z", "u")

    def twice(launch):
        before = {k: getattr(solve, k).clone() for k in names}
        launch()
        after = {k: getattr(solve, k).clone() for k in names}
        for k in names:
            getattr(solve, k).copy_(before[k])
        launch()
        for k in names:  # as bytes: the histories' unwritten tail may hold NaNs
            assert torch.equal(getattr(solve, k).view(torch.uint8), after[k].view(torch.uint8)), k

    solve.head(first=True)
    solve.forward()
    solve.search()
    solve.backward()
    twice(solve.head)
    solve.forward()
    twice(solve.search)
    assert cuda_build.launch_count("solo_head", "solo_search") - launches == 6


@pytest.mark.cuda
def test_the_wrapper_raises_on_what_the_kernels_do_not_take():
    dev = _card()
    b = _fixed_effect(64, 8, device=dev, dtype=torch.float32)
    w0 = torch.zeros(8, dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config())
    with pytest.raises(ValueError, match=r"weights has shape \(63,\)"):
        solo_lbfgs.minimize_solo(problem, b._replace(weights=b.weights[:63]), w0)
    with pytest.raises(ValueError, match="labels is on cpu"):
        solo_lbfgs.minimize_solo(problem, b._replace(labels=b.labels.cpu()), w0)
    with pytest.raises(ValueError, match="w0 torch.float16"):
        solo_lbfgs.minimize_solo(problem, b, w0.half())
    with pytest.raises(ValueError, match="num_corrections 33 outside 1..32"):
        solo_lbfgs.minimize_solo(GLMProblem.build(_config(m=33)), b, w0)


@pytest.mark.cuda
def test_a_fit_on_the_card_takes_the_kernels_for_every_fixed_effect_solve(monkeypatch):
    """Every fixed-effect solve of a GAME fit on the card goes through the
    kernels, two launches an iteration and one more a solve, and the fit's
    coefficients equal the plain loop's on the card within 1e-9 at
    float64."""
    dev = _card()
    coords = _estimator(device=dev)._build_coordinates(_game_data(seed=2))
    launches = cuda_build.launch_count("solo_head", "solo_search")
    got = run_coordinate_descent(coords, ["fixed", "user", "item"], 2)
    fixed = [r["info"] for r in got.tracker if r.get("coordinate") == "fixed"]
    assert cuda_build.launch_count("solo_head", "solo_search") - launches == \
        sum(2 * int(r.iterations) + 1 for r in fixed)
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["lbfgs.solo_fused"] == 2 and "lbfgs.solo_plain" not in counters
    monkeypatch.setattr(solo_lbfgs, "plain_loop_reason", lambda problem, batch, w0: "forced")
    want = run_coordinate_descent(coords, ["fixed", "user", "item"], 2)
    assert _rel(got.states["fixed"], want.states["fixed"]) <= 1e-9
    rel = torch.linalg.vector_norm(got.total - want.total) / torch.linalg.vector_norm(want.total)
    assert float(rel) <= 1e-9
