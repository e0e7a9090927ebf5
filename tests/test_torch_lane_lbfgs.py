"""The fused lane solve (``csrc/lane_lbfgs.cu``) and the rule that sends a
random-effect lane solve to it.

The CPU tests pin the dispatch rule of ``game.coordinate.solve_lanes``:
which solves take the kernel (``optimize.lane_lbfgs.plain_loop_reason``
returns None) and which keep the plain lane loop, and the lane counts
``re.lanes_fused`` / ``re.lanes_plain``. The ``cuda`` tests hold the
kernel to the plain loop (``GLMProblem.solve`` on the same CUDA tensors)
on the card: ``pytest -m cuda tests/test_torch_lane_lbfgs.py``. No JAX
here.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from photon_tpu_torch import obs
from photon_tpu_torch.game import (
    CSRMatrix,
    FixedEffectCoordinateConfig,
    GameData,
    GameEstimator,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.coordinate import solve_lanes
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optimize import lane_lbfgs
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.problem import (
    GLMProblem,
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import LabeledBatch, OptimizerType, TaskType

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
            reg=RegularizationType.L2, iters=10, m=10, **opt_kw):
    return GLMProblemConfig(
        task=task, optimizer=optimizer,
        optimizer_config=OptimizerConfig(max_iterations=iters, num_corrections=m,
                                         ls_max_iterations=8, **opt_kw),
        regularization=RegularizationContext(reg), regularization_weight=1.0)


def _bucket(lanes, rows, d, task=TaskType.LOGISTIC_REGRESSION, *, dtype=torch.float64,
            device="cpu", seed=0, pad_lanes=0):
    """A random-effect bucket as the coordinates hold it: an intercept and
    d − 1 features a row, each lane's active rows first, the rest zero
    rows of weight 0; the last ``pad_lanes`` lanes wholly padding (the
    mesh's and the streamed chunks' zero lanes)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(lanes, rows, d))
    x[..., 0] = 1.0
    beta = rng.normal(size=(lanes, d)) / np.sqrt(d)
    margin = (x * beta[:, None, :]).sum(-1)
    if task == TaskType.LINEAR_REGRESSION:
        labels = margin + 0.3 * rng.normal(size=margin.shape)
    elif task == TaskType.POISSON_REGRESSION:
        labels = rng.poisson(np.exp(np.clip(margin, -3.0, 3.0))).astype(np.float64)
    else:
        labels = (rng.uniform(size=margin.shape) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    active = np.arange(rows)[None, :] < rng.integers(1, rows + 1, size=(lanes, 1))
    active[lanes - pad_lanes:] = False
    x[~active] = 0.0
    weights = np.where(active, rng.uniform(0.5, 2.0, size=active.shape), 0.0)
    offsets = np.where(active, 0.1 * rng.normal(size=active.shape), 0.0)

    def t(a):
        return torch.as_tensor(a, dtype=dtype).to(device)

    return LabeledBatch(t(x), t(np.where(active, labels, 0.0)), t(offsets), t(weights))


def _genre_bucket(lanes, rows, d, *, dtype=torch.float32, device="cpu", seed=0):
    """A random-effect bucket of ``game_ctr_scale``'s kind: an intercept and
    one to three of d − 1 genre columns set to 1 a row (d = 1: the
    intercept alone), 20 to ``rows`` active rows a lane, logistic labels
    of a per-lane bias and genre affinities, unit weights, offsets of a
    fixed effect's scale."""
    rng = np.random.default_rng(seed)
    x = np.zeros((lanes, rows, d))
    x[..., 0] = 1.0
    if d > 1:
        picks = rng.integers(1, d, size=(lanes, rows, 3))
        keep = np.arange(3) < rng.integers(1, 4, size=(lanes, rows, 1))
        li, ri, k = np.nonzero(keep)
        x[li, ri, picks[li, ri, k]] = 1.0
    beta = rng.normal(scale=0.5, size=(lanes, d))
    offsets = rng.normal(scale=0.8, size=(lanes, rows))
    margin = (x * beta[:, None, :]).sum(-1) + offsets
    labels = (rng.uniform(size=margin.shape) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    active = np.arange(rows)[None, :] < rng.integers(min(20, rows), rows + 1, size=(lanes, 1))
    x[~active] = 0.0

    def t(a):
        return torch.as_tensor(np.where(active, a, 0.0) if a.ndim == 2 else a,
                               dtype=dtype).to(device)

    return LabeledBatch(t(x), t(labels), t(offsets), t(active.astype(np.float64)))


def _reason(problem, features):
    return lane_lbfgs.plain_loop_reason(problem, features)


# -- the dispatch rule, on the CPU --------------------------------------------

DISPATCH = {
    # name: (config kwargs, normalization, features shape, features dtype, want)
    "lbfgs_l2": ({}, None, (3, 5, 20), torch.float64, "on cpu"),
    "lbfgs_float32": ({}, None, (3, 5, 20), torch.float32, "on cpu"),
    "lbfgsb_without_bounds": ({"optimizer": OptimizerType.LBFGSB}, None, (3, 5, 20),
                              torch.float64, "on cpu"),
    "no_regularization": ({"reg": RegularizationType.NONE}, None, (3, 5, 20), torch.float64,
                          "on cpu"),
    "d_1": ({}, None, (3, 5, 1), torch.float64, "on cpu"),
    "at_the_caps": ({"m": 32}, None, (1, 4096, 64), torch.float32, "on cpu"),
    "owlqn": ({"optimizer": OptimizerType.OWLQN}, None, (3, 5, 20), torch.float64,
              "optimizer OWLQN"),
    "tron": ({"optimizer": OptimizerType.TRON}, None, (3, 5, 20), torch.float64,
             "optimizer TRON"),
    "l1": ({"reg": RegularizationType.L1}, None, (3, 5, 20), torch.float64,
           "regularization L1"),
    "elastic_net": ({"reg": RegularizationType.ELASTIC_NET}, None, (3, 5, 20), torch.float64,
                    "regularization ELASTIC_NET"),
    "box": ({"lower_bounds": np.zeros(20)}, None, (3, 5, 20), torch.float64, "box bounds"),
    "upper_box": ({"upper_bounds": np.ones(20)}, None, (3, 5, 20), torch.float64,
                  "box bounds"),
    "factors": ({}, "factors", (3, 5, 20), torch.float64, "normalization"),
    "shifts": ({}, "shifts", (3, 5, 20), torch.float64, "normalization"),
    "d_above_cap": ({}, None, (3, 5, 65), torch.float64, "d 65 outside 1..64"),
    "m_above_cap": ({"m": 33}, None, (3, 5, 20), torch.float64,
                    "num_corrections 33 outside 1..32"),
    "rows_above_cap": ({}, None, (1, 4097, 2), torch.float32, "rows 4097 > 4096"),
    "bfloat16": ({}, None, (3, 5, 20), torch.bfloat16, "features torch.bfloat16"),
    "float16": ({}, None, (3, 5, 20), torch.float16, "features torch.float16"),
    "no_lane_axis": ({}, None, (5, 20), torch.float64,
                     "features not a dense [lanes, rows, d] block"),
}


@pytest.mark.parametrize("name", list(DISPATCH))
def test_the_dispatch_rule(name):
    """Only the device keeps an eligible solve off the kernel here; every
    other solve names what keeps it on the plain loop, wherever it runs."""
    kw, norm, shape, dtype, want = DISPATCH[name]
    normalization = NormalizationContext()
    if norm == "factors":
        normalization = NormalizationContext(factors=torch.full((shape[-1],), 2.0,
                                                                dtype=torch.float64))
    elif norm == "shifts":
        shifts = torch.full((shape[-1],), 0.5, dtype=torch.float64)
        shifts[0] = 0.0
        normalization = NormalizationContext(shifts=shifts, intercept_index=0)
    problem = GLMProblem.build(_config(**kw), normalization)
    assert _reason(problem, torch.zeros(shape, dtype=dtype)) == want


@pytest.mark.parametrize("mode,want", [("full", "full line search"), (" FULL ", "full line search"),
                                       ("margin", "on cpu")])
def test_the_line_search_switch(monkeypatch, mode, want):
    monkeypatch.setenv("PHOTON_GLM_LINESEARCH", mode)
    assert _reason(GLMProblem.build(_config()), torch.zeros((3, 5, 20))) == want


def test_a_sparse_block_keeps_the_plain_loop():
    dense = torch.zeros((3, 5, 20))
    assert _reason(GLMProblem.build(_config()), dense.to_sparse()) == \
        "features not a dense [lanes, rows, d] block"


@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.name)
def test_solve_lanes_on_the_cpu_is_the_plain_loop_and_counts_its_lanes(task):
    """On the CPU every lane solve runs the plain loop, bit for bit what
    ``GLMProblem.solve`` gives, and its lanes count as plain, telemetry
    off as on."""
    b = _bucket(7, 9, 4, task, seed=3, pad_lanes=2)
    w0 = torch.zeros((7, 4), dtype=torch.float64)
    cfg = _config(task)
    launches = cuda_build.launch_count("lane_lbfgs")
    got = solve_lanes(cfg, *b, w0)
    want = GLMProblem.build(cfg).solve(b, w0)
    for f in FIELDS:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    obs.enable()
    try:
        solve_lanes(cfg, *b, w0)
    finally:
        obs.disable()
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["re.lanes_plain"] == 14 and "re.lanes_fused" not in counters
    assert cuda_build.launch_count("lane_lbfgs") == launches


@pytest.mark.parametrize("reg,reason", [(RegularizationType.L2, "on cpu"),
                                        (RegularizationType.L1, "regularization L1")])
def test_a_cpu_lane_solve_lands_in_the_route_record(reg, reason):
    """Each lane of a CPU lane solve is recorded under ("lanes", "cpu",
    its plain reason) in the process-lifetime route record, which an
    ``obs.reset()`` between two solves leaves counting both; the registry
    tally still counts each solve's lanes from the reset on."""
    b = _bucket(5, 6, 3, seed=7)
    w0 = torch.zeros((5, 3), dtype=torch.float64)
    key = ("lanes", "cpu", reason)
    before = lane_lbfgs.routes[key]
    solve_lanes(_config(reg=reg), *b, w0)
    assert obs.get_registry().snapshot()["counters"]["re.lanes_plain"] == 5
    obs.reset()
    solve_lanes(_config(reg=reg), *b, w0)
    assert lane_lbfgs.routes[key] - before == 10
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["re.lanes_plain"] == 5 and "re.lanes_fused" not in counters


def test_the_wrapper_raises_before_the_card():
    """The wrapper refuses, with the dispatch rule's reason, every solve
    the rule keeps on the plain loop: a wrong type, rank or device, and a
    problem the kernel does not compute (L1)."""
    b = _bucket(2, 3, 2)
    w0 = torch.zeros((2, 2), dtype=torch.float64)
    problem = GLMProblem.build(_config())
    with pytest.raises(ValueError, match="does not take this solve: on cpu"):
        lane_lbfgs.minimize_lanes(problem, b, w0)
    with pytest.raises(ValueError, match="features torch.float16"):
        lane_lbfgs.minimize_lanes(problem, b._replace(features=b.features.half()), w0)
    with pytest.raises(ValueError, match=r"\[lanes, rows, d\]"):
        lane_lbfgs.minimize_lanes(problem, b._replace(features=b.features[0]), w0)
    with pytest.raises(ValueError, match="regularization L1"):
        lane_lbfgs.minimize_lanes(GLMProblem.build(_config(reg=RegularizationType.L1)), b, w0)


def _game_data(seed=0, n=600, users=12, items=5, fe_dim=16):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, fe_dim, size=(n, 3))
    user = rng.integers(0, users, size=n)
    item = rng.integers(0, items, size=n)
    margin = rng.normal(size=fe_dim)[cols].sum(1) * 0.3 + rng.normal(size=users)[user]
    labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    shards = {"global": CSRMatrix(indptr=np.arange(n + 1) * 3, indices=cols.ravel(),
                                  values=np.ones(3 * n), num_cols=fe_dim)}
    for name, d in (("user", 3), ("item", 1)):
        x = np.concatenate([np.ones((n, 1)), rng.normal(size=(n, d - 1))], axis=1)
        shards[f"per_{name}"] = CSRMatrix.from_dense(x)
    tags = {"user": [f"u{i}" for i in user], "item": [f"i{i}" for i in item]}
    return GameData.build(labels=labels, feature_shards=shards, id_tags=tags)


def _estimator(device="cpu", dtype=torch.float64):
    l2 = RegularizationContext(RegularizationType.L2)

    def opt(iters):
        return GLMProblemConfig(optimizer_config=OptimizerConfig(max_iterations=iters,
                                                                 ls_max_iterations=8),
                                regularization=l2)

    cfgs = {"fixed": FixedEffectCoordinateConfig(feature_shard="global", optimization=opt(5),
                                                 regularization_weights=(1.0,))}
    for name, ub in (("user", 40), ("item", 200)):
        cfgs[name] = RandomEffectCoordinateConfig(
            random_effect_type=name, feature_shard=f"per_{name}", optimization=opt(4),
            regularization_weights=(1.0,), active_data_upper_bound=ub)
    return GameEstimator(task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=cfgs,
                         update_sequence=["fixed", "user", "item"], descent_iterations=2,
                         dtype=dtype, seed=1, device=device, keep_coordinates=True)


def test_a_fit_on_the_cpu_counts_every_lane_as_plain():
    coords = _estimator()._build_coordinates(_game_data())
    lanes = sum(db.features.shape[0] for c in ("user", "item")
                for db in coords[c].device_buckets)
    run_coordinate_descent(coords, ["fixed", "user", "item"], 2)
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["re.lanes_plain"] == 2 * lanes and "re.lanes_fused" not in counters


# -- on the card ---------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the chip: pytest -m cuda")
    return torch.device("cuda")


def _lane_rel(a, b):
    """Per-lane ‖a − b‖ / ‖b‖ (0 where both are 0)."""
    num = torch.linalg.vector_norm(a - b, dim=-1)
    den = torch.linalg.vector_norm(b, dim=-1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), num)


def _cpu(res):
    return {f: getattr(res, f).cpu() for f in FIELDS}


@pytest.mark.cuda
@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.name)
@pytest.mark.parametrize("d,rows,iters", [(1, 300, 10), (20, 37, 10), (32, 70, 10),
                                          (20, 37, 1)])
def test_the_kernel_matches_the_plain_loop_at_float64(task, d, rows, iters):
    """Decision for decision: the same iterations, stopping reasons,
    trials and feature passes in every lane, x within 1e-9 of the plain
    loop's, per lane. Rows not a multiple of the block (300 rows take 256
    threads, two rows to some), zero-weight padding lanes, and the
    one-iteration cap of the warm-up."""
    dev = _card()
    b = _bucket(64, rows, d, task, device=dev, seed=d + rows, pad_lanes=5)
    w0 = torch.zeros((64, d), dtype=torch.float64, device=dev)
    problem = GLMProblem.build(_config(task, iters=iters))
    got = _cpu(lane_lbfgs.minimize_lanes(problem, b, w0))
    want = _cpu(problem.solve(b, w0))
    for f in COUNTS:
        assert torch.equal(got[f], want[f]), (f, got[f], want[f])
    assert (got["iterations"] >= 1).all() and (got["reason"] > 0).all()
    assert float(_lane_rel(got["x"], want["x"]).max()) <= 1e-9
    torch.testing.assert_close(got["value"], want["value"], rtol=1e-9, atol=1e-12)
    torch.testing.assert_close(got["loss_history"], want["loss_history"], rtol=1e-9, atol=1e-12)
    scale = 1.0 + torch.linalg.vector_norm(want["gradient"], dim=-1, keepdim=True)
    assert float(((got["gradient"] - want["gradient"]).abs() / scale).max()) <= 1e-9
    torch.testing.assert_close(got["grad_norm_history"], want["grad_norm_history"],
                               rtol=1e-8, atol=1e-10)
    # the padding lanes train to zero at once
    assert torch.equal(got["x"][-5:], torch.zeros(5, d, dtype=torch.float64))


@pytest.mark.cuda
@pytest.mark.parametrize("task", TASKS, ids=lambda t: t.name)
def test_the_kernel_at_float32_reaches_the_optimum_as_its_stopping_test_allows(task):
    """At float32 the kernel and the plain loop sum in other orders (the
    plain loop's float32 reductions, the kernel's float64 ones) and the
    convergence test stops a lane once an iteration gains less than
    tol·|f(0)| (tol 1e-7), near float32's rounding floor, so the two may
    stop an iteration apart and are not compared lane for lane. Each lane
    of the kernel is held, solved to convergence, against the exact
    optimum x* (the plain loop at float64 with tol 1e-12), objectives in
    float64: the gap f(x) − f(x*) within 100·tol·(1 + |f(0)|), and
    ‖x − x*‖² within what λ-strong convexity allows for that gap,
    2·gap/λ (λ = 1)."""
    dev = _card()
    b = _bucket(256, 45, 20, task, dtype=torch.float32, device=dev, seed=11, pad_lanes=3)
    w0 = torch.zeros((256, 20), dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config(task, iters=100))
    got = lane_lbfgs.minimize_lanes(problem, b, w0)
    b64 = LabeledBatch(*(t.double() for t in b))
    exact = GLMProblem.build(_config(task, iters=300, tolerance=1e-12)).solve(b64, w0.double())
    f = problem.objective.value

    f_zero = f(w0.double(), b64)
    gap = f(got.x.double(), b64) - f(exact.x, b64)
    assert float((gap / (1.0 + f_zero.abs())).max()) <= 100 * 1e-7
    dist2 = torch.linalg.vector_norm(got.x.double() - exact.x, dim=-1) ** 2
    assert bool((dist2 <= 2.0 * gap.clamp(min=0.0) * 1.01 + 1e-12).all())
    assert torch.equal(got.x[-3:].cpu(), torch.zeros(3, 20))


#: (f_kernel − f_plain) / (1 + |f_plain|) per lane at float32, read in
#: float64: 10·tol. Both stop a converged lane where an iteration gains under
#: tol·|f(0)|, near float32's rounding, each as often the lower (on an H100
#: the cell's own buckets read at most 1.3e-7 each way); one iteration short
#: reads medians of 2e-4 to 6e-3 on the user buckets
F32_OBJECTIVE_MARGIN = 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("lanes,rows,d", [(1024, 256, 20), (1024, 256, 32), (783, 1024, 1),
                                          (783, 1024, 8)])
def test_the_kernel_at_float32_is_no_worse_than_the_plain_loop_at_the_cells_cap(lanes, rows, d):
    """At the benchmark cell's bucket shapes (users: d 20, padded to 32,
    at most 256 rows; movies: d 1, padded to 8, at most 1,024 rows) and
    its solve (logistic, L2 λ = 1, 5 iterations, 8 trials), every lane's
    objective at the kernel's float32 x, read in float64, is at most the
    plain loop's plus F32_OBJECTIVE_MARGIN·(1 + |f|), and the kernel's
    largest distance of a lane from the float64 solve is at most twice
    the plain loop's own at float32 (the kernel sums in float64; the
    cell's movie buckets read up to 1.33 times, the rest at most once)."""
    dev = _card()
    b = _genre_bucket(lanes, rows, d, device=dev, seed=rows + d)
    w0 = torch.zeros((lanes, d), dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config(iters=5))
    got = lane_lbfgs.minimize_lanes(problem, b, w0)
    plain = problem.solve(b, w0)
    b64 = LabeledBatch(*(t.double() for t in b))
    exact = problem.solve(b64, w0.double())
    f = problem.objective.value
    f_plain = f(plain.x.double(), b64)
    excess = (f(got.x.double(), b64) - f_plain) / (1.0 + f_plain.abs())
    assert float(excess.max()) <= F32_OBJECTIVE_MARGIN
    assert float(_lane_rel(got.x.double(), exact.x).max()) <= \
        2.0 * float(_lane_rel(plain.x.double(), exact.x).max())


@pytest.mark.cuda
def test_a_lane_alone_equals_the_lane_in_a_bucket_of_1000():
    """Bit for bit, every field: a lane's result depends neither on the
    other lanes nor on their number (ROADMAP C7: a streamed chunk of a
    bucket gives the bucket's own lanes), and a second call repeats the
    first."""
    dev = _card()
    b = _bucket(1000, 64, 20, dtype=torch.float32, device=dev, seed=5, pad_lanes=8)
    w0 = torch.zeros((1000, 20), dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config(iters=20))
    whole = _cpu(lane_lbfgs.minimize_lanes(problem, b, w0))
    again = _cpu(lane_lbfgs.minimize_lanes(problem, b, w0))
    for f in FIELDS:
        assert torch.equal(whole[f], again[f]), f
    for i in (0, 517, 998):
        alone = _cpu(lane_lbfgs.minimize_lanes(problem, LabeledBatch(*(t[i:i + 1] for t in b)),
                                               w0[i:i + 1]))
        for f in FIELDS:
            assert torch.equal(alone[f][0], whole[f][i]), (i, f)
    cfg = _config(iters=20)
    chunks = [solve_lanes(cfg, *(t[lo:hi] for t in b), w0[lo:hi])
              for lo, hi in ((0, 300), (300, 701), (701, 1000))]
    for f in FIELDS:
        assert torch.equal(torch.cat([getattr(c, f).cpu() for c in chunks]), whole[f]), f


@pytest.mark.cuda
def test_the_wrapper_raises_on_what_the_kernel_does_not_take():
    dev = _card()
    b = _bucket(4, 6, 3, dtype=torch.float32, device=dev)
    w0 = torch.zeros((4, 3), dtype=torch.float32, device=dev)
    problem = GLMProblem.build(_config())
    with pytest.raises(TypeError, match="labels must be torch.float32"):
        lane_lbfgs.minimize_lanes(problem, b._replace(labels=b.labels.double()), w0)
    with pytest.raises(ValueError, match="features torch.float16"):
        lane_lbfgs.minimize_lanes(problem, b._replace(features=b.features.half()), w0)
    with pytest.raises(ValueError, match="weights has shape"):
        lane_lbfgs.minimize_lanes(problem, b._replace(weights=b.weights[:, :5]), w0)
    with pytest.raises(ValueError, match="w0 has shape"):
        lane_lbfgs.minimize_lanes(problem, b, w0[:3])
    with pytest.raises(ValueError, match="w0 is on cpu"):
        lane_lbfgs.minimize_lanes(problem, b, w0.cpu())
    with pytest.raises(ValueError, match="must be contiguous"):
        lane_lbfgs.minimize_lanes(problem, b._replace(offsets=b.offsets.t().contiguous().t()),
                                  w0)
    with pytest.raises(ValueError, match="num_corrections 33 outside 1..32"):
        lane_lbfgs.minimize_lanes(GLMProblem.build(_config(m=33)), b, w0)


@pytest.mark.cuda
def test_a_fit_on_the_card_takes_the_kernel_for_every_lane(monkeypatch):
    """Every random-effect lane of a GAME fit on the card goes through the
    kernel, one launch a bucket and a sweep, and the fit's tables equal
    the plain loop's on the card within 1e-9 at float64."""
    dev = _card()
    data = _game_data(seed=2)
    coords = _estimator(device=dev)._build_coordinates(data)
    lanes = sum(db.features.shape[0] for c in ("user", "item")
                for db in coords[c].device_buckets)
    buckets = sum(len(coords[c].device_buckets) for c in ("user", "item"))
    launches = cuda_build.launch_count("lane_lbfgs")
    got = run_coordinate_descent(coords, ["fixed", "user", "item"], 2)
    assert cuda_build.launch_count("lane_lbfgs") - launches == 2 * buckets
    counters = obs.get_registry().snapshot()["counters"]
    assert counters["re.lanes_fused"] == 2 * lanes and "re.lanes_plain" not in counters
    monkeypatch.setattr(lane_lbfgs, "plain_loop_reason", lambda problem, features: "forced")
    want = run_coordinate_descent(coords, ["fixed", "user", "item"], 2)
    for c in ("user", "item"):
        for a, w in zip(got.states[c], want.states[c]):
            assert float(_lane_rel(a, w).max()) <= 1e-9
    rel = torch.linalg.vector_norm(got.total - want.total) / torch.linalg.vector_norm(want.total)
    assert float(rel) <= 1e-9
