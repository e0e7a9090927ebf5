"""Port parity: TRON, OWL-QN and L-BFGS-B against photon_tpu/optimize.

The same seeded problems (ridge, logistic and Poisson with L2; elastic net
for OWL-QN) go through the JAX optimizer and the port's at float64: x
within rtol 1e-8 with equal iterations, stop reason and work counters
(n_evals, n_hvp, n_feature_passes). A lane batch of 5 problems equals 5
solo solves and ``jax.vmap`` of the JAX solve.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.ops import losses as jl
from photon_tpu.ops.objective import GLMObjective as JObjective
from photon_tpu.optimize.common import OptimizerConfig as JConfig
from photon_tpu.optimize.lbfgs import minimize_lbfgs as jlbfgs
from photon_tpu.optimize.owlqn import minimize_owlqn as jowlqn
from photon_tpu.optimize.owlqn import pseudo_gradient as jpseudo
from photon_tpu.optimize.tron import minimize_tron as jtron
from photon_tpu.types import LabeledBatch as JDense
from photon_tpu.types import SparseBatch as JSparse
from photon_tpu_torch.ops import losses as tl
from photon_tpu_torch.ops.objective import GLMObjective as TObjective
from photon_tpu_torch.ops.sparse_windows import build_column_windows as tbuild
from photon_tpu_torch.optimize.common import OptimizerConfig as TConfig
from photon_tpu_torch.optimize.lbfgs import minimize_lbfgs as tlbfgs
from photon_tpu_torch.optimize.owlqn import minimize_owlqn as towlqn
from photon_tpu_torch.optimize.owlqn import pseudo_gradient as tpseudo
from photon_tpu_torch.optimize.tron import minimize_tron as ttron
from photon_tpu_torch.types import LabeledBatch as TDense
from photon_tpu_torch.types import SparseBatch as TSparse

N, D, K = 200, 12, 5
LOSS = {"ridge": "SquaredLoss", "logistic": "LogisticLoss", "poisson": "PoissonLoss"}
COUNTERS = ("iterations", "reason", "n_evals", "n_hvp", "n_feature_passes")


def _arrays(kind, seed, lanes=None):
    """x [.., N, D] with an intercept column, labels drawn from a GLM of
    ``kind``, offsets 0 and weights in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    shape = (N,) if lanes is None else (lanes, N)
    x = rng.standard_normal(shape + (D,))
    x[..., 0] = 1.0
    z = x @ (0.4 * rng.standard_normal(D))
    if kind == "ridge":
        y = z + 0.1 * rng.standard_normal(shape)
    elif kind == "logistic":
        y = (rng.uniform(size=shape) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    else:
        y = rng.poisson(np.exp(0.5 * z)).astype(np.float64)
    return x, y, np.zeros(shape), rng.uniform(0.5, 1.5, size=shape)


def _batches(arrays):
    return JDense(*map(jnp.asarray, arrays)), TDense(*map(torch.as_tensor, arrays))


def _sparse_batches(kind, seed):
    """ELL batches of the same model: JAX without windows (segment_sum),
    the port with the window layout (the plain windowed Xᵀr)."""
    rng = np.random.default_rng(seed)
    idx = rng.integers(1, 4 * D, size=(N, K)).astype(np.int32)
    idx[:, 0] = 0
    val = rng.standard_normal((N, K)) / np.sqrt(K)
    val[:, 0] = 1.0
    z = (val * (0.4 * rng.standard_normal(4 * D))[idx]).sum(1)
    y = (
        rng.poisson(np.exp(0.5 * z)).astype(np.float64)
        if kind == "poisson"
        else (rng.uniform(size=N) < 1.0 / (1.0 + np.exp(-z))).astype(np.float64)
    )
    cols = (y, np.zeros(N), np.ones(N))
    win = tbuild(idx, val, 4 * D, window=16, instance_cap=64, chunk=16, dtype=torch.float64)
    jb = JSparse(jnp.asarray(idx), jnp.asarray(val), *map(jnp.asarray, cols))
    tb = TSparse(torch.as_tensor(idx), torch.as_tensor(val), *map(torch.as_tensor, cols), win)
    return jb, tb, 4 * D


def _objectives(kind, l2=1.0, l1=0.0):
    loss = LOSS[kind]
    return (
        JObjective(loss=getattr(jl, loss), l2_weight=l2, l1_weight=l1),
        TObjective(loss=getattr(tl, loss), l2_weight=l2, l1_weight=l1),
    )


def _same(tres, jres, rtol=1e-8):
    for name in COUNTERS:
        np.testing.assert_array_equal(
            np.asarray(getattr(tres, name)), np.asarray(getattr(jres, name)), err_msg=name
        )
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=rtol, atol=1e-12)
    np.testing.assert_allclose(
        tres.value.numpy(), np.asarray(jres.value), rtol=rtol, atol=1e-12
    )
    np.testing.assert_allclose(
        tres.loss_history.numpy(), np.asarray(jres.loss_history), rtol=rtol, atol=1e-12
    )


def _zeros(d, lanes=None):
    shape = (d,) if lanes is None else (lanes, d)
    return jnp.zeros(shape), torch.zeros(shape, dtype=torch.float64)


def _tron(jo, to, jb, tb, d, jcfg=None, tcfg=None):
    jx0, tx0 = _zeros(d)
    jres = jtron(
        lambda w: jo.value_and_gradient(w, jb), None, jx0, jcfg,
        hvp_factory=lambda w: jo.hessian_operator(w, jb),
    )
    tres = ttron(
        lambda w: to.value_and_gradient(w, tb), None, tx0, tcfg,
        hvp_factory=lambda w: to.hessian_operator(w, tb),
    )
    return jres, tres


@pytest.mark.parametrize("kind", ["ridge", "logistic", "poisson"])
def test_tron_matches_jax(kind):
    jb, tb = _batches(_arrays(kind, 0))
    jres, tres = _tron(*_objectives(kind), jb, tb, D)
    _same(tres, jres)
    assert int(tres.n_hvp) > int(tres.iterations)  # CG ran more than one step


@pytest.mark.parametrize("kind", ["logistic", "poisson"])
def test_tron_sparse_windows_matches_jax(kind):
    jb, tb, d = _sparse_batches(kind, 1)
    _same(*reversed(_tron(*_objectives(kind), jb, tb, d)))


def test_tron_box_and_black_box_hvp_match_jax():
    """Bounds project every candidate; a black-box hvp(x, v) counts no
    feature passes (0 = not tracked), in both packages."""
    jb, tb = _batches(_arrays("logistic", 2))
    jo, to = _objectives("logistic")
    lo, hi = np.full(D, -np.inf), np.full(D, np.inf)
    lo[1:4], hi[4:7] = -0.05, 0.05
    jx0, tx0 = _zeros(D)
    jres = jtron(
        lambda w: jo.value_and_gradient(w, jb), lambda w, v: jo.hessian_vector(w, v, jb),
        jx0, JConfig(lower_bounds=lo, upper_bounds=hi).tron_defaults(),
    )
    tres = ttron(
        lambda w: to.value_and_gradient(w, tb), lambda w, v: to.hessian_vector(w, v, tb),
        tx0, TConfig(lower_bounds=lo, upper_bounds=hi).tron_defaults(),
    )
    _same(tres, jres)
    assert int(tres.n_feature_passes) == 0
    x = tres.x.numpy()
    assert np.all(x >= lo) and np.all(x <= hi)


# (kind, seed) pairs where the projected iteration converges before its
# iteration cap; see test_lbfgsb_stalled_case_agrees_in_objective
LBFGSB_CASES = [("ridge", 1), ("logistic", 2), ("poisson", 1)]


def _box(tight=True):
    """Bounds on a few coefficients, the others free."""
    lo, hi = np.full(D, -np.inf), np.full(D, np.inf)
    if tight:
        lo[1:4], hi[4:7] = -0.05, 0.05
    else:
        lo[1], hi[4] = -0.05, 0.05
    return lo, hi


def _lbfgsb(kind, seed, margin, lanes=None):
    arrays = _arrays(kind, seed, lanes)
    jb, tb = _batches(arrays)
    jo, to = _objectives(kind)
    lo, hi = _box()
    jcfg, tcfg = JConfig(lower_bounds=lo, upper_bounds=hi), TConfig(lower_bounds=lo, upper_bounds=hi)
    jx0, tx0 = _zeros(D)
    if margin:
        jres = jlbfgs(None, jx0, jcfg, oracle=jo.directional_oracle(jb))
        tres = tlbfgs(None, tx0, tcfg, oracle=to.directional_oracle(tb))
    else:
        jres = jlbfgs(lambda w: jo.value_and_gradient(w, jb), jx0, jcfg)
        tres = tlbfgs(lambda w: to.value_and_gradient(w, tb), tx0, tcfg)
    return jres, tres


@pytest.mark.parametrize("margin", [True, False], ids=["margin", "black-box"])
@pytest.mark.parametrize("kind,seed", LBFGSB_CASES)
def test_lbfgsb_matches_jax(kind, seed, margin):
    jres, tres = _lbfgsb(kind, seed, margin)
    _same(tres, jres)
    lo, hi = _box()
    x = tres.x.numpy()
    assert np.all(x >= lo) and np.all(x <= hi)
    assert np.any(x == lo) or np.any(x == hi)  # a bound is active


def test_lbfgsb_stalled_case_agrees_in_objective():
    """Projection after an L-BFGS step can stall: on this ridge problem the
    objective rises after iteration 1 (44.41 → ~44.8: the Armijo test holds
    for the unprojected point, not the projected one) and both packages run
    to the 100-iteration cap with equal counters. Roundoff grows over the
    stalled iterations: the histories agree to 1e-13 for 9 iterations and
    the final objectives to ~3e-3 (ROADMAP C)."""
    jres, tres = _lbfgsb("ridge", 2, True)
    assert int(tres.reason) == int(jres.reason) == 1
    for name in COUNTERS:
        assert int(getattr(tres, name)) == int(getattr(jres, name)), name
    np.testing.assert_allclose(
        tres.loss_history.numpy()[:10], np.asarray(jres.loss_history)[:10], rtol=1e-13
    )
    assert float(tres.value) > float(tres.loss_history.min())  # the rise
    np.testing.assert_allclose(float(tres.value), float(jres.value), rtol=1e-2)


OWLQN_CASES = [("ridge", 1), ("logistic", 0), ("poisson", 1)]
L1 = 15.0


def _owlqn(kind, seed, margin, lanes=None, cfg=None):
    jb, tb = _batches(_arrays(kind, seed, lanes))
    jo, to = _objectives(kind, l2=0.5, l1=L1)
    jx0, tx0 = _zeros(D)
    jcfg, tcfg = cfg if cfg is not None else (JConfig(), TConfig())
    if margin:
        jres = jowlqn(None, jx0, L1, jcfg, oracle=jo.smooth_margin_oracle(jb))
        tres = towlqn(None, tx0, L1, tcfg, oracle=to.smooth_margin_oracle(tb))
    else:
        jres = jowlqn(lambda w: jo.value_and_gradient(w, jb), jx0, L1, jcfg)
        tres = towlqn(lambda w: to.value_and_gradient(w, tb), tx0, L1, tcfg)
    return jres, tres


@pytest.mark.parametrize("margin", [True, False], ids=["margin-oracle", "black-box"])
@pytest.mark.parametrize("kind,seed", OWLQN_CASES)
def test_owlqn_matches_jax(kind, seed, margin):
    jres, tres = _owlqn(kind, seed, margin)
    _same(tres, jres)
    zeros = tres.x.numpy() == 0.0
    assert zeros.any() and not zeros.all()
    np.testing.assert_array_equal(zeros, np.asarray(jres.x) == 0.0)
    np.testing.assert_allclose(
        tres.gradient.numpy(), np.asarray(jres.gradient), rtol=1e-8, atol=1e-10
    )


@pytest.mark.parametrize("margin", [True, False], ids=["margin-oracle", "black-box"])
def test_owlqn_box_matches_jax(margin):
    lo, hi = _box()
    cfg = (JConfig(lower_bounds=lo, upper_bounds=hi), TConfig(lower_bounds=lo, upper_bounds=hi))
    jres, tres = _owlqn("logistic", 0, margin, cfg=cfg)
    _same(tres, jres)
    x = tres.x.numpy()
    assert np.all(x >= lo) and np.all(x <= hi)


def test_owlqn_sparse_windows_matches_jax():
    jb, tb, d = _sparse_batches("poisson", 3)
    jo, to = _objectives("poisson", l2=0.05, l1=2.0)
    jx0, tx0 = _zeros(d)
    jres = jowlqn(None, jx0, 2.0, JConfig(), oracle=jo.smooth_margin_oracle(jb))
    tres = towlqn(None, tx0, 2.0, TConfig(), oracle=to.smooth_margin_oracle(tb))
    _same(tres, jres)
    assert (tres.x.numpy() == 0.0).any()


def test_pseudo_gradient_equal_elementwise():
    rng = np.random.default_rng(5)
    x = rng.standard_normal(400)
    x[rng.uniform(size=400) < 0.4] = 0.0
    g = 2.0 * rng.standard_normal(400)
    g[:8] = [1.0, -1.0, 0.5, -0.5, 1.5, -1.5, 0.0, 1.0]  # |g| =, <, > l1 at 0
    x[:8] = 0.0
    for l1 in (0.0, 1.0):
        want = np.asarray(jpseudo(jnp.asarray(x), jnp.asarray(g), jnp.asarray(l1)))
        got = tpseudo(torch.as_tensor(x), torch.as_tensor(g), l1).numpy()
        np.testing.assert_array_equal(got, want)


# --- lanes --------------------------------------------------------------------

LANES = 5


def _lane_objectives(name):
    if name == "tron":
        return _objectives("poisson")
    if name == "owlqn":
        return _objectives("logistic", l2=0.5, l1=L1)
    return _objectives("logistic")


def _lane_solves(name, arrays):
    """(port lane batch, port solo solves, jax.vmap of the JAX solve)."""
    jo, to = _lane_objectives(name)
    lo, hi = _box(tight=False)

    def torch_solve(tb, x0):
        if name == "tron":
            return ttron(
                lambda w: to.value_and_gradient(w, tb), None, x0,
                hvp_factory=lambda w: to.hessian_operator(w, tb),
            )
        if name == "owlqn":
            return towlqn(None, x0, L1, TConfig(), oracle=to.smooth_margin_oracle(tb))
        return tlbfgs(
            None, x0, TConfig(lower_bounds=lo, upper_bounds=hi),
            oracle=to.directional_oracle(tb),
        )

    def jax_solve(x, y, o, w):
        jb = JDense(x, y, o, w)
        x0 = jnp.zeros(D)
        if name == "tron":
            return jtron(
                lambda v: jo.value_and_gradient(v, jb), None, x0,
                hvp_factory=lambda v: jo.hessian_operator(v, jb),
            )
        if name == "owlqn":
            return jowlqn(None, x0, L1, JConfig(), oracle=jo.smooth_margin_oracle(jb))
        return jlbfgs(
            None, x0, JConfig(lower_bounds=lo, upper_bounds=hi),
            oracle=jo.directional_oracle(jb),
        )

    tb = TDense(*map(torch.as_tensor, arrays))
    batched = torch_solve(tb, torch.zeros((LANES, D), dtype=torch.float64))
    solo = [
        torch_solve(TDense(*(torch.as_tensor(a[i]) for a in arrays)), torch.zeros(D, dtype=torch.float64))
        for i in range(LANES)
    ]
    vmapped = jax.vmap(jax_solve)(*map(jnp.asarray, arrays))
    return batched, solo, vmapped


@pytest.mark.parametrize(
    "name,kind,seed", [("tron", "poisson", 7), ("owlqn", "logistic", 7), ("lbfgsb", "logistic", 2)]
)
def test_lane_batch_equals_solo_solves_and_vmap(name, kind, seed):
    arrays = _arrays(kind, seed, lanes=LANES)
    batched, solo, vmapped = _lane_solves(name, arrays)
    iters = batched.iterations.numpy()
    assert len(set(iters.tolist())) > 1  # lanes stop at different iterations
    if name == "lbfgsb":
        lo, hi = _box(tight=False)
        assert bool((batched.x[:, 1] == lo[1]).any() or (batched.x[:, 4] == hi[4]).any())
    for i, s in enumerate(solo):
        for name_ in COUNTERS:
            assert int(getattr(batched, name_)[i]) == int(getattr(s, name_)), (i, name_)
        np.testing.assert_allclose(batched.x[i].numpy(), s.x.numpy(), rtol=1e-12, atol=1e-14)
    for name_ in COUNTERS:
        np.testing.assert_array_equal(
            np.asarray(getattr(batched, name_)), np.asarray(getattr(vmapped, name_)), err_msg=name_
        )
    np.testing.assert_allclose(batched.x.numpy(), np.asarray(vmapped.x), rtol=1e-8, atol=1e-12)


# ---------------------------------------------------------------------------
# SegmentedOWLQN and PHOTON_GLM_LINESEARCH=full
# ---------------------------------------------------------------------------


def _assert_bit_equal(a, b):
    for name, u, v in zip(a._fields, a, b):
        assert torch.equal(u, v), name


def test_segmented_owlqn_matches_single_program():
    """SegmentedOWLQN runs minimize_owlqn's pieces in segments of 2
    iterations: the same result bit for bit (one device, no reordering),
    actually segmented, converged by the same criteria; a second call from
    another start runs afresh."""
    from photon_tpu_torch.optimize.common import ConvergenceReason
    from photon_tpu_torch.optimize.owlqn import SegmentedOWLQN

    rng = np.random.default_rng(11)
    a = torch.as_tensor(rng.standard_normal((200, D)))
    b = torch.as_tensor(rng.standard_normal(200))

    def vg(x):
        r = a @ x - b
        return 0.5 * (r * r).sum(), a.T @ r

    cfg = TConfig(max_iterations=60, tolerance=1e-9)
    ref = towlqn(vg, torch.zeros(D, dtype=torch.float64), 0.3, cfg)
    solver = SegmentedOWLQN(vg, 0.3, cfg, segment_iters=2)
    seg = solver(torch.zeros(D, dtype=torch.float64))
    assert solver.last_num_segments >= 2
    assert solver.last_num_segments == -(-int(ref.iterations) // 2)
    assert int(seg.reason) != int(ConvergenceReason.NOT_CONVERGED)
    _assert_bit_equal(seg, ref)
    x1 = torch.full((D,), 0.05, dtype=torch.float64)
    _assert_bit_equal(solver(x1), towlqn(vg, x1, 0.3, cfg))
    with pytest.raises(ValueError, match="segment_iters"):
        SegmentedOWLQN(vg, 0.3, cfg, segment_iters=0)


@pytest.mark.parametrize("layout", ["dense", "lanes", "windows"])
def test_segmented_owlqn_oracle_factory_data_as_argument(layout):
    """The batch flows in through ``__call__(x0, data)`` and the margin
    oracle is built from it: bit for bit the monolithic margin-oracle solve
    on the same GLM problem (one lane, a lane batch, the window layout)."""
    from photon_tpu_torch.optimize.owlqn import SegmentedOWLQN

    if layout == "windows":
        _, batch, d = _sparse_batches("poisson", 3)
        _, obj = _objectives("poisson", l2=0.05, l1=2.0)
        l1, x0 = 2.0, torch.zeros(d, dtype=torch.float64)
    else:
        lanes = 3 if layout == "lanes" else None
        _, batch = _batches(_arrays("logistic", 12, lanes))
        _, obj = _objectives("logistic", l2=0.5, l1=0.1)
        l1, x0 = 0.1, _zeros(D, lanes)[1]
    cfg = TConfig(max_iterations=40, tolerance=1e-8)
    ref = towlqn(None, x0, l1, cfg, oracle=obj.smooth_margin_oracle(batch))
    solver = SegmentedOWLQN(None, l1, cfg, oracle_factory=obj.smooth_margin_oracle,
                            segment_iters=4)
    _assert_bit_equal(solver(x0, batch), ref)
    assert solver.last_num_segments >= 2


def _problem_pair(optimizer, reg):
    from photon_tpu.optimize.problem import GLMProblem as JProblem
    from photon_tpu.optimize.problem import GLMProblemConfig as JPConfig
    from photon_tpu.optimize.problem import RegularizationContext as JReg
    from photon_tpu.optimize.problem import RegularizationType as JRegType
    from photon_tpu.types import OptimizerType as JOpt
    from photon_tpu.types import TaskType as JTask
    from photon_tpu_torch.optimize.problem import GLMProblem as TProblem
    from photon_tpu_torch.optimize.problem import GLMProblemConfig as TPConfig
    from photon_tpu_torch.optimize.problem import RegularizationContext as TReg
    from photon_tpu_torch.optimize.problem import RegularizationType as TRegType
    from photon_tpu_torch.types import OptimizerType as TOpt
    from photon_tpu_torch.types import TaskType as TTask

    lo, hi = _box(tight=False) if optimizer == "LBFGSB" else (None, None)
    return tuple(
        problem.build(pcfg(
            task=task.LOGISTIC_REGRESSION, optimizer=opt[optimizer],
            optimizer_config=ocfg(lower_bounds=lo, upper_bounds=hi),
            regularization=rctx(rtype[reg], elastic_net_alpha=0.5), regularization_weight=2.0,
        ))
        for problem, pcfg, ocfg, task, opt, rctx, rtype in (
            (JProblem, JPConfig, JConfig, JTask, JOpt, JReg, JRegType),
            (TProblem, TPConfig, TConfig, TTask, TOpt, TReg, TRegType),
        )
    )


@pytest.mark.parametrize("optimizer,reg", [("OWLQN", "ELASTIC_NET"), ("LBFGS", "L2"),
                                           ("LBFGSB", "L2")])
def test_full_linesearch_takes_the_black_box_path(optimizer, reg, monkeypatch):
    """PHOTON_GLM_LINESEARCH=full routes OWL-QN and L-BFGS(-B) to black-box
    trials, in the port as in JAX: every trial is a full value and
    gradient (n_feature_passes = 2·n_evals), the solve equals JAX's under
    the same variable at float64 (equal counters, x within rtol 1e-8), and
    on this problem, whose line searches backtrack (features scaled by
    10), it counts more passes than the margin-space default. (Where every
    first trial is accepted, the two paths count about the same.)"""
    x, y, offsets, weights = _arrays("logistic", 1)
    x = 10.0 * x
    x[:, 0] = 1.0
    jb, tb = _batches((x, y, offsets, weights))
    jp, tp = _problem_pair(optimizer, reg)
    jx0, tx0 = _zeros(D)
    margin = tp.solve(tb, tx0)
    monkeypatch.setenv("PHOTON_GLM_LINESEARCH", "full")
    full = tp.solve(tb, tx0)
    _same(full, jp.solve(jb, jx0))
    assert int(full.n_feature_passes) == 2 * int(full.n_evals)
    assert int(margin.n_feature_passes) < 2 * int(margin.n_evals)
    assert int(full.n_feature_passes) > int(margin.n_feature_passes)
    assert int(full.reason) == int(margin.reason) == 2
    np.testing.assert_allclose(float(full.value), float(margin.value), rtol=1e-6)
