"""Port parity: the GAME estimator end to end against the JAX package.

A config-5-shaped model at a small size (n=2^11, sparse fixed effect with
d=2^10 and 8 nonzeros per row through the window layout, per-user and
per-item random effects at d=4) is built and fitted by both packages at
float64: RE bucket arrays must be identical, a 2-sweep fit must give the
same FE and per-entity RE coefficients (rtol 1e-7), and the port's scorer
on a model carried across by ``game_model_from_numpy`` must match the JAX
scorer (rtol 1e-5: the JAX scorer computes in float32).

A smaller GLMix case (n=600, a dense fixed effect with an intercept, a
sparse per-user and a dense per-item random effect) holds the estimator's
options against JAX at float64: fixed-effect down-sampling and GAME
variances (two faults of the port, each pinned here), locked coordinates,
warm starts with the new-entity threshold bypass and prior-model
carry-over, normalization, projected and Pearson-capped buckets
(identical host arrays) and ``max_buckets`` consolidation.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.game.scoring import GameScorer as JScorer
from photon_tpu.optimize import problem as jprob
from photon_tpu.optimize.common import OptimizerConfig as JOptConfig
from photon_tpu.types import OptimizerType as JOpt
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.convert import game_model_from_numpy
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.game.scoring import GameScorer as TScorer
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.optimize.common import OptimizerConfig as TOptConfig
from photon_tpu_torch.types import OptimizerType as TOpt
from photon_tpu_torch.types import TaskType as TTask

N, FE_DIM, FE_NNZ = 1 << 11, 1 << 10, 8


@pytest.fixture(autouse=True)
def _release_jax_executables():
    """Drop JAX's compiled programs before each test: a test worker keeps
    every executable its earlier tests compiled (the JAX package's jitted
    methods hold their coordinates as static arguments), and at ~21,000 of
    them a worker reaches the kernel's 65,530 memory maps, where the next
    compile segfaults."""
    jax.clear_caches()
    yield
COORDS = [("user", 64, 4, 32), ("item", 16, 4, 128)]
FE_ITERS, RE_ITERS = 10, 5


def _arrays(seed=0, sparse_re=False):
    """numpy arrays of a config-5-shaped dataset (bench.py generator)."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(1, FE_DIM, size=N * FE_NNZ).astype(np.int32)
    cols[::FE_NNZ] = 0
    vals = rng.normal(size=N * FE_NNZ) / np.sqrt(FE_NNZ)
    vals[::FE_NNZ] = 1.0
    margin = (vals * (rng.normal(size=FE_DIM) * 0.3)[cols]).reshape(N, FE_NNZ).sum(1)
    labels = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    shards = {"global": (np.arange(N + 1) * FE_NNZ, cols, vals, FE_DIM)}
    ids = {}
    for name, ne, d_re, _ in COORDS:
        e = (rng.zipf(1.3, size=N) - 1) % ne
        e[:ne] = rng.permutation(ne)
        ids[name] = np.array([f"{name[0]}{i}" for i in e])
        # float32-exact values: the RE build stores float32 blocks
        x = rng.normal(size=(N, d_re)).astype(np.float32).astype(np.float64)
        if sparse_re:
            x[rng.uniform(size=x.shape) < 0.4] = 0.0
        mask = x != 0
        indptr = np.concatenate([[0], np.cumsum(mask.sum(1))])
        shards[f"per_{name}"] = (indptr, np.nonzero(mask)[1].astype(np.int32), x[mask], d_re)
    offsets = 0.1 * rng.normal(size=N)
    return labels, offsets, shards, ids


def _game_data(pkg, arrays):
    labels, offsets, shards, ids = arrays
    return pkg.GameData.build(
        labels,
        {k: pkg.CSRMatrix(*v) for k, v in shards.items()},
        offsets=offsets,
        id_tags=ids,
    )


def _configs(cfg, prob, OptConfig, task):
    l2 = prob.RegularizationContext(prob.RegularizationType.L2)
    out = {
        "fixed": cfg.FixedEffectCoordinateConfig(
            feature_shard="global",
            optimization=prob.GLMProblemConfig(
                task=task,
                optimizer_config=OptConfig(max_iterations=FE_ITERS, ls_max_iterations=10),
                regularization=l2,
            ),
            regularization_weights=(1.0,),
            representation=cfg.FeatureRepresentation.SPARSE,
        )
    }
    for name, _, _, ub in COORDS:
        out[name] = cfg.RandomEffectCoordinateConfig(
            random_effect_type=name,
            feature_shard=f"per_{name}",
            optimization=prob.GLMProblemConfig(
                task=task,
                optimizer_config=OptConfig(max_iterations=RE_ITERS, ls_max_iterations=8),
                regularization=l2,
            ),
            regularization_weights=(1.0,),
            active_data_upper_bound=ub,
        )
    return out


def _jax_configs():
    return _configs(jcfg, jprob, JOptConfig, JTask.LOGISTIC_REGRESSION)


def _torch_configs():
    cfgs = _configs(tcfg, tprob, TOptConfig, TTask.LOGISTIC_REGRESSION)
    cfgs["fixed"] = dataclasses.replace(cfgs["fixed"], column_windows=True)
    return cfgs


UPDATE = ["fixed", "user", "item"]


@pytest.fixture(scope="module")
def fits():
    arrays = _arrays()
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    with pytest.MonkeyPatch.context() as mp:
        # windows on the JAX side too (its CPU default builds none)
        mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
        jres = JEstimator(
            task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
            update_sequence=UPDATE, descent_iterations=2, dtype=jnp.float64,
        ).fit(jd)[0]
    tres = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
        update_sequence=UPDATE, descent_iterations=2, dtype=torch.float64,
        device="cpu",
    ).fit(td)[0]
    return jd, td, jres, tres


def _entity_coefs(model):
    out = {}
    for b in model.buckets:
        for i, e in enumerate(np.asarray(b.entity_ids)):
            out[str(model.vocab[e])] = (
                np.asarray(b.col_index)[i],
                np.asarray(b.coefficients, dtype=np.float64)[i],
            )
    return out


@pytest.mark.parametrize("sparse_re", [False, True], ids=["dense-re", "sparse-re"])
@pytest.mark.parametrize("coord", [c[0] for c in COORDS])
def test_re_buckets_identical_to_jax(coord, sparse_re):
    arrays = _arrays(seed=5, sparse_re=sparse_re)
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    jpool = JEstimator(
        task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
        update_sequence=UPDATE,
    )._build_shape_pool(jd)
    tpool = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
        update_sequence=UPDATE, device="cpu",
    )._build_shape_pool(td)
    assert (jpool is None) == (tpool is None) == sparse_re
    jds = jdata.build_random_effect_dataset(jd, _jax_configs()[coord], seed=3, shape_pool=jpool)
    tds = tdata.build_random_effect_dataset(td, _torch_configs()[coord], seed=3, shape_pool=tpool)
    np.testing.assert_array_equal(tds.vocab, jds.vocab)
    assert len(tds.buckets) == len(jds.buckets) > 1
    for jb, tb in zip(jds.buckets, tds.buckets):
        for f in (
            "features", "labels", "offsets", "weights", "active_mask", "col_index",
            "sample_pos", "entity_ids", "score_feats", "score_slot", "score_pos",
        ):
            a, b = getattr(jb, f), getattr(tb, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)


def test_fit_fixed_effect_matches_jax(fits):
    _, _, jres, tres = fits
    want = np.asarray(jres.model.coordinates["fixed"].model.coefficients.means)
    got = tres.model.coordinates["fixed"].coefficients.means
    assert got.shape == (FE_DIM,)
    np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-10)


@pytest.mark.parametrize("coord", [c[0] for c in COORDS])
def test_fit_random_effect_matches_jax(fits, coord):
    _, _, jres, tres = fits
    want = _entity_coefs(jres.model.coordinates[coord])
    got = _entity_coefs(tres.model.coordinates[coord])
    assert set(got) == set(want)
    for key, (cols, coefs) in want.items():
        np.testing.assert_array_equal(got[key][0], cols)
        np.testing.assert_allclose(got[key][1], coefs, rtol=1e-7, atol=1e-10, err_msg=key)


def test_fit_scores_are_the_model_margins(fits):
    """The fit's final total equals the model's margins on its own data."""
    _, td, _, tres = fits
    scorer = TScorer(tres.model, device="cpu", dtype=torch.float64, batch_rows=512)
    np.testing.assert_allclose(
        scorer.score_data(td) - td.offsets, tres.scores, rtol=1e-10, atol=1e-10
    )


def _opt(a):
    return None if a is None else np.asarray(a)


def _numpy_model(jmodel, task=TTask.LOGISTIC_REGRESSION):
    """A JAX GameModel carried into the port through numpy."""
    coords = {}
    for cid, cm in jmodel.coordinates.items():
        if hasattr(cm, "model"):
            c = cm.model.coefficients
            coords[cid] = {
                "feature_shard": cm.feature_shard,
                "means": np.asarray(c.means),
                "variances": _opt(c.variances),
            }
        elif hasattr(cm, "row_factors"):
            coords[cid] = {
                k: np.asarray(getattr(cm, k)) if "vocab" in k or "factors" in k
                else getattr(cm, k)
                for k in ("row_entity_type", "col_entity_type", "row_vocab", "col_vocab",
                          "row_factors", "col_factors")
            }
        else:
            coords[cid] = {
                "random_effect_type": cm.random_effect_type,
                "feature_shard": cm.feature_shard,
                "vocab": np.asarray(cm.vocab),
                "num_features": cm.num_features,
                "projection_matrix": _opt(cm.projection_matrix),
                "buckets": [
                    {
                        "entity_ids": np.asarray(b.entity_ids),
                        "col_index": np.asarray(b.col_index),
                        "coefficients": np.asarray(b.coefficients),
                        "variances": _opt(b.variances),
                    }
                    for b in cm.buckets
                ],
            }
    return game_model_from_numpy(task, coords)


def test_scorer_matches_jax_scorer(fits):
    jd, td, jres, _ = fits
    want = np.asarray(JScorer(jres.model, batch_rows=512).score_data(jd))
    got = TScorer(
        _numpy_model(jres.model), device="cpu", dtype=torch.float64, batch_rows=512
    ).score_data(td)
    assert got.shape == (N,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _tron_owlqn_configs(cfg, prob, OptConfig, Opt, task):
    """TRON (L2) on the fixed effect, OWL-QN (elastic net) per user."""
    out = _configs(cfg, prob, OptConfig, task)
    out["fixed"] = dataclasses.replace(
        out["fixed"],
        optimization=dataclasses.replace(
            out["fixed"].optimization, optimizer=Opt.TRON, optimizer_config=OptConfig()
        ),
    )
    out["user"] = dataclasses.replace(
        out["user"],
        optimization=dataclasses.replace(
            out["user"].optimization,
            optimizer=Opt.OWLQN,
            regularization=prob.RegularizationContext(
                prob.RegularizationType.ELASTIC_NET, elastic_net_alpha=0.5
            ),
        ),
        regularization_weights=(2.0,),
    )
    del out["item"]
    return out


def test_tron_and_owlqn_coordinates_match_jax():
    arrays = _arrays(seed=2)
    jd, td = _game_data(jdata, arrays), _game_data(tdata, arrays)
    jcfgs = _tron_owlqn_configs(jcfg, jprob, JOptConfig, JOpt, JTask.LOGISTIC_REGRESSION)
    tcfgs = _tron_owlqn_configs(tcfg, tprob, TOptConfig, TOpt, TTask.LOGISTIC_REGRESSION)
    tcfgs["fixed"] = dataclasses.replace(tcfgs["fixed"], column_windows=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
        jres = JEstimator(
            task=JTask.LOGISTIC_REGRESSION, coordinate_configs=jcfgs,
            update_sequence=["fixed", "user"], descent_iterations=2, dtype=jnp.float64,
        ).fit(jd)[0]
    tres = TEstimator(
        task=TTask.LOGISTIC_REGRESSION, coordinate_configs=tcfgs,
        update_sequence=["fixed", "user"], descent_iterations=2, dtype=torch.float64,
        device="cpu",
    ).fit(td)[0]
    np.testing.assert_allclose(
        tres.model.coordinates["fixed"].coefficients.means,
        np.asarray(jres.model.coordinates["fixed"].model.coefficients.means),
        rtol=1e-7, atol=1e-10,
    )
    want = _entity_coefs(jres.model.coordinates["user"])
    got = _entity_coefs(tres.model.coordinates["user"])
    assert set(got) == set(want)
    n_zero = 0
    for key, (cols, coefs) in want.items():
        np.testing.assert_array_equal(got[key][0], cols)
        np.testing.assert_allclose(got[key][1], coefs, rtol=1e-7, atol=1e-10, err_msg=key)
        np.testing.assert_array_equal(got[key][1] == 0, coefs == 0, err_msg=key)
        n_zero += int((coefs == 0).sum())
    assert n_zero > 0  # the L1 part zeroes some per-user coefficients


def test_default_device_is_cuda_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TEstimator(
            task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
            update_sequence=UPDATE,
        )
    model = game_model_from_numpy(
        TTask.LOGISTIC_REGRESSION, {"fixed": {"feature_shard": "global", "means": np.zeros(4)}}
    )
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TScorer(model)


# ---------------------------------------------------------------------------
# The estimator's options on a small GLMix case, against JAX at float64
# ---------------------------------------------------------------------------

SIDES = {
    "jax": (jcfg, jprob, JOptConfig, JTask),
    "torch": (tcfg, tprob, TOptConfig, TTask),
}
SMALL_FE_D, SMALL_USER_D, SMALL_ITEM_D = 6, 8, 3


def small_arrays(seed=0, n=600, users=24, items=8, task="logistic"):
    """labels, offsets, weights, shards {name: dense [n, d]}, id tags."""
    rng = np.random.default_rng(seed)
    x_fe = rng.normal(size=(n, SMALL_FE_D)) * [1, 1, 3, 0.5, 2, 1] + [0, 0.5, -1, 2, 0, 1]
    x_fe[:, 0] = 1.0  # intercept
    x_user = rng.normal(size=(n, SMALL_USER_D)) * (rng.uniform(size=(n, SMALL_USER_D)) < 0.5)
    x_item = rng.normal(size=(n, SMALL_ITEM_D))
    u = (rng.zipf(1.5, size=n) - 1) % users
    u[:users] = rng.permutation(users)
    it = rng.integers(0, items, size=n)
    w_user = rng.normal(size=(users, SMALL_USER_D))
    margin = x_fe @ (0.5 * rng.normal(size=SMALL_FE_D)) + np.einsum(
        "nd,nd->n", x_user, w_user[u]
    )
    if task == "logistic":
        labels = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    else:
        labels = margin + 0.1 * rng.normal(size=n)
    shards = {
        # float32-exact: the RE build stores float32 blocks
        "global": x_fe.astype(np.float32).astype(np.float64),
        "per_user": x_user.astype(np.float32).astype(np.float64),
        "per_item": x_item.astype(np.float32).astype(np.float64),
    }
    ids = {"user": np.array([f"u{i}" for i in u]), "item": np.array([f"i{i}" for i in it])}
    return labels, 0.1 * rng.normal(size=n), rng.uniform(0.5, 2.0, size=n), shards, ids


def small_data(pkg, arrays):
    labels, offsets, weights, shards, ids = arrays
    return pkg.GameData.build(
        labels, {k: pkg.CSRMatrix.from_dense(v) for k, v in shards.items()},
        offsets=offsets, weights=weights, id_tags=ids,
    )


def small_configs(side, coords=("fixed", "user"), task="LOGISTIC_REGRESSION", opt=None,
                  replace=None):
    """Configs of one package. ``opt``: coordinate → GLMProblemConfig
    fields; ``replace``: coordinate → config fields, where a callable value
    is called with the package's config module (for its enums)."""
    cfg, prob, Opt, Task = SIDES[side]
    l2 = prob.RegularizationContext(prob.RegularizationType.L2)
    opt = opt or {}

    def gopt(cid, iters, **kw):
        return prob.GLMProblemConfig(
            task=Task[task],
            optimizer_config=Opt(max_iterations=iters, ls_max_iterations=10),
            regularization=l2, **kw, **opt.get(cid, {}),
        )

    out = {}
    if "fixed" in coords:
        out["fixed"] = cfg.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=gopt("fixed", 15),
            regularization_weights=(1.0,), representation=cfg.FeatureRepresentation.DENSE,
        )
    for name, shard, ub in (("user", "per_user", 20), ("item", "per_item", None)):
        if name in coords:
            out[name] = cfg.RandomEffectCoordinateConfig(
                random_effect_type=name, feature_shard=shard, optimization=gopt(name, 8),
                regularization_weights=(1.0,), active_data_upper_bound=ub,
            )
    if "mf" in coords:
        out["mf"] = cfg.MatrixFactorizationCoordinateConfig(
            row_entity_type="user", col_entity_type="item",
            optimization=gopt("mf", 10), num_factors=3,
        )
    for cid, kw in (replace or {}).items():
        kw = {k: v(cfg) if callable(v) else v for k, v in kw.items()}
        out[cid] = dataclasses.replace(out[cid], **kw)
    return out


def fit_pair(coords=("fixed", "user"), *, update=None, iters=2, arrays=None, task="LOGISTIC_REGRESSION",
             opt=None, est_kw=None, fit_kw=None, replace=None):
    """The same fit by both packages → (jax result list, port result list,
    jax data, port data). ``est_kw``/``fit_kw``: side, data → kwargs."""
    arrays = arrays if arrays is not None else small_arrays()
    out = {}
    for side, pkg in (("jax", jdata), ("torch", tdata)):
        data = small_data(pkg, arrays)
        Est = JEstimator if side == "jax" else TEstimator
        kw = dict(dtype=jnp.float64) if side == "jax" else dict(dtype=torch.float64, device="cpu")
        kw.update(est_kw(side, data) if est_kw else {})
        est = Est(
            task=SIDES[side][3][task],
            coordinate_configs=small_configs(side, coords, task, opt, replace),
            update_sequence=list(update or coords), descent_iterations=iters, **kw,
        )
        out[side] = (est.fit(data, **(fit_kw(side, data) if fit_kw else {})), data)
    return out["jax"][0], out["torch"][0], out["jax"][1], out["torch"][1]


def assert_models_close(jmodel, tmodel, rtol=1e-7, atol=1e-10, variances=False):
    """Every coordinate of the JAX model against the port's."""
    assert list(tmodel.coordinates) == list(jmodel.coordinates)
    for cid, jm in jmodel.coordinates.items():
        tm = tmodel.coordinates[cid]
        if hasattr(jm, "model"):
            jc, tc = jm.model.coefficients, tm.coefficients
            np.testing.assert_allclose(tc.means, np.asarray(jc.means), rtol=rtol, atol=atol)
            if variances:
                np.testing.assert_allclose(
                    tc.variances, np.asarray(jc.variances), rtol=1e-9, atol=1e-12
                )
        elif hasattr(jm, "row_factors"):
            np.testing.assert_array_equal(tm.row_vocab, jm.row_vocab)
            np.testing.assert_allclose(tm.row_factors, jm.row_factors, rtol=rtol, atol=atol)
            np.testing.assert_allclose(tm.col_factors, jm.col_factors, rtol=rtol, atol=atol)
        else:
            np.testing.assert_array_equal(tm.vocab, jm.vocab)
            if jm.projection_matrix is not None:
                np.testing.assert_array_equal(tm.projection_matrix, jm.projection_matrix)
            assert len(tm.buckets) == len(jm.buckets)
            for jb, tb in zip(jm.buckets, tm.buckets):
                np.testing.assert_array_equal(tb.entity_ids, jb.entity_ids)
                np.testing.assert_array_equal(tb.col_index, jb.col_index)
                np.testing.assert_allclose(
                    tb.coefficients, np.asarray(jb.coefficients), rtol=rtol, atol=atol
                )
                if variances:
                    np.testing.assert_allclose(
                        tb.variances, np.asarray(jb.variances), rtol=1e-9, atol=1e-12
                    )


def test_fixed_effect_down_sampling_matches_jax():
    """down_sampling_rate=0.5: the port masks the same rows as JAX (same
    draw, same 1/rate reweighting of kept negatives) and fits the same
    fixed effect."""
    from photon_tpu.game.coordinate import FixedEffectCoordinate as JFE
    from photon_tpu_torch.game.coordinate import FixedEffectCoordinate as TFE

    arrays = small_arrays(seed=8)
    jcfg_fe = small_configs("jax", opt={"fixed": {"down_sampling_rate": 0.5}})["fixed"]
    tcfg_fe = small_configs("torch", opt={"fixed": {"down_sampling_rate": 0.5}})["fixed"]
    jw = np.asarray(
        JFE.build(small_data(jdata, arrays), jcfg_fe, dtype=jnp.float64, seed=3).batch.weights
    )
    tw = TFE.build(small_data(tdata, arrays), tcfg_fe, dtype=torch.float64,
                   device=torch.device("cpu"), seed=3).batch.weights.numpy()
    assert (tw == 0).sum() > 0
    np.testing.assert_array_equal(tw, jw)
    jres, tres, _, _ = fit_pair(
        ("fixed", "user"), arrays=arrays, opt={"fixed": {"down_sampling_rate": 0.5}},
        est_kw=lambda side, d: {"seed": 3},
    )
    assert_models_close(jres[0].model, tres[0].model)


@pytest.mark.parametrize("fe_variance", ["SIMPLE", "FULL"])
def test_game_variances_match_jax(fe_variance):
    """Variances on the fixed effect (under STANDARDIZATION; SIMPLE or
    FULL) and on the random effects (the other kind on the sparse per-user
    one, FULL on the dense per-item one) are exported in the model, equal
    to JAX's at rtol 1e-9."""
    arrays = small_arrays(seed=1)
    kinds = {"fixed": fe_variance, "user": {"SIMPLE": "FULL", "FULL": "SIMPLE"}[fe_variance],
             "item": "FULL"}
    opts = {
        side: {c: {"variance_computation": SIDES[side][1].VarianceComputationType[v]}
               for c, v in kinds.items()}
        for side in SIDES
    }
    models = {}
    for side, pkg in (("jax", jdata), ("torch", tdata)):
        data = small_data(pkg, arrays)
        Est = JEstimator if side == "jax" else TEstimator
        kw = dict(dtype=jnp.float64) if side == "jax" else dict(dtype=torch.float64, device="cpu")
        models[side] = Est(
            task=SIDES[side][3].LOGISTIC_REGRESSION,
            coordinate_configs=small_configs(side, ("fixed", "user", "item"), opt=opts[side]),
            update_sequence=["fixed", "user", "item"], descent_iterations=2,
            normalization_contexts={"global": _standardization(side, arrays)}, **kw,
        ).fit(data)[0].model
    for cid in ("fixed", "user", "item"):
        cm = models["torch"].coordinates[cid]
        vs = [cm.coefficients.variances] if cid == "fixed" else [b.variances for b in cm.buckets]
        assert all(v is not None and np.all(v > 0) for v in vs), cid
    assert_models_close(models["jax"], models["torch"], variances=True)


def _standardization(side, arrays):
    x = arrays[3]["global"]
    if side == "jax":
        from photon_tpu.ops.normalization import NormalizationContext
        from photon_tpu.types import NormalizationType
    else:
        from photon_tpu_torch.ops.normalization import NormalizationContext
        from photon_tpu_torch.types import NormalizationType
    kw = {"dtype": jnp.float64 if side == "jax" else torch.float64}
    return NormalizationContext.build(
        NormalizationType.STANDARDIZATION, mean=x.mean(0), variance=x.var(0),
        intercept_index=0, **kw,
    )


@functools.lru_cache(maxsize=None)
def _jax_base(seed, users=24):
    """A 2-sweep JAX fit of ("fixed", "user"), shared by the tests that
    start from a prior model."""
    arrays = small_arrays(seed=seed, users=users)
    return _fit_base("jax", small_data(jdata, arrays), arrays)


def _fit_base(side, data, arrays, coords=("fixed", "user")):
    Est = JEstimator if side == "jax" else TEstimator
    kw = dict(dtype=jnp.float64) if side == "jax" else dict(dtype=torch.float64, device="cpu")
    return Est(
        task=SIDES[side][3].LOGISTIC_REGRESSION,
        coordinate_configs=small_configs(side, coords), update_sequence=list(coords),
        descent_iterations=2, **kw,
    ).fit(data)[0].model


@pytest.mark.parametrize("in_sequence", [True, False], ids=["in-sequence", "outside-sequence"])
def test_locked_coordinate_matches_jax(in_sequence):
    """A locked fixed effect keeps the initial model's coefficients
    (normalization round trip included), is shipped with the model even
    outside the update sequence, and the retrained random effect matches
    JAX's."""
    arrays = small_arrays(seed=2)
    base = _jax_base(2)
    inits = {"jax": base, "torch": _numpy_model(base)}
    jres, tres, _, _ = fit_pair(
        ("fixed", "user"), update=["fixed", "user"] if in_sequence else ["user"],
        arrays=arrays,
        est_kw=lambda side, d: {
            "locked_coordinates": frozenset({"fixed"}),
            "normalization_contexts": {"global": _standardization(side, arrays)},
        },
        fit_kw=lambda side, d: {"initial_model": inits[side]},
    )
    assert "fixed" in tres[0].model.coordinates
    np.testing.assert_allclose(
        tres[0].model["fixed"].coefficients.means,
        np.asarray(base["fixed"].model.coefficients.means), rtol=1e-12, atol=1e-14,
    )
    assert_models_close(jres[0].model, tres[0].model)


def test_warm_start_threshold_bypass_and_carry_over_match_jax():
    """Warm start from a model of part of the users, with a lower bound
    that only new users may bypass: the same entities are trained, the
    prior users without new data carry over, and every coefficient matches
    JAX's."""
    arrays = small_arrays(seed=4)
    base = _jax_base(5, users=40)
    inits = {"jax": base, "torch": _numpy_model(base)}
    jres, tres, _, td = fit_pair(
        ("fixed", "user"), arrays=arrays,
        replace={"user": {"active_data_lower_bound": 12}},
        est_kw=lambda side, d: {"ignore_threshold_for_new_models": True},
        fit_kw=lambda side, d: {"initial_model": inits[side]},
    )
    # users 24..39 exist only in the prior model: carried over unchanged
    got = _entity_coefs(tres[0].model["user"])
    prior = _entity_coefs(base["user"])
    for key in (f"u{i}" for i in range(24, 40)):
        d = len(prior[key][1])
        np.testing.assert_array_equal(got[key][1][:d], prior[key][1])
        assert not got[key][1][d:].any()
    assert_models_close(jres[0].model, tres[0].model)
    with pytest.raises(ValueError, match="initial model"):
        TEstimator(
            task=TTask.LOGISTIC_REGRESSION, coordinate_configs=small_configs("torch"),
            update_sequence=["fixed", "user"], ignore_threshold_for_new_models=True,
            device="cpu",
        ).fit(td)


PROJECTIONS = {
    "random": {"projector_type": lambda m: m.ProjectorType.RANDOM, "random_projection_dim": 5},
    "identity": {"projector_type": lambda m: m.ProjectorType.IDENTITY},
    "pearson": {"features_to_samples_ratio": 0.3},
    "max-buckets": {"max_buckets": 2, "active_data_upper_bound": None, "shape_budget": 0},
}


@pytest.mark.parametrize("option", list(PROJECTIONS))
def test_re_option_buckets_identical_to_jax(option):
    """The host build under each option gives identical arrays: the
    Gaussian matrix (same draw), the Pearson-kept columns, the merged
    shapes."""
    arrays = small_arrays(seed=6, n=900, users=60)
    jd, td = small_data(jdata, arrays), small_data(tdata, arrays)
    jc = small_configs("jax", replace={"user": PROJECTIONS[option]})["user"]
    tc = small_configs("torch", replace={"user": PROJECTIONS[option]})["user"]
    jds = jdata.build_random_effect_dataset(jd, jc, seed=7, intercept_col=0)
    tds = tdata.build_random_effect_dataset(td, tc, seed=7, intercept_col=0)
    np.testing.assert_array_equal(tds.vocab, jds.vocab)
    if option == "random":
        assert tds.projection_matrix.shape == (SMALL_USER_D, 5)
        np.testing.assert_array_equal(tds.projection_matrix, jds.projection_matrix)
    if option == "pearson":
        assert max(int((b.col_index >= 0).sum(1).max()) for b in tds.buckets) < SMALL_USER_D
    if option == "max-buckets":
        assert len(tds.buckets) == 2
    assert tds.shape_stats() == jds.shape_stats()
    assert tds.padding_waste() == jds.padding_waste()
    assert tds.memory_budget() == jds.memory_budget()
    assert len(tds.buckets) == len(jds.buckets)
    for jb, tb in zip(jds.buckets, tds.buckets):
        for f in (
            "features", "labels", "offsets", "weights", "active_mask", "col_index",
            "sample_pos", "entity_ids", "score_feats", "score_slot", "score_pos",
        ):
            a, b = getattr(jb, f), getattr(tb, f)
            assert a.dtype == b.dtype, f
            np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("option", ["random", "pearson", "normalization"])
def test_fit_with_option_matches_jax(option):
    """A GAME fit with a random projection, a Pearson cap, or a
    standardized fixed effect agrees with JAX (coefficients and the
    model's scores, rtol 1e-7)."""
    replace = {"user": PROJECTIONS[option]} if option in PROJECTIONS else None
    est_kw = None
    if option == "normalization":
        arrays = small_arrays(seed=9)
        est_kw = lambda side, d: {  # noqa: E731
            "normalization_contexts": {"global": _standardization(side, arrays)}
        }
    else:
        arrays = small_arrays(seed=9)
    jres, tres, jd, td = fit_pair(("fixed", "user"), arrays=arrays, replace=replace, est_kw=est_kw)
    assert_models_close(jres[0].model, tres[0].model)
    np.testing.assert_allclose(
        tres[0].model.score(td), jres[0].model.score(jd), rtol=1e-7, atol=1e-9
    )
    # the fit scores the projected features as stored (float32), the
    # model projects in float64
    tol = 1e-6 if option == "random" else 1e-9
    np.testing.assert_allclose(tres[0].scores, tres[0].model.score(td), rtol=tol, atol=tol)


def test_concat_game_data_matches_jax():
    arrays = small_arrays(seed=10, n=50)
    pieces = [(0, 17), (17, 18), (18, 50)]
    j = jdata.concat_game_data([jdata.slice_game_data(small_data(jdata, arrays), a, b)
                                for a, b in pieces])
    t = tdata.concat_game_data([tdata.slice_game_data(small_data(tdata, arrays), a, b)
                                for a, b in pieces])
    for name in ("global", "per_user"):
        for f in ("indptr", "indices", "values"):
            np.testing.assert_array_equal(getattr(t.feature_shards[name], f),
                                          getattr(j.feature_shards[name], f))
    np.testing.assert_array_equal(t.id_tags["user"], j.id_tags["user"])
    assert tdata.labels_are_binary(t.labels) == jdata.labels_are_binary(j.labels)
    assert tdata.positive_rate(t.labels) == jdata.positive_rate(j.labels)


@pytest.mark.parametrize("representation", ["DENSE", "SPARSE"])
def test_fixed_effect_bf16_features(representation):
    """bf16_features stores the feature values as bfloat16 with float32
    labels and state. The dense block's products round the other operand
    to bfloat16 and accumulate in float32, as JAX's do, so the solve agrees
    with JAX's bf16 coordinate within float32 roundoff (rtol 1e-5, atol
    2e-6; the solves differ only in summation order). Sparse values are
    widened to float32 in both packages: the solve equals, bit for bit, a
    float32 solve on the bf16-rounded features, and agrees with JAX's
    within rtol 1e-3, atol 2e-4 (float32 roundoff over the L-BFGS path).
    Both stay close to the unrounded float32 solve."""
    from photon_tpu.game.coordinate import FixedEffectCoordinate as JFE
    from photon_tpu_torch.game.coordinate import FixedEffectCoordinate as TFE

    arrays = small_arrays(seed=15)
    rounded = torch.as_tensor(arrays[3]["global"]).to(torch.bfloat16).to(torch.float64).numpy()
    arrays_rounded = arrays[:3] + ({**arrays[3], "global": rounded},) + arrays[4:]
    out = {}
    for name, arr, bf16 in (("f32", arrays, False), ("bf16", arrays, True),
                            ("rounded", arrays_rounded, False)):
        rep = {"fixed": {"bf16_features": bf16,
                         "representation": lambda m: m.FeatureRepresentation[representation]}}
        tc = TFE.build(small_data(tdata, arr), small_configs("torch", replace=rep)["fixed"],
                       dtype=torch.float32, device=torch.device("cpu"))
        feats = tc.batch.values if representation == "SPARSE" else tc.batch.features
        assert feats.dtype == (torch.bfloat16 if bf16 else torch.float32)
        assert tc.batch.labels.dtype == torch.float32
        w, _ = tc.train(torch.zeros(600), tc.initial_state())
        assert w.dtype == torch.float32
        out[name] = w.numpy()
        if bf16:
            jc = JFE.build(small_data(jdata, arr), small_configs("jax", replace=rep)["fixed"],
                           dtype=jnp.float32)
            out["jax"] = np.asarray(jc.train(jnp.zeros(600, jnp.float32), jc.initial_state())[0])
    np.testing.assert_allclose(out["bf16"], out["f32"], rtol=0.05, atol=0.02)
    if representation == "DENSE":
        np.testing.assert_allclose(out["bf16"], out["jax"], rtol=1e-5, atol=2e-6)
    else:
        np.testing.assert_array_equal(out["bf16"], out["rounded"])
        np.testing.assert_allclose(out["bf16"], out["jax"], rtol=1e-3, atol=2e-4)
