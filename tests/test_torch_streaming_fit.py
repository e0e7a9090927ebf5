"""Out-of-core streaming training in the port (photon_tpu_torch/game/
streaming.py and the estimator's ``stream=``), on the CPU at a small size.

Mirrors the JAX package's tests/test_streaming_fit.py: a streaming fit
equals the port's materialized fit bit for bit (random effect only, and
with a locked fixed effect), reports its chunks and a bounded residency,
counts no one-time cost after sweep 0; a residency breach raises, the
guard can be turned off, the unsupported fits are refused at fit entry,
``PHOTON_STREAM_CHUNK_ROWS`` wins, a dead producer is ProducerDiedError, a
chunk fault propagates its own error, and a warm-started delta day
retrains only the entities it touches. Beyond JAX's: the same numpy
inputs through JAX's streaming fit and the port's agree within 1e-9 at
float64; the padding lanes of a bucket's last chunk stay at 0; a
streaming fit killed mid-descent resumes to the uninterrupted fit bit for
bit, and a supervised restart treats the stream's failures as JAX does.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.optimize import problem as jprob
from photon_tpu.optimize.common import OptimizerConfig as JOptConfig
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game import streaming
from photon_tpu_torch.game.checkpoint import ModelCheckpointStore
from photon_tpu_torch.game.estimator import GameEstimator
from photon_tpu_torch.game.scoring import ProducerDiedError
from photon_tpu_torch.game.streaming import StreamConfig, StreamingModeError, stream_chunk_rows
from photon_tpu_torch.obs import memory as obs_memory
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.optimize.common import OptimizerConfig as TOptConfig
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import faults


@pytest.fixture(autouse=True)
def _no_env_chunk_rows(monkeypatch):
    # the environment wins over every chunk size these tests pass
    monkeypatch.delenv("PHOTON_STREAM_CHUNK_ROWS", raising=False)


def _arrays(seed=0, n=600, d_fe=6, d_re=4, users=40, user_pool=None):
    """numpy arrays of a global shard and a per-user shard; ``user_pool``
    restricts which user ids appear (the delta-day construction)."""
    rng = np.random.default_rng(seed)
    ids = rng.zipf(1.4, size=n) % users
    if user_pool is not None:
        ids = np.asarray(user_pool)[ids % len(user_pool)]
    x = rng.normal(size=(n, d_fe))
    y = x @ rng.normal(size=d_fe) * 0.3 + rng.normal(size=n) * 0.1
    # float32-exact per-user values: the RE build stores float32 blocks
    z = rng.normal(size=(n, d_re)).astype(np.float32).astype(np.float64)
    return y, {"g": x, "s_userId": z}, {"userId": np.array([f"u{int(i)}" for i in ids])}


def _data(pkg=tdata, **kw):
    y, shards, ids = _arrays(**kw)
    return pkg.GameData.build(
        labels=y,
        feature_shards={k: pkg.CSRMatrix.from_dense(v) for k, v in shards.items()},
        id_tags=ids,
    )


def _opt(prob=tprob, OptConfig=TOptConfig, task=TTask.LINEAR_REGRESSION, **kw):
    return prob.GLMProblemConfig(
        task=task,
        regularization=prob.RegularizationContext(prob.RegularizationType.L2),
        optimizer_config=OptConfig(max_iterations=4),
        **kw,
    )


def _user(cfg=tcfg, opt=None):
    return cfg.RandomEffectCoordinateConfig(
        random_effect_type="userId", feature_shard="s_userId",
        optimization=opt or _opt(), regularization_weights=(1.0,),
    )


def _fixed(cfg=tcfg, opt=None, **kw):
    return cfg.FixedEffectCoordinateConfig(
        feature_shard="g", optimization=opt or _opt(), regularization_weights=(1.0,),
        representation=cfg.FeatureRepresentation.DENSE, **kw,
    )


def _re_est(descent_iterations=3, **kw):
    kw.setdefault("device", "cpu")
    return GameEstimator(
        task=TTask.LINEAR_REGRESSION, coordinate_configs={"user": _user()},
        update_sequence=["user"], descent_iterations=descent_iterations, **kw,
    )


def _fe_re_est(locked=True, bf16=False, **kw):
    return GameEstimator(
        task=TTask.LINEAR_REGRESSION,
        coordinate_configs={"fixed": _fixed(bf16_features=bf16), "user": _user()},
        update_sequence=["fixed", "user"], descent_iterations=2,
        locked_coordinates=frozenset({"fixed"}) if locked else frozenset(),
        device="cpu", **kw,
    )


def _assert_re_models_bit_equal(a, b):
    assert list(a.vocab) == list(b.vocab)
    assert len(a.buckets) == len(b.buckets)
    for ba, bb in zip(a.buckets, b.buckets):
        assert list(ba.entity_ids) == list(bb.entity_ids)
        assert np.array_equal(ba.coefficients, bb.coefficients)


def _sweep_rows(result):
    return [r for r in result.tracker if "sweep_seconds" in r]


# ---------------------------------------------------------------------------
# bit parity, bounded residency, no one-time cost after sweep 0
# ---------------------------------------------------------------------------


def test_streaming_fit_bit_parity_bounded_residency_zero_steady_compiles():
    data = _data()
    est_m, est_s = _re_est(), _re_est()
    res_m = est_m.fit(data)
    res_s = est_s.fit(data, stream=128)
    _assert_re_models_bit_equal(res_m[0].model.coordinates["user"],
                                res_s[0].model.coordinates["user"])
    np.testing.assert_array_equal(res_m[0].scores, res_s[0].scores)

    st = est_s.last_fit_stats["stream"]
    assert st["chunks"] >= 4 * 3 and st["streams"] == 1 + 2 * 3
    assert st["h2d_bytes"] > 0 and st["overlapped_h2d_bytes"] > 0
    assert set(st["stage_seconds"]) >= {"queue", "h2d", "dispatch", "readback", "pipeline"}
    res = st["residency"]
    assert res["samples"] == st["chunks"]
    assert res["peak_over_baseline_bytes"] <= res["limit_bytes"]
    assert "stream" not in est_m.last_fit_stats

    rows_s, rows_m = _sweep_rows(res_s[0]), _sweep_rows(res_m[0])
    assert len(rows_s) == 3
    assert rows_s[0]["compiles"] > 0
    assert all(r["compiles"] == 0 for r in rows_s[1:])
    # health is summed on the host in chunk order: roundoff only
    for a, b in zip(rows_m, rows_s):
        assert b["health"]["user"]["finite"] is True
        np.testing.assert_allclose(b["health"]["user"]["loss"], a["health"]["user"]["loss"],
                                   rtol=1e-5)
        np.testing.assert_allclose(b["health"]["user"]["gnorm"], a["health"]["user"]["gnorm"],
                                   rtol=1e-4)


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16_features"])
def test_streaming_fit_with_locked_fixed_effect_bit_parity(bf16):
    """A bfloat16 block streams bfloat16 chunks through bf16_product."""
    data = _data(seed=3)
    base = _fe_re_est(locked=False, bf16=bf16).fit(data)[0].model
    est_m, est_s = _fe_re_est(bf16=bf16), _fe_re_est(bf16=bf16)
    mm = est_m.fit(data, initial_model=base)[0].model
    ms = est_s.fit(data, stream=96, initial_model=base)[0].model
    fe_m = mm.coordinates["fixed"].coefficients.means
    fe_s = ms.coordinates["fixed"].coefficients.means
    assert np.array_equal(fe_m, fe_s)
    assert np.array_equal(fe_s, base.coordinates["fixed"].coefficients.means)
    _assert_re_models_bit_equal(mm.coordinates["user"], ms.coordinates["user"])
    st = est_s.last_fit_stats["stream"]
    # the fixed effect's one score stream (600 rows in chunks of 96) is in it
    assert st["streams"] == 1 + 1 + 2 * 2
    assert st["residency"]["samples"] == st["chunks"]


def test_streaming_fixed_effect_cannot_train():
    data = _data()
    coords = _fe_re_est()._build_coordinates(data, stream_cfg=StreamConfig(chunk_rows=64))
    fe = coords["fixed"]
    with pytest.raises(StreamingModeError, match="locked"):
        fe.sweep_step(None, None, fe.initial_state())


def test_streaming_residency_breach_fails_loudly(monkeypatch):
    """The CPU reads 0 device bytes, so the breach is simulated: limit 0
    and an allocator whose bytes grow at every read."""
    real_guard = obs_memory.ResidencyGuard

    class _ZeroLimit(real_guard):
        def __init__(self, limit_bytes, **kw):
            super().__init__(0, **kw)

    reads = iter(range(0, 1 << 30, 1 << 20))
    monkeypatch.setattr(obs_memory, "ResidencyGuard", _ZeroLimit)
    monkeypatch.setattr(obs_memory, "live_device_bytes", lambda: next(reads))
    with pytest.raises(obs_memory.ResidencyError, match="double buffer"):
        _re_est().fit(_data(), stream=128)


def test_streaming_residency_assertion_opt_out():
    est = _re_est(descent_iterations=1)
    est.fit(_data(), stream=StreamConfig(chunk_rows=128, assert_residency=False))
    assert "residency" not in est.last_fit_stats["stream"]


def test_streaming_refuses_causal_tracing(monkeypatch):
    monkeypatch.setenv("PHOTON_TRACE", "1")
    with pytest.raises(NotImplementedError, match="PHOTON_TRACE.*ROADMAP A5b"):
        _re_est(descent_iterations=1).fit(_data(), stream=128)


# ---------------------------------------------------------------------------
# fits the streaming mode refuses, at fit entry
# ---------------------------------------------------------------------------


def _rejected(case):
    if case == "trainable_fixed_effect":
        return _fe_re_est(locked=False), {}, "LOCKED"
    if case == "variances":
        opt = _opt(variance_computation=tprob.VarianceComputationType.SIMPLE)
        est = GameEstimator(task=TTask.LINEAR_REGRESSION,
                            coordinate_configs={"user": _user(opt=opt)},
                            update_sequence=["user"], device="cpu")
        return est, {}, "variance"
    if case == "matrix_factorization":
        mf = tcfg.MatrixFactorizationCoordinateConfig(
            row_entity_type="userId", col_entity_type="userId", optimization=_opt(),
            num_factors=2, regularization_weights=(1.0,),
        )
        est = GameEstimator(task=TTask.LINEAR_REGRESSION,
                            coordinate_configs={"user": _user(), "mf": mf},
                            update_sequence=["user", "mf"], device="cpu")
        return est, {}, "matrix-factorization"
    from photon_tpu_torch.evaluation.evaluators import EvaluatorType

    est = _re_est(validation_evaluator=EvaluatorType.RMSE)
    return est, {"validation_data": _data(seed=5, n=100)}, "validation"


@pytest.mark.parametrize(
    "case", ["trainable_fixed_effect", "variances", "matrix_factorization",
             "device_validation"])
def test_streaming_rejects_unsupported_fits(case, monkeypatch):
    est, kw, match = _rejected(case)
    built = []
    monkeypatch.setattr(est, "_build_coordinates", lambda *a, **k: built.append(1))
    with pytest.raises(StreamingModeError, match=match):
        est.fit(_data(), stream=128, **kw)
    assert not built  # refused before anything was built


def test_stream_config_resolution(monkeypatch):
    assert StreamConfig.resolve(256).chunk_rows == 256
    assert stream_chunk_rows() == StreamConfig().chunk_rows == 8192
    cfg = StreamConfig(chunk_rows=64, assert_residency=False)
    assert StreamConfig.resolve(cfg) == cfg
    for bad in ("8192", True):  # an int chunk size or a StreamConfig only
        with pytest.raises(TypeError):
            StreamConfig.resolve(bad)
    monkeypatch.setenv("PHOTON_STREAM_CHUNK_ROWS", "48")
    assert StreamConfig.resolve(256).chunk_rows == 48
    assert StreamConfig.resolve(cfg).chunk_rows == 48
    assert stream_chunk_rows() == 48
    monkeypatch.setenv("PHOTON_STREAM_CHUNK_ROWS", "0")
    with pytest.raises(ValueError, match=">= 1"):
        stream_chunk_rows()


# ---------------------------------------------------------------------------
# the train.stream.* fault points
# ---------------------------------------------------------------------------


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_producer_death_converts_to_producer_died_error():
    with faults.injected("train.stream.producer@1=error"):
        with pytest.raises(ProducerDiedError):
            _re_est(descent_iterations=1).fit(_data(), stream=128)


@pytest.mark.parametrize("point,error", [("train.stream.chunk@2=io_error", faults.InjectedIOError),
                                         ("train.stream.h2d@3=error", faults.InjectedFault)])
def test_stream_fault_propagates_original_error(point, error):
    with faults.injected(point):
        with pytest.raises(error):
            _re_est(descent_iterations=1).fit(_data(), stream=128)


# ---------------------------------------------------------------------------
# warm start: the delta day
# ---------------------------------------------------------------------------


def _entity_coef_map(re_model):
    return {re_model.vocab[e]: b.coefficients[i]
            for b in re_model.buckets for i, e in enumerate(b.entity_ids)}


def test_warm_start_updates_only_delta_day_entities(tmp_path):
    ckpt = str(tmp_path / "daily")
    _re_est().fit(_data(seed=0, n=600, users=40), stream=128, model_checkpoint_dir=ckpt)
    store = ModelCheckpointStore(ckpt)
    model0, seq0 = store.load_latest()
    assert seq0 == 0
    coef0 = _entity_coef_map(model0.coordinates["user"])

    day1 = _data(seed=9, n=96, users=40, user_pool=[1, 2, 5])
    touched = set(day1.id_tags["userId"])
    assert touched < set(coef0)
    res1 = _re_est().fit(day1, stream=64, warm_start=ckpt, model_checkpoint_dir=ckpt)
    coef1 = _entity_coef_map(res1[0].model.coordinates["user"])
    assert set(coef0) <= set(coef1)
    untouched = set(coef0) - touched
    assert untouched
    for k in untouched:
        assert np.array_equal(coef0[k], coef1[k]), k
    assert any(not np.array_equal(coef0[k], coef1[k]) for k in touched)
    assert store.load_latest()[1] == 1
    # the same delta day warm-started materialized gives the same model
    mat = _re_est().fit(day1, initial_model=model0)[0].model.coordinates["user"]
    for k, v in _entity_coef_map(mat).items():
        assert np.array_equal(v, coef1[k]), k


# ---------------------------------------------------------------------------
# the port against JAX's streaming fit
# ---------------------------------------------------------------------------


def _both_estimators(with_fe: bool):
    out = []
    for cfg, prob, OptConfig, task, Est, kw in (
        (jcfg, jprob, JOptConfig, JTask.LINEAR_REGRESSION, JEstimator, {"dtype": jnp.float64}),
        (tcfg, tprob, TOptConfig, TTask.LINEAR_REGRESSION, GameEstimator,
         {"dtype": torch.float64, "device": "cpu"}),
    ):
        opt = _opt(prob, OptConfig, task)
        coords = {"user": _user(cfg, opt)}
        if with_fe:
            coords = {"fixed": _fixed(cfg, opt), **coords}
        out.append(Est(task=task, coordinate_configs=coords, update_sequence=list(coords),
                       descent_iterations=2,
                       locked_coordinates=frozenset({"fixed"}) if with_fe else frozenset(),
                       **kw))
    return out


@pytest.mark.parametrize("with_fe", [False, True], ids=["re_only", "locked_fe"])
def test_streaming_fit_equals_jax(with_fe):
    j_data, t_data = _data(jdata, seed=4), _data(tdata, seed=4)
    j_est, t_est = _both_estimators(with_fe)
    kw = {}
    if with_fe:
        # the locked fixed effect comes from a prior model, the same in both
        rng = np.random.default_rng(11)
        means = rng.normal(size=6)
        from photon_tpu.game.model import FixedEffectModel as JFE
        from photon_tpu.game.model import GameModel as JGM
        from photon_tpu.models.coefficients import Coefficients as JC
        from photon_tpu.models.glm import model_for_task
        from photon_tpu_torch.game.model import Coefficients as TC
        from photon_tpu_torch.game.model import FixedEffectModel as TFE
        from photon_tpu_torch.game.model import GameModel as TGM

        j_init = JGM(coordinates={"fixed": JFE(
            model=model_for_task(JTask.LINEAR_REGRESSION,
                                 JC(means=jnp.asarray(means), variances=None)),
            feature_shard="g")}, task=JTask.LINEAR_REGRESSION)
        t_init = TGM(coordinates={"fixed": TFE(
            coefficients=TC(means=means, variances=None), feature_shard="g",
            task=TTask.LINEAR_REGRESSION)}, task=TTask.LINEAR_REGRESSION)
        kw = {"j": {"initial_model": j_init}, "t": {"initial_model": t_init}}
    jm = j_est.fit(j_data, stream=128, **kw.get("j", {}))[0].model
    tm = t_est.fit(t_data, stream=128, **kw.get("t", {}))[0].model
    ju, tu = jm.coordinates["user"], tm.coordinates["user"]
    assert list(ju.vocab) == list(tu.vocab)
    jmap, tmap = _entity_coef_map(ju), _entity_coef_map(tu)
    assert jmap.keys() == tmap.keys()
    for k in jmap:
        np.testing.assert_allclose(tmap[k], np.asarray(jmap[k]), rtol=1e-9, atol=1e-9)
    if with_fe:
        np.testing.assert_allclose(tm.coordinates["fixed"].coefficients.means,
                                   np.asarray(jm.coordinates["fixed"].model.coefficients.means),
                                   rtol=1e-12, atol=0)
    assert "stream" in t_est.last_fit_stats


# ---------------------------------------------------------------------------
# padding lanes, resume, supervised restarts
# ---------------------------------------------------------------------------


def test_padded_last_chunk_lanes_stay_zero(monkeypatch):
    real = streaming.solve_lanes
    seen = []

    def recording(cfg, features, labels, offsets, weights, w0):
        res = real(cfg, features, labels, offsets, weights, w0)
        pad = weights.sum(-1) == 0
        seen.append((int(pad.sum()), res.x[pad].clone(), res.value[pad].clone()))
        return res

    monkeypatch.setattr(streaming, "solve_lanes", recording)
    data = _data()
    est = _re_est()
    coords = est._build_coordinates(data, stream_cfg=StreamConfig(chunk_rows=48))
    padded = [hb for hb in coords["user"].host_buckets if hb.num_entities % hb.ec]
    assert padded  # a bucket whose entity count is not a multiple of its lanes
    model = est.fit(data, stream=48)[0].model
    lanes = [(x, v) for n, x, v in seen if n]
    assert lanes
    for x, v in lanes:
        assert torch.equal(x, torch.zeros_like(x))
        assert torch.isfinite(v).all()
    # single-chunk buckets bit for bit; those solved in several chunks
    # within roundoff (another batch size may take another BLAS path)
    single = coords["user"].single_chunk_buckets()
    assert not all(single) and any(single)
    mat = _re_est().fit(data)[0].model
    for one, a, b in zip(single, mat.coordinates["user"].buckets,
                         model.coordinates["user"].buckets, strict=True):
        if one:
            assert np.array_equal(a.coefficients, b.coefficients)
        else:
            np.testing.assert_allclose(b.coefficients, a.coefficients, rtol=1e-5, atol=1e-6)


def test_killed_streaming_fit_resumes_to_the_uninterrupted_fit(tmp_path):
    data = _data(seed=2)
    want = _re_est(descent_iterations=4).fit(data, stream=96)[0]
    ckpt = str(tmp_path / "ckpt")
    with faults.injected("descent.sweep@3=crash"):
        with pytest.raises(faults.InjectedCrash):
            _re_est(descent_iterations=4).fit(data, stream=96, checkpoint_dir=ckpt)
    est = _re_est(descent_iterations=4)
    got = est.fit(data, stream=96, checkpoint_dir=ckpt)[0]
    assert est.last_fit_stats["resumed_from"] == (0, 1)
    _assert_re_models_bit_equal(want.model.coordinates["user"], got.model.coordinates["user"])
    np.testing.assert_array_equal(want.scores, got.scores)
    # the resumed fit swept only sweeps 2 and 3, from host states
    assert [r["iteration"] for r in _sweep_rows(got)] == [2, 3]


@pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
def test_supervised_restart_of_a_streaming_fit(tmp_path):
    """A transient fault in the stream restarts the fit from its
    checkpoint (the uninterrupted model bit for bit); a dead producer is
    fatal, as JAX's classify_failure has it, and is not restarted."""
    data = _data(seed=2)
    want = _re_est().fit(data, stream=96)[0]
    est = _re_est(max_restarts=1)
    with faults.injected("train.stream.chunk@40=unavailable"):
        got = est.fit(data, stream=96, checkpoint_dir=str(tmp_path / "a"))[0]
    assert len(est.last_fit_stats["restarts"]) == 1
    assert "UNAVAILABLE" in est.last_fit_stats["restarts"][0]
    _assert_re_models_bit_equal(want.model.coordinates["user"], got.model.coordinates["user"])

    est = _re_est(max_restarts=1)
    calls = []
    real_fit = est._fit
    monkey = pytest.MonkeyPatch()
    monkey.setattr(est, "_fit", lambda *a, **k: calls.append(1) or real_fit(*a, **k))
    try:
        with faults.injected("train.stream.producer@2=error"):
            with pytest.raises(ProducerDiedError):
                est.fit(data, stream=96, checkpoint_dir=str(tmp_path / "b"))
    finally:
        monkey.undo()
    assert len(calls) == 1
