"""Port checkpoints: mid-descent resume, durability, and model snapshots.

The counterparts of tests/test_checkpoint.py and of the checkpoint,
retention, corruption, fingerprint and sequence tests of
tests/test_chaos.py, on the port. A GLMix fit (dense fixed effect and a
per-user random effect, a 2-point λ grid, AUC validation) at float64 on
the CPU is killed after a checkpointed sweep and resumed: its models
equal the uninterrupted fit's bit for bit, and JAX's uninterrupted fit's
within 1e-9. Model snapshots written by either package load in the
other with equal arrays.
"""
from __future__ import annotations

import gc
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import photon_tpu_torch.game.estimator as estimator_mod
from photon_tpu.evaluation.evaluators import EvaluatorType as JEval
from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.checkpoint import ModelCheckpointStore as JStore
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.optimize import common as jcommon
from photon_tpu.optimize import problem as jprob
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.evaluation.evaluators import EvaluatorType as TEval
from photon_tpu_torch.game import config as tcfg
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.checkpoint import (
    MANIFEST,
    CheckpointCorruptError,
    DescentCheckpointer,
    ModelCheckpointStore,
    _flatten_states,
)
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.game.estimator import GameEstimator as TEstimator
from photon_tpu_torch.optimize import common as tcommon
from photon_tpu_torch.optimize import problem as tprob
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import faults
from photon_tpu_torch.util.faults import InjectedCrash

TOL = 1e-9


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the JAX programs this module compiled when it ends: each keeps
    memory maps of its code, and one process running many such modules
    would reach the kernel's limit on maps (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()



def _arrays(n=400, d_fe=12, d_re=4, users=25, seed=0):
    rng = np.random.default_rng(seed)
    x_fe = rng.normal(size=(n, d_fe))
    x_re = rng.normal(size=(n, d_re))
    uid = np.concatenate([np.arange(users), rng.integers(0, users, size=n - users)])
    y = (rng.uniform(size=n) > 0.5).astype(np.float64)
    return y, x_fe, x_re, np.array([f"u{u}" for u in uid])


def _data(pkg, arrays):
    y, x_fe, x_re, uid = arrays
    return pkg.GameData.build(
        labels=y,
        feature_shards={"fe": pkg.CSRMatrix.from_dense(x_fe), "re": pkg.CSRMatrix.from_dense(x_re)},
        id_tags={"userId": uid},
    )


def _configs(cfg, prob, common, task, grid):
    opt = prob.GLMProblemConfig(
        task=task,
        regularization=prob.RegularizationContext(regularization_type=prob.RegularizationType.L2),
        optimizer_config=common.OptimizerConfig(max_iterations=5, ls_max_iterations=4),
    )
    return {
        "fixed": cfg.FixedEffectCoordinateConfig(
            feature_shard="fe", optimization=opt, regularization_weights=grid
        ),
        "per-user": cfg.RandomEffectCoordinateConfig(
            random_effect_type="userId", feature_shard="re", optimization=opt,
            regularization_weights=grid,
        ),
    }


def _port(grid=(1.0, 0.1), iters=3, validation=True, **kw):
    return TEstimator(
        task=TTask.LOGISTIC_REGRESSION,
        coordinate_configs=_configs(tcfg, tprob, tcommon, TTask.LOGISTIC_REGRESSION, grid),
        update_sequence=["fixed", "per-user"],
        descent_iterations=iters,
        validation_evaluator=TEval.AUC if validation else None,
        dtype=torch.float64,
        device="cpu",
        **kw,
    )


def _jax(grid=(1.0, 0.1), iters=3, validation=True):
    return JEstimator(
        task=JTask.LOGISTIC_REGRESSION,
        coordinate_configs=_configs(jcfg, jprob, jcommon, JTask.LOGISTIC_REGRESSION, grid),
        update_sequence=["fixed", "per-user"],
        descent_iterations=iters,
        validation_evaluator=JEval.AUC if validation else None,
        dtype=jnp.float64,
    )


def model_arrays(model) -> dict:
    """FE means and per-entity RE rows (keyed by entity) of either package."""
    fe = model["fixed"]
    means = fe.model.coefficients.means if hasattr(fe, "model") else fe.coefficients.means
    out = {"fixed": np.asarray(means, dtype=np.float64)}
    re = model["per-user"]
    for b in re.buckets:
        for i, e in enumerate(np.asarray(b.entity_ids)):
            out[str(re.vocab[e])] = np.asarray(b.coefficients, dtype=np.float64)[i]
    return out


def assert_models_identical(a, b):
    ma, mb = model_arrays(a), model_arrays(b)
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def assert_models_close(a, b, tol=TOL):
    ma, mb = model_arrays(a), model_arrays(b)
    assert ma.keys() == mb.keys()
    for k in ma:
        np.testing.assert_allclose(ma[k], mb[k], rtol=tol, atol=tol, err_msg=k)


@pytest.fixture(scope="module")
def baseline():
    """(train, valid, port fit, JAX fit) of the uninterrupted 2-point grid."""
    arrays, varrays = _arrays(seed=1), _arrays(seed=2)
    train, valid = _data(tdata, arrays), _data(tdata, varrays)
    port = _port().fit(train, validation_data=valid)
    jax_res = _jax().fit(_data(jdata, arrays), validation_data=_data(jdata, varrays))
    for t, j in zip(port, jax_res):
        assert_models_close(t.model, j.model)
        assert abs(t.evaluation - j.evaluation) <= TOL
    return train, valid, port, jax_res


@pytest.fixture(autouse=True)
def _no_leaked_faults():
    faults.clear()
    yield
    faults.clear()


class _KillAfterSweep(Exception):
    pass


def test_kill_and_resume_bit_identical(baseline, tmp_path, monkeypatch):
    """A fit killed after grid 0's first sweep and resumed from its
    checkpoint gives the uninterrupted models bit for bit, across the
    remaining sweeps and the λ-grid warm start; a rerun after completion
    trains nothing."""
    train, valid, port, jax_res = baseline
    ckpt_dir = str(tmp_path / "ckpt")
    real = estimator_mod.run_coordinate_descent

    def killing(*args, **kwargs):
        inner = kwargs["sweep_callback"]
        assert inner is not None  # checkpointing is wired

        def cb(it, st, bs, bm):
            inner(it, st, bs, bm)
            raise _KillAfterSweep()

        return real(*args, **{**kwargs, "sweep_callback": cb})

    monkeypatch.setattr(estimator_mod, "run_coordinate_descent", killing)
    with pytest.raises(_KillAfterSweep):
        _port().fit(train, validation_data=valid, checkpoint_dir=ckpt_dir)
    monkeypatch.setattr(estimator_mod, "run_coordinate_descent", real)
    ckpt = DescentCheckpointer(ckpt_dir).load()
    assert (ckpt.grid_index, ckpt.iteration) == (0, 0)
    assert isinstance(ckpt.states["fixed"], torch.Tensor)

    est = _port()
    resumed = est.fit(train, validation_data=valid, checkpoint_dir=ckpt_dir)
    assert est.last_fit_stats["resumed_from"] == (0, 0)
    assert len(resumed) == 2 and all(r is not None for r in resumed)
    for a, b, j in zip(port, resumed, jax_res):
        assert_models_identical(a.model, b.model)
        assert a.evaluation == b.evaluation
        np.testing.assert_array_equal(a.scores, b.scores)
        assert_models_close(b.model, j.model)

    assert _port().fit(train, validation_data=valid, checkpoint_dir=ckpt_dir) == [None, None]


def test_kill_between_grid_points_resumes_with_warm_start(baseline, tmp_path):
    train, valid, port, _ = baseline
    ckpt_dir = str(tmp_path / "ckpt")

    def killer(gi, result):
        if gi == 0:
            raise _KillAfterSweep()

    with pytest.raises(_KillAfterSweep):
        _port().fit(train, validation_data=valid, checkpoint_dir=ckpt_dir, grid_callback=killer)
    # the grid callback runs before the grid-done snapshot, so the resume
    # starts after grid 0's last sweep and re-exports its model
    resumed = _port().fit(train, validation_data=valid, checkpoint_dir=ckpt_dir)
    for a, b in zip(port, resumed):
        assert_models_identical(a.model, b.model)


def test_sweep_level_resume_unit(baseline):
    """run_coordinate_descent(start_iteration=k) from the states the sweep
    callback saw after sweep k-1 continues exactly."""
    train, *_ = baseline
    est = _port(grid=(1.0,), validation=False)
    captured = {}

    def capture(it, st, bs, bm):
        captured[it] = {k: [t.clone() for t in v] if isinstance(v, list) else v.clone()
                        for k, v in st.items()}

    full = run_coordinate_descent(est._build_coordinates(train), ["fixed", "per-user"], 3,
                                  sweep_callback=capture)
    assert set(captured) == {0, 1, 2}
    resumed = run_coordinate_descent(_port(grid=(1.0,))._build_coordinates(train),
                                     ["fixed", "per-user"], 3, initial_states=captured[1],
                                     start_iteration=2)
    assert torch.equal(full.states["fixed"], resumed.states["fixed"])
    for a, b in zip(full.states["per-user"], resumed.states["per-user"]):
        assert torch.equal(a, b)
    assert torch.equal(full.total, resumed.total)


def test_crash_mid_checkpoint_write_leaves_previous_loadable(baseline, tmp_path):
    """A crash between the tmp-file write and its rename (the
    checkpoint.replace fault point) leaves the previous snapshot
    loadable, and the resumed fit is bit-exact."""
    train, *_ = baseline
    want = _port(grid=(1.0,), validation=False).fit(train)[0]
    ckpt_dir = str(tmp_path / "ckpt")
    # no validation: one npz per save, so occurrence 2 is sweep 1's write
    with faults.injected("checkpoint.replace@2=crash"):
        with pytest.raises(InjectedCrash):
            _port(grid=(1.0,), validation=False).fit(train, checkpoint_dir=ckpt_dir)
    assert not [n for n in os.listdir(ckpt_dir) if n.endswith(".tmp")]
    ckpt = DescentCheckpointer(ckpt_dir).load()
    assert (ckpt.grid_index, ckpt.iteration) == (0, 0)
    got = _port(grid=(1.0,), validation=False).fit(train, checkpoint_dir=ckpt_dir)[0]
    assert_models_identical(want.model, got.model)


def test_fingerprint_change_is_a_hard_error_on_resume(baseline, tmp_path):
    train, valid, *_ = baseline
    ckpt_dir = str(tmp_path / "ckpt")
    _port(grid=(1.0,), iters=1).fit(train, validation_data=valid, checkpoint_dir=ckpt_dir)
    with pytest.raises(ValueError, match="different training configuration"):
        _port(grid=(2.0,), iters=1).fit(train, validation_data=valid, checkpoint_dir=ckpt_dir)
    with pytest.raises(ValueError, match="different training configuration"):
        _port(grid=(1.0,), iters=1, seed=3).fit(train, validation_data=valid,
                                                checkpoint_dir=ckpt_dir)


# ---------------------------------------------------------------------------
# durability: retention, checksums, fallback (numpy and tensor states)
# ---------------------------------------------------------------------------


def _states(i):
    return {
        "fixed": np.full(5, float(i)),
        "per-user": [np.full((3, 2), float(i)), np.ones(2) * i],
    }


def test_tensor_states_round_trip_in_one_host_copy():
    states = {
        "fixed": torch.arange(5, dtype=torch.float64),
        "per-user": [torch.ones(3, 2, dtype=torch.float64), torch.zeros(4, dtype=torch.float64)],
        "mf": (torch.full((2, 3), 2.0), torch.full((4, 3), 3.0)),
    }
    flat = _flatten_states(states)
    assert list(flat) == ["fixed/0", "per-user/0", "per-user/1", "mf/0", "mf/1"]
    assert flat["per-user/0"].shape == (3, 2) and flat["mf/1"].dtype == np.float32
    np.testing.assert_array_equal(flat["fixed/0"], np.arange(5.0))


def test_tensor_checkpoint_loads_on_the_named_device(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    states = {"fixed": torch.arange(4, dtype=torch.float64),
              "mf": (torch.ones(2, 2), torch.zeros(3, 2))}
    ck.save(1, 2, states, None, None, fingerprint="fp")
    got = DescentCheckpointer(str(tmp_path)).load(expect_fingerprint="fp", device="cpu")
    assert (got.grid_index, got.iteration) == (1, 2)
    assert isinstance(got.states["mf"], tuple)
    assert got.states["fixed"].dtype == torch.float64
    assert torch.equal(got.states["fixed"], states["fixed"])
    assert torch.equal(got.states["mf"][1], states["mf"][1])


def test_retention_keeps_last_k_snapshots(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    for i in range(5):
        ck.save(0, i, _states(i), None, None, fingerprint="fp")
    assert ck._existing_seqs() == [3, 4]
    loaded = ck.load(expect_fingerprint="fp")
    assert loaded.iteration == 4
    np.testing.assert_array_equal(loaded.states["fixed"], _states(4)["fixed"])


def test_checkpoint_keep_env_override(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_CHECKPOINT_KEEP", "4")
    assert DescentCheckpointer(str(tmp_path)).keep == 4
    monkeypatch.setenv("PHOTON_CHECKPOINT_KEEP", "0")
    with pytest.raises(ValueError):
        DescentCheckpointer(str(tmp_path / "x"))


def test_corrupt_head_falls_back_to_previous_snapshot(tmp_path, caplog, monkeypatch):
    monkeypatch.setenv("PHOTON_CHECKPOINT_KEEP", "3")
    ck = DescentCheckpointer(str(tmp_path))
    for i in range(3):
        ck.save(0, i, _states(i), None, None)
    newest = ck._state_path(2)
    raw = open(newest, "rb").read()
    with open(newest, "wb") as f:
        f.write(raw[: len(raw) // 2])
    loaded = DescentCheckpointer(str(tmp_path)).load()
    assert loaded.iteration == 1
    assert "falling back" in caplog.text


def test_checksum_mismatch_is_corruption(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    ck.save(0, 0, _states(0), None, None)
    ck.save(0, 1, _states(1), None, None)
    newest = ck._state_path(1)
    raw = bytearray(open(newest, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    with open(newest, "wb") as f:
        f.write(bytes(raw))
    assert DescentCheckpointer(str(tmp_path)).load().iteration == 0


def test_all_snapshots_corrupt_raises_typed_error(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    ck.save(0, 0, _states(0), None, None)
    with open(ck._state_path(0), "wb") as f:
        f.write(b"not an npz")
    with pytest.raises(CheckpointCorruptError) as ei:
        DescentCheckpointer(str(tmp_path)).load()
    assert "descent-state-00000000.npz" in str(ei.value)
    assert ei.value.path


def test_stray_tmp_files_and_orphans_are_pruned(tmp_path, monkeypatch):
    monkeypatch.setenv("PHOTON_CHECKPOINT_KEEP", "1")
    ck = DescentCheckpointer(str(tmp_path))
    ck.save(0, 0, _states(0), None, None)
    (tmp_path / "zzz-leftover.tmp").write_bytes(b"\x00" * 64)
    assert DescentCheckpointer(str(tmp_path)).load().iteration == 0
    # a killed writer's orphan npz below the retention cutoff
    (tmp_path / "descent-best-00000000.npz").write_bytes(b"x")
    ck.save(0, 1, _states(1), None, None)
    assert sorted(os.listdir(tmp_path)) == [
        MANIFEST, "descent-manifest-00000001.json", "descent-state-00000001.npz"]


def test_fingerprint_mismatch_is_hard_error_not_fallback(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    ck.save(0, 0, _states(0), None, None, fingerprint="fp-a")
    with pytest.raises(ValueError, match="different training"):
        DescentCheckpointer(str(tmp_path)).load(expect_fingerprint="fp-b")


def test_resumed_run_does_not_overwrite_loaded_snapshot(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    ck.save(0, 0, _states(0), None, None)
    ck2 = DescentCheckpointer(str(tmp_path))  # a relaunched run
    ck2.save(0, 1, _states(1), None, None)
    assert ck2._existing_seqs() == [0, 1]
    assert DescentCheckpointer(str(tmp_path)).load().iteration == 1
    head = json.loads((tmp_path / MANIFEST).read_text())
    assert head["seq"] == 1 and set(head["checksums"]) == {"state"}


def test_best_snapshot_round_trips(tmp_path):
    ck = DescentCheckpointer(str(tmp_path))
    ck.save(1, 0, _states(3), _states(2), 0.75)
    got = DescentCheckpointer(str(tmp_path)).load()
    assert got.best_metric == 0.75
    np.testing.assert_array_equal(got.best_states["per-user"][0], _states(2)["per-user"][0])


# ---------------------------------------------------------------------------
# model snapshots: the store, warm starts, and the crossing between packages
# ---------------------------------------------------------------------------


def test_model_store_round_trip_prune_and_fallback(baseline, tmp_path):
    _, _, port, _ = baseline
    model = port[0].model
    d = str(tmp_path / "store")
    store = ModelCheckpointStore(d)
    assert store.load_latest() is None
    assert [store.save(model) for _ in range(3)] == [0, 1, 2]
    names = sorted(os.listdir(d))
    assert "model-00000000.npz" not in names and "model-00000002.npz" in names
    loaded, seq = store.load_latest()
    assert seq == 2
    assert_models_identical(model, loaded)
    with open(os.path.join(d, "model-00000002.npz"), "r+b") as f:
        f.write(b"\x00" * 16)
    loaded, seq = ModelCheckpointStore(d).load_latest()
    assert seq == 1
    assert_models_identical(model, loaded)


def test_model_store_refuses_matrix_factorization(tmp_path):
    from photon_tpu_torch.game.model import GameModel, MatrixFactorizationModel

    mf = MatrixFactorizationModel(
        row_entity_type="u", col_entity_type="i", row_vocab=np.array(["a", "b"]),
        col_vocab=np.array(["x", "y", "z"]), row_factors=np.ones((2, 2)),
        col_factors=np.ones((3, 2)),
    )
    with pytest.raises(ValueError, match="FE and RE only"):
        ModelCheckpointStore(str(tmp_path)).save(
            GameModel(coordinates={"mf": mf}, task=TTask.LOGISTIC_REGRESSION))


@pytest.mark.parametrize("first", ["jax", "port"])
def test_model_snapshots_cross_between_packages(baseline, tmp_path, first):
    """JAX → port → JAX (and port → JAX → port): each store loads the
    other's snapshot with equal arrays, and saves it back unchanged."""
    _, _, port, jax_res = baseline
    stores = {"jax": JStore, "port": ModelCheckpointStore}
    second = "port" if first == "jax" else "jax"
    model = (jax_res if first == "jax" else port)[1].model
    stores[first](str(tmp_path / "a")).save(model)
    crossed, _ = stores[second](str(tmp_path / "a")).load_latest()
    assert_models_identical(model, crossed)
    stores[second](str(tmp_path / "b")).save(crossed)
    back, _ = stores[first](str(tmp_path / "b")).load_latest()
    assert_models_identical(model, back)
    with np.load(tmp_path / "a" / "model-00000000.npz") as a, \
            np.load(tmp_path / "b" / "model-00000000.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_warm_start_equals_initial_model_and_saves_next_snapshot(baseline, tmp_path):
    train, valid, port, _ = baseline
    d = str(tmp_path / "daily")
    ModelCheckpointStore(d).save(port[0].model)
    warm = _port(grid=(1.0,), iters=1).fit(train, validation_data=valid, warm_start=d,
                                           model_checkpoint_dir=d)[0]
    loaded, _ = ModelCheckpointStore(str(tmp_path / "daily")).load_latest()
    assert_models_identical(warm.model, loaded)
    explicit = _port(grid=(1.0,), iters=1).fit(train, validation_data=valid,
                                               initial_model=port[0].model)[0]
    assert_models_identical(warm.model, explicit.model)


def test_warm_start_empty_directory_cold_starts_and_conflicts(baseline, tmp_path):
    train, _, port, _ = baseline
    d = str(tmp_path / "empty")
    os.makedirs(d)
    cold = _port(grid=(1.0,), iters=1, validation=False)
    res = cold.fit(train, warm_start=d)
    assert res[0].model is not None
    assert ModelCheckpointStore(d).load_latest() is None
    with pytest.raises(ValueError, match="not both"):
        cold.fit(train, warm_start=d, initial_model=port[0].model)
