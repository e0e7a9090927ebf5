"""The port's mesh (photon_tpu_torch/parallel/) against the JAX package's.

The port runs a mesh as one process per rank over ``torch.distributed``;
here the ranks are CPU processes in one Gloo group (tests/
torch_mesh_worker.py, no JAX in them), spawned once per world size for
the module: two ranks run the 2x1 and 1x2 meshes, four the 2x2 mesh. The
JAX side runs in this process on ``make_mesh(num_data=D, num_entity=E,
devices=jax.devices()[:D*E])`` of the 8 virtual CPU devices. Everything
is float64.

Tolerances: a meshed fit sums its fixed-effect gradients and its loss
over ranks, and a rank's random-effect lane batch is smaller than the
unmeshed bucket, so meshed and unmeshed fits differ by roundoff (1e-9,
JAX's own tolerance for the same comparison, tests/test_mesh_fit.py).
A world of one runs the same operations as no mesh: bit for bit.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from filelock import FileLock

import torch_mesh_worker as worker
from photon_tpu.game import config as jcfg
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.game.estimator import shard_shape_census as j_census
from photon_tpu.game.streaming import StreamingModeError as JStreamingModeError
from photon_tpu.ops.sparse_windows import build_column_windows as j_build_windows
from photon_tpu.optimize import problem as jprob
from photon_tpu.optimize.common import OptimizerConfig as JOptConfig
from photon_tpu.parallel import mesh as jmesh
from photon_tpu.parallel.sparse import pad_windows_for_mesh as j_pad
from photon_tpu.parallel.sparse import shard_windows as j_shard_windows
from photon_tpu.parallel.sparse import sharded_windowed_rmatvec as j_sharded_rmatvec
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch import obs
from photon_tpu_torch.game import GameScorer
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.streaming import StreamingModeError
from photon_tpu_torch.ops.sparse_windows import column_windows_from_numpy
from photon_tpu_torch.parallel import mesh as tmesh
from photon_tpu_torch.parallel import sparse as tsparse
from photon_tpu_torch.util import faults

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs the 8-virtual-device platform"
)

SHAPES = [(2, 1), (1, 2), (2, 2)]
#: (D, E, with MF): the 2x2 fit also carries the user × item factors
FITS = [(2, 1, False), (1, 2, False), (2, 2, True)]
FIT_IDS = ["2x1", "1x2", "2x2-mf"]
TOL = 1e-9


def _once(tmp_path_factory, name: str, build) -> str:
    """``build(directory)`` once per test session, by whichever test
    worker asks first (pytest-xdist workers share the parent of their
    base temporary directories; a lock file orders them); the directory.
    A build that failed fails every later asker with its error at once."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    out = base / name
    with FileLock(str(base / f"{name}.lock")):
        if (out / "failed").exists():
            raise RuntimeError(f"{name} failed to build: {(out / 'failed').read_text()}")
        if not (out / "done").exists():
            out.mkdir(exist_ok=True)
            try:
                build(str(out))
            except Exception as e:
                (out / "failed").write_text(f"{type(e).__name__}: {e}"[-4000:])
                raise
            (out / "done").touch()
    return str(out)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank task of the module, spawned once per world size."""
    def build(out):
        worker.spawn(2, out, [("fit", 2, 1), ("fit", 1, 2), ("checkpoint", 2, 1),
                              ("stale", 1, 2), ("write_fault", 2, 1), ("rmatvec", 2, 1)])
        worker.spawn(4, out, [("fit_mf", 2, 2), ("rmatvec", 2, 2)])

    return _once(tmp_path_factory, "mesh-ranks", build)


@pytest.fixture(scope="module")
def a7_ranks(tmp_path_factory):
    """The two-rank tasks of the rest of the mesh, spawned once for the
    session (tests/test_torch_{cache,fleet,mesh}.py read them): the live
    world's ingest shards on five part files, a meshed training driver,
    the fleet plane, the lint's ``--programs``."""
    from test_cache import _write_parts

    def build(out):
        _write_parts(os.path.join(out, "parts"), seed=3)
        worker.spawn(2, out, [("ingest_live", 2, 1), ("mesh_driver", 2, 1), ("fleet", 2, 1),
                              ("programs", 1, 2)])

    return _once(tmp_path_factory, "a7-ranks", build)


def _jax_estimator(mesh=None, mf=False):
    coords = worker.configs(jcfg, jprob, JOptConfig, JTask, mf=mf)
    return JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configs=coords,
                      update_sequence=list(coords), descent_iterations=2, dtype=jnp.float64,
                      mesh=mesh, keep_coordinates=True)


def _jax_mesh(d, e):
    return jmesh.make_mesh(num_data=d, num_entity=e, devices=jax.devices()[: d * e])


@pytest.fixture(scope="module")
def jax_fits(tmp_path_factory):
    """(D, E, mf) → JAX's meshed fit: its model's arrays, its shard census
    and its model's scores on the training rows (carried into the port by
    convert.game_model_from_numpy and scored by the port's GameScorer).
    Windows are forced on the JAX side, as the port's configs force them."""
    from test_torch_game import _numpy_model

    def build(out):
        data = worker.port_data()
        fits = {}
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("PHOTON_SPARSE_WINDOWS", "1")
            for d, e, mf in FITS:
                mesh = _jax_mesh(d, e)
                est = _jax_estimator(mesh, mf)
                res = est.fit(worker.game_data(jdata, worker.mesh_arrays()))[0]
                scorer = GameScorer(_numpy_model(res.model), device="cpu", dtype=torch.float64,
                                    batch_rows=256)
                fits[(d, e, mf)] = {
                    "model": worker.model_arrays(res.model),
                    "census": j_census(est.last_coordinates, mesh),
                    "scores": scorer.score_data(data) - data.offsets,
                }
        with open(os.path.join(out, "fits.pkl"), "wb") as f:
            pickle.dump(fits, f)
        # the meshed programs' executables would stay mapped in this test
        # worker for the rest of the session (see test_torch_game.py)
        jax.clear_caches()

    with open(os.path.join(_once(tmp_path_factory, "mesh-jax", build), "fits.pkl"), "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def unmeshed():
    """mf → the port's fit without a mesh."""
    return {mf: worker.port_estimator(mf=mf).fit(worker.port_data())[0] for mf in (False, True)}


@pytest.fixture
def world_of_one():
    mesh = tmesh.make_mesh(1, 1, device="cpu")
    yield mesh
    tmesh.destroy_mesh(mesh)


def _assert_models_close(want: dict, got: dict, tol=TOL):
    assert want.keys() == got.keys()
    for cid, w in want.items():
        g = got[cid]
        if isinstance(w, np.ndarray):
            np.testing.assert_allclose(g, w, rtol=0, atol=tol, err_msg=cid)
        elif "rows" in w:
            np.testing.assert_array_equal(g["row_vocab"], w["row_vocab"])
            for k in ("rows", "cols"):
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=tol, err_msg=cid)
        else:
            assert w.keys() == g.keys(), cid
            for key in w:
                np.testing.assert_allclose(g[key], w[key], rtol=0, atol=tol,
                                           err_msg=f"{cid} {key}")


# ---------------------------------------------------------------------------
# mesh specs, topology, padding
# ---------------------------------------------------------------------------

#: (kind, env PHOTON_MESH, spec): "{W}" is the package's world (1 rank
#: here for the port, 8 devices for JAX)
SPEC_CASES = [
    ("parse", None, "1x8"), ("parse", None, "8"), ("parse", None, "auto"),
    ("parse", None, " 2X4 "), ("parse", None, "x"), ("parse", None, "1x0"),
    ("parse", None, "abc"), ("parse", None, "-1"), ("parse", None, "off"),
    ("resolve", None, None), ("resolve", "off", "1x{W}"), ("resolve", "1x{W}", "{W}x2"),
    ("resolve", None, "auto"), ("resolve", None, "{W}x2"), ("resolve", None, "{W}"),
    ("fingerprint", None, None),
]


def _outcome(fn):
    try:
        return ("ok", fn())
    except ValueError as e:
        return ("ValueError", str(e))


@pytest.mark.parametrize("kind,env,spec", SPEC_CASES,
                         ids=[f"{k}-{e}-{s}" for k, e, s in SPEC_CASES])
def test_mesh_spec_and_fingerprint_match_jax(monkeypatch, kind, env, spec):
    """``parse_mesh_spec``, ``resolve_mesh`` (``PHOTON_MESH`` over the
    flag) and ``mesh_fingerprint`` give JAX's results and errors, with the
    world each package has."""
    def run(pkg, world):
        def fill(s):
            return None if s is None else s.replace("{W}", str(world))

        if env is None:
            monkeypatch.delenv("PHOTON_MESH", raising=False)
        else:
            monkeypatch.setenv("PHOTON_MESH", fill(env))
        if kind == "parse":
            return _outcome(lambda: pkg.parse_mesh_spec(spec))
        if kind == "fingerprint":
            return _outcome(lambda: pkg.mesh_fingerprint(None))
        kw = {"device": "cpu"} if pkg is tmesh else {}

        def resolve():
            mesh = pkg.resolve_mesh(fill(spec), **kw)
            fp = pkg.mesh_fingerprint(mesh)
            if pkg is tmesh:
                tmesh.destroy_mesh(mesh)
            return fp

        return _outcome(resolve)

    got, want = run(tmesh, 1), run(jmesh, len(jax.devices()))
    if kind == "resolve" and want[0] == "ok" and want[1] is not None:
        # the same topology up to each package's world size
        w = len(jax.devices())
        want = ("ok", (want[1][0], tuple(1 if s == w else s for s in want[1][1])))
    if kind == "resolve" and want[0] == "ValueError":
        want = ("ValueError", want[1].replace(str(len(jax.devices())), "1"))
    assert got == want
    assert not dist.is_initialized()


def _j_windows_numpy(windows):
    return {f: np.asarray(getattr(windows, f)) for f in ("rows", "lcols", "vals", "inst2win",
                                                         "iota")}


@pytest.mark.parametrize("shards", [1, 2, 3, 4])
def test_pad_windows_for_mesh_matches_jax(shards):
    """The inert padding instances, bit for bit, and the instance range
    each shard keeps."""
    idx, val, d, _ = worker.rmatvec_layout()
    jw = j_build_windows(idx, val, d, **worker.RMATVEC_BUILD)
    tw = column_windows_from_numpy(_j_windows_numpy(jw), dtype=torch.float64)
    jp = _j_windows_numpy(j_pad(jw, shards, d))
    tp = tsparse.pad_windows_for_mesh(tw, shards, d)
    for f in ("rows", "lcols", "vals", "inst2win", "iota"):
        np.testing.assert_array_equal(getattr(tp, f).numpy(), jp[f], err_msg=f)
    w_inst = tp.rows.shape[0]
    assert w_inst % shards == 0
    ranges = [tsparse.shard_range(w_inst, shards, s) for s in range(shards)]
    assert ranges[0][0] == 0 and ranges[-1][1] == w_inst
    assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("d,e", [(2, 1), (2, 2)], ids=["2-ranks", "4-ranks"])
def test_sharded_windowed_rmatvec_matches_jax(ranks, d, e):
    """The kernel's plain version on each rank's instance shard plus one
    all_reduce equals JAX's shard_map reduction on as many devices."""
    idx, val, dim, r = worker.rmatvec_layout()
    mesh = _jax_mesh(d, e)
    jw = j_build_windows(idx, val, dim, **worker.RMATVEC_BUILD)
    with mesh:
        want = np.asarray(jax.jit(lambda w_, r_: j_sharded_rmatvec(w_, r_, dim, mesh))(
            j_shard_windows(jw, mesh, dim), jnp.asarray(r)))
    for rank in range(d * e):
        got = worker.load(ranks, "rmatvec", d, e, rank)
        np.testing.assert_allclose(got["out"], want, rtol=0, atol=1e-12)
    assert got["shard_instances"] * d * e >= np.asarray(jw.rows).shape[0]


# ---------------------------------------------------------------------------
# entity order and the shard census
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("e", [1, 7, 40])
def test_shard_major_entity_order_matches_jax(e, shards):
    loads = np.random.default_rng(e * 10 + shards).integers(1, 50, size=e).astype(np.float64)
    np.testing.assert_array_equal(
        tdata._shard_major_entity_order(loads, shards),
        jdata._shard_major_entity_order(loads, shards),
    )


@pytest.mark.parametrize("d,e", SHAPES, ids=[f"{d}x{e}" for d, e in SHAPES])
def test_re_buckets_shard_major_match_jax(d, e):
    """The random-effect datasets built for ``e`` entity shards hold JAX's
    buckets, entity order included."""
    jd, td = (worker.game_data(pkg, worker.mesh_arrays()) for pkg in (jdata, tdata))
    jd, td = jdata.pad_game_data(jd, d * e), tdata.pad_game_data(td, d * e)
    jc = worker.configs(jcfg, jprob, JOptConfig, JTask)
    tc = worker.port_estimator().coordinate_configs
    for cid in ("user", "item"):
        jds = jdata.build_random_effect_dataset(jd, jc[cid], entity_shards=e)
        tds = tdata.build_random_effect_dataset(td, tc[cid], entity_shards=e)
        assert len(tds.buckets) == len(jds.buckets)
        for jb, tb in zip(jds.buckets, tds.buckets):
            for f in ("entity_ids", "sample_pos", "score_slot", "score_pos", "features"):
                np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f), err_msg=f)


@pytest.mark.parametrize("d,e", SHAPES, ids=[f"{d}x{e}" for d, e in SHAPES])
def test_shard_shape_census_matches_jax(ranks, jax_fits, d, e):
    mf = (d, e, True) in FITS
    want = jax_fits[(d, e, mf)]["census"]
    for rank in range(d * e):
        got = _port_fit(ranks, d, e, mf, rank)["census"]
        assert got == {cid: {**row, "levels": [tuple(lv) for lv in row["levels"]]}
                       for cid, row in want.items()}


# ---------------------------------------------------------------------------
# the meshed fit
# ---------------------------------------------------------------------------


def _port_fit(ranks, d, e, mf, rank=0):
    return worker.load(ranks, "fit_mf" if mf else "fit", d, e, rank)


@pytest.mark.parametrize("d,e,mf", FITS, ids=FIT_IDS)
def test_meshed_fit_matches_jax(ranks, jax_fits, d, e, mf):
    """Coefficients entity by entity, and the fit's scores against JAX's
    meshed model carried over (convert.py) and scored by the port."""
    want = jax_fits[(d, e, mf)]
    for rank in range(d * e):  # every rank returns the same models
        got = _port_fit(ranks, d, e, mf, rank)
        _assert_models_close(want["model"], got["model"])
        np.testing.assert_allclose(got["scores"], want["scores"], rtol=0, atol=TOL)


@pytest.mark.parametrize("d,e,mf", FITS, ids=FIT_IDS)
def test_meshed_fit_matches_unmeshed(ranks, unmeshed, d, e, mf):
    got = _port_fit(ranks, d, e, mf)
    res = unmeshed[mf]
    assert got["mesh"] == (("data", "entity"), (d, e))
    _assert_models_close(worker.model_arrays(res.model), got["model"])
    assert got["scores"].shape == (worker.N,)
    np.testing.assert_allclose(got["scores"], res.scores, rtol=0, atol=TOL)


@pytest.mark.parametrize("mf", [False, True], ids=["base", "mf"])
def test_world_of_one_equals_unmeshed_bit_for_bit(unmeshed, world_of_one, mf):
    res = worker.port_estimator(mf=mf).fit(worker.port_data(), mesh=world_of_one)[0]
    _assert_models_close(worker.model_arrays(unmeshed[mf].model),
                         worker.model_arrays(res.model), tol=0.0)
    np.testing.assert_array_equal(res.scores, unmeshed[mf].scores)


@pytest.mark.parametrize("d,e", SHAPES, ids=[f"{d}x{e}" for d, e in SHAPES])
def test_re_solve_makes_no_collective(ranks, d, e):
    """A random effect's solve shares nothing between entity shards: no
    collective on any rank (the port's form of JAX's
    test_re_train_program_has_no_collectives); its score sums the shards'
    pieces over the entity axis."""
    for rank in range(d * e):
        got = _port_fit(ranks, d, e, (d, e, True) in FITS, rank)
        assert got["re_train_collectives"] and not any(got["re_train_collectives"])
        assert all(n == 1 for n in got["re_score_collectives"])


# ---------------------------------------------------------------------------
# checkpoints, streaming, placement faults
# ---------------------------------------------------------------------------


def test_meshed_checkpoint_resumes_bit_exact(ranks):
    for rank in range(2):
        got = worker.load(ranks, "checkpoint", 2, 1, rank)
        assert got["stopped"] and got["resumed_from"] == (0, 0)
        _assert_models_close(got["full"], got["resumed"], tol=0.0)
        np.testing.assert_array_equal(got["full_scores"], got["resumed_scores"])


def test_checkpoint_of_another_topology_is_refused(ranks):
    """A checkpoint written under 2x1 holds the topology in its
    fingerprint; resuming it under 1x2 is the stale-config error."""
    ckpt = worker.load(ranks, "checkpoint", 2, 1)["dir"]
    with open(os.path.join(ckpt, "descent-checkpoint.json")) as f:
        assert "(('data', 'entity'), (2, 1))" in json.load(f)["fingerprint"]
    for rank in range(2):
        err = worker.load(ranks, "stale", 1, 2, rank)["error"]
        assert err is not None and "different training configuration" in err


def test_a_failed_rank0_write_stops_every_rank(ranks):
    """Only rank 0 writes a meshed fit's checkpoints; when a write fails
    there (an injected I/O error), rank 0 raises it and the other rank a
    RuntimeError at the same write, and the ranks' next collective still
    pairs up (no rank is left in the fit)."""
    got = [worker.load(ranks, "write_fault", 2, 1, rank) for rank in range(2)]
    assert [g["error"] for g in got] == ["InjectedIOError", "RuntimeError"]
    assert [g["after"] for g in got] == [2.0, 2.0]


def test_max_restarts_with_mesh_raises(world_of_one):
    """A restart would be one rank's alone: a meshed fit refuses
    ``max_restarts`` > 0 before it builds anything."""
    with pytest.raises(ValueError, match="max_restarts=1 with a mesh"):
        worker.port_estimator(max_restarts=1).fit(worker.port_data(), mesh=world_of_one)


def test_local_mesh_is_a_world_of_one_without_calls():
    """``LOCAL``, every fit's mesh when it is given none: its collectives
    hand back their input, it holds every row and entity lane, its
    fingerprint is JAX's ``None`` off the mesh, and ``on_rank0`` runs the
    write and raises its error."""
    t = torch.arange(6.0)
    assert tmesh.all_reduce_sum(t, tmesh.LOCAL) is t
    assert tmesh.gather_rows(t, tmesh.LOCAL) is t
    assert tmesh.gather_entities(t, tmesh.LOCAL) is t
    assert tmesh.row_range(tmesh.LOCAL, 6) == (0, 6)
    assert tmesh.entity_range(tmesh.LOCAL, 5) == (0, 5)
    assert tmesh.mesh_fingerprint(tmesh.LOCAL) is None
    wrote = []
    tmesh.on_rank0(tmesh.LOCAL, lambda: wrote.append(1))
    assert wrote == [1]
    with pytest.raises(OSError, match="disk full"):
        tmesh.on_rank0(tmesh.LOCAL, lambda: (_ for _ in ()).throw(OSError("disk full")))
    assert not dist.is_initialized()


def test_stream_with_mesh_raises_as_jax(world_of_one):
    with pytest.raises(StreamingModeError, match="mesh"):
        worker.port_estimator().fit(worker.port_data(), mesh=world_of_one, stream=128)
    with pytest.raises(JStreamingModeError, match="mesh"):
        _jax_estimator(_jax_mesh(1, 1)).fit(
            worker.game_data(jdata, worker.mesh_arrays()), stream=128)


def test_sparse_placement_fault_takes_the_retry_path(monkeypatch, world_of_one):
    """A transient fault at ``sparse.placement`` (inside the retried
    placement of a window shard) is retried, and the fit is the one
    without the fault, bit for bit."""
    monkeypatch.setattr(tsparse, "PLACEMENT_RETRY_POLICY",
                        dataclasses.replace(tsparse.PLACEMENT_RETRY_POLICY, base_s=0.0))
    want = worker.port_estimator().fit(worker.port_data(), mesh=world_of_one)[0]
    obs.enable()
    try:
        with faults.injected("sparse.placement@1=unavailable"):
            got = worker.port_estimator().fit(worker.port_data(), mesh=world_of_one)[0]
        counters = obs.get_registry().snapshot()["counters"]
    finally:
        obs.disable()
        obs.reset()
    assert counters.get("retry.attempts.device_put", 0) >= 1
    _assert_models_close(worker.model_arrays(want.model), worker.model_arrays(got.model),
                         tol=0.0)


def test_distribute_batch_and_fetch_global_on_a_world_of_one(world_of_one):
    """``distributed.distribute_batch`` keeps this rank's rows (all of them
    in a world of one, windows dropped), and ``fetch_global`` is a host
    float64 copy that no later in-place update reaches."""
    from photon_tpu_torch.parallel import distributed
    from photon_tpu_torch.types import SparseBatch

    idx = torch.arange(12).reshape(6, 2)
    batch = SparseBatch(indices=idx, values=idx.double(), labels=torch.ones(6),
                        offsets=torch.zeros(6), weights=torch.ones(6), windows="w")
    got = distributed.distribute_batch(batch, world_of_one)
    assert got.windows is None
    for f in ("indices", "values", "labels", "offsets", "weights"):
        assert torch.equal(getattr(got, f), getattr(batch, f))
    state = torch.arange(4, dtype=torch.float32)
    host = distributed.fetch_global(state, world_of_one)
    state.add_(1)
    np.testing.assert_array_equal(host, np.arange(4.0))
    assert host.dtype == np.float64


# ---------------------------------------------------------------------------
# the rest of the mesh: ingest on a mesh, the census and the contracts
# ---------------------------------------------------------------------------


def test_meshed_driver_reads_every_part_file(a7_ranks):
    """A training driver run with ``--mesh 2x1`` in a live two-rank world
    (where ``cache.ingest_shard`` resolves ``(rank, 2)``) still reads every
    part file on every rank: a meshed fit needs the whole input, so its
    reads pin ingest shard ``(0, 1)``."""
    for rank in range(2):
        got = worker.load(a7_ranks, "mesh_driver", 2, 1, rank)
        # the input directory as given (a shard would narrow it to its files)
        assert got["paths"] == [[os.path.join(a7_ranks, "parts")]] and got["rows"] == 41


@pytest.mark.parametrize("d,e,mf", FITS, ids=FIT_IDS)
def test_meshed_fit_census_passes_the_contracts(ranks, d, e, mf):
    """On every rank of the 2x1, 1x2 and 2x2 fits the census holds to each
    coordinate's ``spmd_contract()``: a random effect's solve makes no
    collective (its score folds over the entity axis), the fixed effect
    all-reduces d-vectors in its solve and gathers its [N] vectors by
    name, and every table holds only this rank's range."""
    for rank in range(d * e):
        got = _port_fit(ranks, d, e, mf, rank)
        assert got["contract_findings"] == [] and got["placement_findings"] == []
        rows = {r["program"]: r for r in got["comm"]}
        assert not {"user:train", "item:train"} & set(rows)
        assert {s["op"] for s in rows["fixed:train"]["collective_sites"]} <= {
            "all-reduce", "all-gather"}
        assert {s["site"] for s in rows["fixed:train"]["collective_sites"]
                if s["op"] == "all-gather"} == {"windowed_fe_rows"}
        if e > 1:
            assert rows["user:score"]["collective_sites"][0]["site"] == "re_score_fold"


@pytest.fixture(scope="module")
def jax_fixture_census():
    """JAX's communication census of its lint's meshed estimator fixture
    (photon_tpu/analysis/cli.py) on a 1x2 mesh of the virtual devices:
    program → the collective families in it."""
    from photon_tpu.analysis.cli import build_estimator_fixture as j_fixture
    from photon_tpu.analysis.hlo import audit_coordinates

    report = audit_coordinates(j_fixture(mesh=_jax_mesh(1, 2)))
    out = {r["program"]: {s["op"] for s in r["collective_sites"]} for r in report.comm}
    jax.clear_caches()
    return out


def test_programs_census_on_two_ranks_matches_jax(a7_ranks, jax_fixture_census):
    """``python -m photon_tpu_torch.analysis --programs`` on two Gloo CPU
    ranks (every rank on the entity axis, as JAX's gate puts its devices)
    passes on both, and its census finds collectives in the same
    coordinates as JAX's census of its meshed fixture: the fixed effect's
    solve all-reduces, the random effect's solve makes none and its score
    folds over the entity axis."""
    def coords_with(census):
        # "fit" holds what ran outside every coordinate (the export's
        # gathers), which JAX's census of compiled programs has no row for
        return {p.split(":")[0] for p, ops in census.items() if ops} - {"fit"}

    for rank in range(2):
        got = worker.load(a7_ranks, "programs", 1, 2, rank)
        assert got["rc"] == 0, got["out"]
        census = {r["program"]: {s["op"] for s in r["collective_sites"]}
                  for r in got["rows"] if r.get("kind") == "comm-census"}
        assert coords_with(census) == coords_with(jax_fixture_census) == {"global", "per_user"}
        assert census["global:train"] == {"all-reduce"}
        assert jax_fixture_census["global:sweep:False"] == {"all-reduce"}
        assert "per_user:train" not in census and census["per_user:score"] == {"all-reduce"}
        assert not [r for r in got["rows"] if r.get("check")]  # no contract finding
