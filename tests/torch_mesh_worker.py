"""The rank processes of the port's mesh tests (tests/test_torch_mesh.py).

Each rank is a process of its own in one Gloo group on the CPU, joined
through a ``file://`` store under the test's ``tmp_path`` (no TCP port to
collide with another test worker). This module imports no JAX: the
parent test process runs the JAX side and compares. ``run`` executes a
plan of tasks, each on a (data, entity) mesh over the same group, and
writes what each rank saw to ``<out>/<task>-<D>x<E>-rank<r>.pkl``.

The data and the configs are built here from a seed with numpy, for
either package: the parent passes the JAX package's config modules to
the same builders.
"""
from __future__ import annotations

import datetime
import json
import os
import pickle
import uuid

import numpy as np

N, FE_DIM, FE_NNZ, RE_D = 509, 1000, 8, 5
USERS, ITEMS = 40, 9
#: every rank's collectives fail their test after this long instead of
#: hanging the suite
GROUP_TIMEOUT_S = 120


def mesh_arrays(seed=0):
    """labels, offsets, weights, {shard: dense [N, d]} and id tags: a
    sparse high-dimensional fixed-effect shard with an intercept column,
    per-user and per-item shards (float32-exact values)."""
    rng = np.random.default_rng(seed)
    x = np.zeros((N, FE_DIM))
    cols = rng.integers(1, FE_DIM, size=(N, FE_NNZ))
    x[np.repeat(np.arange(N), FE_NNZ), cols.reshape(-1)] = rng.normal(size=N * FE_NNZ)
    x[:, 0] = 1.0
    x_user = rng.normal(size=(N, RE_D))
    x_item = rng.normal(size=(N, 3))
    u = (rng.zipf(1.4, size=N) - 1) % USERS
    u[:USERS] = rng.permutation(USERS)
    it = rng.integers(0, ITEMS, size=N)
    w_user = rng.normal(size=(USERS, RE_D))
    margin = x @ (0.3 * rng.normal(size=FE_DIM)) + np.einsum("nd,nd->n", x_user, w_user[u])
    labels = (rng.uniform(size=N) < 1 / (1 + np.exp(-margin))).astype(np.float64)
    shards = {
        name: a.astype(np.float32).astype(np.float64)
        for name, a in (("global", x), ("per_user", x_user), ("per_item", x_item))
    }
    ids = {"user": np.array([f"u{i}" for i in u]), "item": np.array([f"i{i}" for i in it])}
    return labels, 0.1 * rng.normal(size=N), rng.uniform(0.5, 2.0, size=N), shards, ids


def game_data(data_mod, arrays):
    labels, offsets, weights, shards, ids = arrays
    return data_mod.GameData.build(
        labels, {k: data_mod.CSRMatrix.from_dense(v) for k, v in shards.items()},
        offsets=offsets, weights=weights, id_tags=ids,
    )


def configs(cfg, prob, opt_config, task, *, mf=False, fe_extra=None):
    """The fit's coordinates in one package's config classes: a sparse
    fixed effect (with ``fe_extra``), per-user and per-item random
    effects and, with ``mf``, user × item factors."""
    l2 = prob.RegularizationContext(prob.RegularizationType.L2)

    def opt(iters):
        return prob.GLMProblemConfig(
            task=task.LOGISTIC_REGRESSION,
            optimizer_config=opt_config(max_iterations=iters, ls_max_iterations=8),
            regularization=l2,
        )

    out = {
        "fixed": cfg.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=opt(6), regularization_weights=(1.0,),
            representation=cfg.FeatureRepresentation.SPARSE, **(fe_extra or {}),
        ),
        "user": cfg.RandomEffectCoordinateConfig(
            random_effect_type="user", feature_shard="per_user", optimization=opt(5),
            regularization_weights=(1.0,), active_data_upper_bound=16,
        ),
        "item": cfg.RandomEffectCoordinateConfig(
            random_effect_type="item", feature_shard="per_item", optimization=opt(5),
            regularization_weights=(1.0,),
        ),
    }
    if mf:
        out["mf"] = cfg.MatrixFactorizationCoordinateConfig(
            row_entity_type="user", col_entity_type="item", optimization=opt(5),
            num_factors=2,
        )
    return out


def port_estimator(mf=False, **kw):
    import torch

    from photon_tpu_torch.game import config as cfg
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.optimize import problem as prob
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.types import TaskType

    coords = configs(cfg, prob, OptimizerConfig, TaskType, mf=mf,
                     fe_extra={"column_windows": True})
    return GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION, coordinate_configs=coords,
        update_sequence=list(coords), descent_iterations=2, dtype=torch.float64,
        device="cpu", **kw,
    )


def port_data(seed=0):
    from photon_tpu_torch.game import data as tdata

    return game_data(tdata, mesh_arrays(seed))


def model_arrays(model) -> dict:
    """A GameModel (either package) as numpy: fixed-effect means, each
    random effect's dense coefficient row by entity key, MF factors."""
    out = {}
    for cid, cm in model.coordinates.items():
        cm = getattr(cm, "model", cm)  # JAX wraps its fixed effect's GLM
        if hasattr(cm, "row_factors"):
            out[cid] = {"rows": np.asarray(cm.row_factors), "cols": np.asarray(cm.col_factors),
                        "row_vocab": np.asarray(cm.row_vocab)}
        elif hasattr(cm, "vocab"):
            lookup = cm.dense_coefficient_lookup()
            out[cid] = {str(k): np.asarray(lookup[i], dtype=np.float64)
                        for i, k in enumerate(cm.vocab)}
        else:
            out[cid] = np.asarray(cm.coefficients.means, dtype=np.float64)
    return out


# -- the tasks ---------------------------------------------------------------


def _counting_collectives():
    """Wrap torch.distributed's collectives with a counter; returns it."""
    import torch.distributed as dist

    count = {"n": 0}
    for name in ("all_reduce", "all_gather", "all_gather_into_tensor", "broadcast",
                 "reduce_scatter", "all_to_all", "barrier", "reduce", "gather", "scatter"):
        fn = getattr(dist, name, None)
        if fn is None:
            continue

        def counted(*a, _fn=fn, **kw):
            count["n"] += 1
            return _fn(*a, **kw)

        setattr(dist, name, counted)
    return count


def task_fit(mesh, out, *, mf=False):
    """The meshed fit; the collectives each random-effect solve made on
    this rank and those of its scores."""
    from photon_tpu_torch.game import coordinate as tcoord

    count = _counting_collectives()
    seen = {"train": [], "score": []}
    cls = tcoord.RandomEffectCoordinate
    train, score = cls.train, cls.score

    def spy(fn, key):
        def wrapped(self, *a, **kw):
            n0 = count["n"]
            res = fn(self, *a, **kw)
            seen[key].append(count["n"] - n0)
            return res
        return wrapped

    cls.train, cls.score = spy(train, "train"), spy(score, "score")
    try:
        est = port_estimator(mf=mf, keep_coordinates=True)
        res = est.fit(port_data(), mesh=mesh)[0]
    finally:
        cls.train, cls.score = train, score
    from photon_tpu_torch.analysis import spmd

    return {"model": model_arrays(res.model), "scores": res.scores,
            "census": est.last_fit_stats["shard_census"], "mesh": est.last_fit_stats["mesh"],
            "re_train_collectives": seen["train"], "re_score_collectives": seen["score"],
            "comm": spmd.communication_census(mesh.census),
            "contract_findings": [f.render() for f in spmd.check_contracts(
                est.last_coordinates, mesh.census)],
            "placement_findings": [f.render() for f in spmd.check_placement(
                est.last_coordinates, mesh)]}


def task_checkpoint(mesh, out):
    """A checkpointed fit stopped by a fault at its second sweep, then
    resumed from its checkpoint; the uninterrupted fit beside it."""
    from photon_tpu_torch.util import faults
    from photon_tpu_torch.util.faults import InjectedFault

    ckpt = os.path.join(out, "ckpt-" + "x".join(map(str, mesh.dims)))
    full = port_estimator().fit(port_data(), mesh=mesh)[0]
    stopped = False
    with faults.injected("descent.sweep@2=error"):
        try:
            port_estimator().fit(port_data(), mesh=mesh, checkpoint_dir=ckpt)
        except InjectedFault:
            stopped = True
    est = port_estimator()
    resumed = est.fit(port_data(), mesh=mesh, checkpoint_dir=ckpt)[0]
    return {"stopped": stopped, "resumed_from": est.last_fit_stats["resumed_from"],
            "full": model_arrays(full.model), "resumed": model_arrays(resumed.model),
            "full_scores": full.scores, "resumed_scores": resumed.scores, "dir": ckpt}


def task_stale(mesh, out):
    """A fit under this topology against the checkpoint that
    ``task_checkpoint`` wrote under the 2x1 topology."""
    try:
        port_estimator().fit(port_data(), mesh=mesh, checkpoint_dir=os.path.join(out, "ckpt-2x1"))
    except ValueError as e:
        return {"error": str(e)}
    return {"error": None}


def task_write_fault(mesh, out):
    """A checkpointed fit whose second checkpoint write fails on rank 0
    alone (an injected I/O error at ``checkpoint.write``): the error type
    each rank raised, and a collective after it (which pairs up only if
    every rank stopped at the same write)."""
    import contextlib

    import torch
    import torch.distributed as dist

    from photon_tpu_torch.util import faults

    plan = (faults.injected("checkpoint.write@2=io_error") if mesh.rank == 0
            else contextlib.nullcontext())
    error = None
    try:
        with plan:
            port_estimator().fit(port_data(), mesh=mesh,
                                 checkpoint_dir=os.path.join(out, "ckpt-write-fault"))
    except Exception as e:
        error = type(e).__name__
    after = torch.ones(1, dtype=torch.float64)
    dist.all_reduce(after)
    return {"error": error, "after": float(after)}


def rmatvec_layout(seed=6):
    """A float64 ELL with a hot column and odd sizes (padding instances
    and windows cut by shard boundaries), and a row vector."""
    rng = np.random.default_rng(seed)
    n, k, d = 513, 7, 1000
    idx = rng.integers(0, d, size=(n, k)).astype(np.int32)
    idx[:, 0] = 3  # a hot column: its window spills over many instances
    val = rng.standard_normal((n, k))
    return idx, val, d, rng.standard_normal(n)


RMATVEC_BUILD = dict(window=64, instance_cap=256, chunk=32)


def task_rmatvec(mesh, out):
    import torch

    from photon_tpu_torch.ops.sparse_windows import build_column_windows
    from photon_tpu_torch.parallel.sparse import shard_windows, sharded_windowed_rmatvec

    idx, val, d, r = rmatvec_layout()
    win = build_column_windows(idx, val, d, dtype=torch.float64, **RMATVEC_BUILD)
    shard = shard_windows(win, mesh, d)
    got = sharded_windowed_rmatvec(shard, torch.as_tensor(r), d, mesh)
    return {"out": got.numpy().copy(), "shard_instances": int(shard.rows.shape[0])}


def task_ingest_live(mesh, out):
    """What a process of the live world resolves: its ingest shard, its
    fleet coordinates and its part files of ``<out>/parts``."""
    from photon_tpu_torch.cache import ingest_shard, list_source_files
    from photon_tpu_torch.obs import fleet

    shard = ingest_shard()
    info = fleet.process_info()
    return {"shard": shard, "process": (info.index, info.count),
            "fleet_enabled": fleet.fleet_enabled(info),
            "obs_dir": fleet.obs_dir(out),
            "files": list_source_files([os.path.join(out, "parts")], shard=shard)}


#: the meshed training driver's fixed-effect command line on ``<out>/parts``
def driver_argv(out, *extra):
    return ["--input-data-directories", os.path.join(out, "parts"),
            "--root-output-directory", os.path.join(out, "driver-mesh"),
            "--training-task", "LINEAR_REGRESSION",
            "--feature-shard-configurations", "name=g,feature.bags=features,intercept=false",
            "--coordinate-configurations",
            "name=fixed,feature.shard=g,optimizer=LBFGS,max.iter=3,regularization=L2,"
            "reg.weights=1",
            "--coordinate-update-sequence", "fixed", "--coordinate-descent-iterations", "1",
            "--override-output-directory", *extra]


def task_mesh_driver(mesh, out):
    """The training driver with ``--mesh 2x1`` in the live two-rank world:
    the part files each rank's reads kept."""
    from photon_tpu_torch.cli import game_base, game_training

    seen = []
    resolve = game_base.resolve_reader

    def spied(paths, *a, **kw):
        r = resolve(paths, *a, **kw)
        seen.append(list(r.paths))
        return r

    game_base.resolve_reader = spied
    try:
        res = game_training.run(driver_argv(out, "--mesh", "2x1"), device="cpu")
    finally:
        game_base.resolve_reader = resolve
    return {"paths": seen, "rows": int(res["results"][0].scores.shape[0])}


FLEET_STALL_S, FLEET_HEARTBEAT_S = 5.0, 0.1


def task_fleet(mesh, out):
    """The fleet plane of a two-rank fit: each rank's telemetry session on
    the shared root ``<out>/fleet`` (the plane is on by itself in a world
    of two), the warm-up on, rank 1's second sweep stalled. After the fit
    rank 1 stops itself (SIGSTOP) while rank 0 waits for it in a Gloo
    collective; rank 0's watcher thread sees its heartbeat go stale and
    continues it (SIGCONT), then sees it ok again."""
    import signal
    import threading
    import time

    import torch.distributed as dist

    from photon_tpu_torch import obs
    from photon_tpu_torch.cli import game_base
    from photon_tpu_torch.util import faults

    root = os.path.join(out, "fleet")
    os.environ["PHOTON_OBS_HEARTBEAT_S"] = str(FLEET_HEARTBEAT_S)
    seen = {"stale": None, "ok_again": None, "in_barrier_when_stale": None}
    in_barrier = threading.Event()

    def watch():
        froot = os.path.join(root, "obs")
        t0 = time.monotonic()
        while time.monotonic() - t0 < 60:
            rows = {w["process_index"]: w for w in obs.fleet.workers_summary(froot)}
            w1 = rows.get(1)
            if w1 is not None and seen["stale"] is None and w1["status"] != "ok":
                seen["stale"] = w1["status"]
                seen["in_barrier_when_stale"] = in_barrier.is_set()
                os.kill(w1["pid"], signal.SIGCONT)
            elif seen["stale"] is not None and w1["status"] == "ok":
                seen["ok_again"] = True
                return
            time.sleep(0.02)

    with game_base.run_profile(root):
        if mesh.rank == 1:
            faults.install(f"descent.sweep@2=stall:{FLEET_STALL_S}")
        try:
            est = port_estimator(precompile=True, keep_coordinates=True)
            res = est.fit(port_data(), mesh=mesh)[0]
        finally:
            faults.clear()
        bd = obs.fleet.get_breakdown()
        dist.barrier()
        if mesh.rank == 1:
            os.kill(os.getpid(), signal.SIGSTOP)  # rank 0's watcher continues it
        else:
            watcher = threading.Thread(target=watch, daemon=True)
            watcher.start()
            in_barrier.set()
        dist.barrier()
        if mesh.rank == 0:
            watcher.join(60)
        paths = game_base.export_run_profile(root, meta={"task": "fleet"})
    return {"model": model_arrays(res.model), "seen": seen, "breakdown": bd,
            "paths": paths, "obs_dir": obs.fleet.obs_dir(root),
            "dispatches": [t["dispatches"] for t in res.tracker if "sweep_seconds" in t]}


def task_programs(mesh, out):
    """``python -m photon_tpu_torch.analysis --programs`` on the CPU in the
    live world: its exit code and its JSONL rows."""
    import contextlib
    import io

    from photon_tpu_torch.analysis.cli import main

    path = os.path.join(out, f"lint-{mesh.rank}.jsonl")
    with contextlib.redirect_stdout(io.StringIO()) as text:
        rc = main(["--root", os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "--programs", "--device", "cpu", "--jsonl", path])
    with open(path) as f:
        rows = [json.loads(line) for line in f]
    return {"rc": rc, "rows": [r for r in rows if r.get("engine") != "ast"],
            "out": text.getvalue()}


TASKS = {
    "fit": task_fit,
    "fit_mf": lambda mesh, out: task_fit(mesh, out, mf=True),
    "checkpoint": task_checkpoint,
    "stale": task_stale,
    "write_fault": task_write_fault,
    "rmatvec": task_rmatvec,
    "ingest_live": task_ingest_live,
    "mesh_driver": task_mesh_driver,
    "fleet": task_fleet,
    "programs": task_programs,
}


def run(rank: int, world: int, store: str, out: str, plan) -> None:
    """Join the group, run ``plan`` ([(task, D, E), ...]) in order, each on
    a D×E mesh, and write each task's result of this rank."""
    import torch.distributed as dist

    from photon_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("gloo", init_method=f"file://{store}", rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        for task, d, e in plan:
            mesh = make_mesh(d, e, device="cpu")
            result = TASKS[task](mesh, out)
            with open(os.path.join(out, f"{task}-{d}x{e}-rank{rank}.pkl"), "wb") as f:
                pickle.dump(result, f)
    finally:
        dist.destroy_process_group()


def spawn(world: int, out: str, plan, timeout_s: float = 300.0) -> None:
    """Run ``plan`` on ``world`` rank processes; raises if a rank fails or
    the plan outlasts ``timeout_s`` (its processes are then killed)."""
    import time

    import torch.multiprocessing as mp

    # a store file of its own: a file an earlier group left behind would
    # hand this group's ranks that group's stale addresses
    store = os.path.join(out, f"store-{uuid.uuid4().hex}")
    ctx = mp.start_processes(run, args=(world, store, out, plan), nprocs=world, join=False,
                             start_method="spawn")
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh plan {plan} outlasted {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()


def load(out: str, task: str, d: int, e: int, rank: int = 0):
    with open(os.path.join(out, f"{task}-{d}x{e}-rank{rank}.pkl"), "rb") as f:
        return pickle.load(f)
