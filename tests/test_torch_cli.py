"""Port parity: the command-line drivers against the JAX package.

Both packages run the same command lines on test_cli's fixture (n=400
training and n=200 validation rows, a global and a per-user coordinate)
with their fits pinned to float64 here (both drivers fit at float32 by
default; the test swaps in float64 ``GameEstimator``/``train_glm_grid``
and ``NormalizationContext.build``, no package code changes). Held equal:
the parsers (flags and parsed configs), the training summary (best index,
evaluations within 1e-9), saved coefficients (rtol 1e-7), the scoring
driver's scores (rtol 1e-7 on the host path, 1e-5 through the float32
device scorer) and evaluations, the lifecycle events, the legacy driver
on LIBSVM and Avro, and the two index tools. The training driver's
recovery and tuning flags run against JAX's driver too: a run killed by
the fault plan and resumed from its checkpoints, supervised restarts
after an injected NaN, warm starts from model snapshots, RANDOM and
BAYESIAN tuning, priors with a shrunk search box, and saved
observations. The feature cache runs through both packages' drivers: a
cold then warm ``--feature-cache use`` scoring run (JAX's driver opening
the port's cache), caches built by the port's cache tool feeding both
training drivers with ``require``, and the scoring drivers' degrade
escape after an injected producer death. Every flag whose module is not
ported raises NotImplementedError naming itself.
"""
from __future__ import annotations

import contextlib
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from photon_tpu.cli import feature_indexing as j_fi
from photon_tpu.cli import game_scoring as j_gs
from photon_tpu.cli import game_training as j_gt
from photon_tpu.cli import legacy_driver as j_ld
from photon_tpu.cli import name_term_bags as j_ntb
from photon_tpu.cli import parsing as j_parse
from photon_tpu.util import faults as j_faults
from photon_tpu.data import dataset as j_dataset
from photon_tpu.data.native_index import load_partitioned_store as j_load_store
from photon_tpu.io.avro import read_avro_dir, write_avro_file
from photon_tpu.io.schemas import TRAINING_EXAMPLE_AVRO
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.cli import feature_indexing as t_fi
from photon_tpu_torch.cli import game_scoring as t_gs
from photon_tpu_torch.cli import game_training as t_gt
from photon_tpu_torch.cli import legacy_driver as t_ld
from photon_tpu_torch.cli import name_term_bags as t_ntb
from photon_tpu_torch.cli import parsing as t_parse
from photon_tpu_torch.data.native_index import load_partitioned_store as t_load_store
from photon_tpu_torch.types import TaskType as TTask
from photon_tpu_torch.util import faults as t_faults
from photon_tpu_torch.util.events import EventEmitter as TEmitter
from test_cli import SHARD_ARG, _make_records, _write_libsvm

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _release_compiled_programs():
    """Drop the JAX programs this module compiled when it ends: each keeps
    memory maps of its code, and one process running many such modules
    would reach the kernel's limit on maps (vm.max_map_count)."""
    yield
    jax.clear_caches()
    gc.collect()



# ---------------------------------------------------------------------------
# float64 on both sides, event recording
# ---------------------------------------------------------------------------


def _f64_norm(cls, dtype):
    """NormalizationContext stand-in whose ``build`` fits at ``dtype``."""
    return type(
        "Float64Normalization",
        (),
        {
            "build": staticmethod(functools.partial(cls.build, dtype=dtype)),
            "identity": staticmethod(cls.identity),
        },
    )


def _recording_emitter(cls, sink):
    class Recording(cls):
        def emit(self, name, **payload):
            sink.append((name, payload))
            super().emit(name, **payload)

    return Recording


def _listening(sink):
    """A port emitter (the drivers' ``events=``) recording (name, payload)."""
    emitter = TEmitter()
    emitter.register(lambda e: sink.append((e.name, e.payload)))
    return emitter


@contextlib.contextmanager
def float64_drivers(jax_events=None):
    """Both packages' drivers fit at float64; with ``jax_events`` (a list),
    the JAX drivers' lifecycle events are recorded there (the port's are
    heard through ``run(..., events=)``)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod, dtype in ((j_gt, jnp.float64), (t_gt, torch.float64)):
            mp.setattr(mod, "GameEstimator", functools.partial(mod.GameEstimator, dtype=dtype))
            mp.setattr(mod, "NormalizationContext", _f64_norm(mod.NormalizationContext, dtype))
        for mod, dtype in ((j_ld, jnp.float64), (t_ld, torch.float64)):
            mp.setattr(mod, "train_glm_grid", functools.partial(mod.train_glm_grid, dtype=dtype))
            mp.setattr(mod, "NormalizationContext", _f64_norm(mod.NormalizationContext, dtype))
        # JAX's legacy driver scores its validation batch at the batch
        # functions' float32 default (imported inside validate_models)
        for name in ("to_device_batch", "to_device_sparse_batch"):
            fn = getattr(j_dataset, name)
            mp.setattr(j_dataset, name, functools.partial(fn, dtype=jnp.float64))
        if jax_events is not None:
            for mod in (j_gt, j_gs, j_ld):
                mp.setattr(mod, "EventEmitter", _recording_emitter(mod.EventEmitter, jax_events))
        yield


def _both(jax_run, port_run, argv, out: Path, **port_kw):
    """One command line through both packages, outputs under out/jax and
    out/port."""
    def with_out(sub):
        return [str(out / sub) if a == "{out}" else a for a in argv]

    j = jax_run(with_out("jax"))
    t = port_run(with_out("port"), device="cpu", **port_kw)
    return j, t


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def avro_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli-avro")
    for name, seed, n in (("train", 0, 400), ("valid", 1, 200)):
        (root / name).mkdir()
        write_avro_file(root / name / "part-00000.avro", TRAINING_EXAMPLE_AVRO,
                        _make_records(seed, n=n))
    return root


TRAIN_ARGS = [
    "--training-task", "LOGISTIC_REGRESSION",
    "--feature-shard-configurations", SHARD_ARG,
    "--coordinate-configurations",
    "name=global,feature.shard=global,optimizer=LBFGS,max.iter=30,"
    "regularization=L2,reg.weights=1|10",
    "--coordinate-configurations",
    "name=per-user,random.effect.type=userId,feature.shard=global,"
    "max.iter=15,regularization=L2,reg.weights=1",
    "--coordinate-update-sequence", "global,per-user",
    "--coordinate-descent-iterations", "2",
    "--evaluators", "AUC:userId,AUC",
    "--output-mode", "ALL",
]


@pytest.fixture(scope="module")
def trained(avro_dirs, tmp_path_factory):
    out = tmp_path_factory.mktemp("cli-train")
    events = {"jax": [], "port": []}
    argv = [
        "--input-data-directories", str(avro_dirs / "train"),
        "--validation-data-directories", str(avro_dirs / "valid"),
        "--root-output-directory", "{out}",
        *TRAIN_ARGS,
    ]
    with float64_drivers(events["jax"]):
        j, t = _both(j_gt.run, t_gt.run, argv, out, events=_listening(events["port"]))
    return out, j, t, events


def _coefficients(model_dir: Path) -> dict:
    """relative file → {modelId: {(name, term): value}} for every
    coefficient and factor file of a saved model."""
    out = {}
    for f in sorted(model_dir.rglob("*.avro")):
        recs = {}
        for r in read_avro_dir(f):
            if "latentFactor" in r:
                recs[r["effectId"]] = dict(enumerate(r["latentFactor"]))
            else:
                recs[r["modelId"]] = {(m["name"], m["term"]): m["value"] for m in r["means"]}
                for m in r["variances"] or ():
                    recs[r["modelId"]][("var", m["name"], m["term"])] = m["value"]
        out[str(f.relative_to(model_dir))] = recs
    return out


def _assert_models_close(a: Path, b: Path, rtol=1e-7, atol=1e-10):
    ca, cb = _coefficients(a), _coefficients(b)
    assert ca.keys() == cb.keys() and ca
    for f in ca:
        assert ca[f].keys() == cb[f].keys(), f
        for mid, va in ca[f].items():
            vb = cb[f][mid]
            assert va.keys() == vb.keys(), (f, mid)
            keys = sorted(va, key=str)
            np.testing.assert_allclose([vb[k] for k in keys], [va[k] for k in keys],
                                       rtol=rtol, atol=atol, err_msg=f"{f} {mid}")
    for meta in ("model-metadata.json",):
        assert json.loads((a / meta).read_text()) == json.loads((b / meta).read_text())
    for id_info in a.rglob("id-info"):
        assert id_info.read_text() == (b / id_info.relative_to(a)).read_text()


# ---------------------------------------------------------------------------
# parsing
# ---------------------------------------------------------------------------


def _canon(x):
    """A package-neutral form of a parsed config (enums by name, dataclasses
    as dicts of their fields)."""
    import dataclasses
    import enum

    if dataclasses.is_dataclass(x):
        return {f.name: _canon(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Enum):
        return x.name
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    return x


def _common(a: dict, b: dict) -> tuple[dict, dict]:
    keys = a.keys() & b.keys()
    return {k: a[k] for k in keys}, {k: b[k] for k in keys}


COORDINATE_CASES = [
    "name=global,feature.shard=global,optimizer=TRON,max.iter=7,tolerance=1e-4,"
    "regularization=L2,reg.weights=0.1|1|10,down.sampling.rate=0.5",
    "name=per-user,random.effect.type=userId,feature.shard=user,regularization=ELASTIC_NET,"
    "reg.alpha=0.3,reg.weights=1,active.data.lower.bound=2,active.data.upper.bound=64,"
    "passive.data.bound=8,features.to.samples.ratio=3.5,min.partitions=4",
    "name=r,random.effect.type=u,feature.shard=s,projector.type=RANDOM,"
    "random.projection.dim=4,shape.budget=0",
    "name=mf, row.entity.type=userId, col.entity.type=movieId, num.factors=8, "
    "reg.weights=0.5, max.iter=40, init.scale=0.2",
    "name=g,feature.shard=global,representation=DENSE,bf16.features=true",
    "name=g,feature.shard=global,representation=SPARSE",
]


@pytest.mark.parametrize("spec", COORDINATE_CASES)
def test_parse_coordinate_config_equal(spec):
    jname, jcfg = j_parse.parse_coordinate_config(spec, JTask.LOGISTIC_REGRESSION)
    tname, tcfg = t_parse.parse_coordinate_config(spec, TTask.LOGISTIC_REGRESSION)
    assert jname == tname
    assert type(jcfg).__name__ == type(tcfg).__name__
    a, b = _common(_canon(tcfg), _canon(jcfg))
    a["optimization"], b["optimization"] = _common(a["optimization"], b["optimization"])
    for d in (a["optimization"], b["optimization"]):
        d.pop("optimizer_config")
    assert a == b
    t_opt, j_opt = (c.optimization.optimizer_config for c in (tcfg, jcfg))
    assert (t_opt.max_iterations, t_opt.tolerance) == (j_opt.max_iterations, j_opt.tolerance)


BAD_COORDINATES = [
    ("name=x,feature.shard=s,active.data.lower.bound=2", "active/passive"),
    ("name=mf, row.entity.type=userId", "col.entity.type"),
    ("name=mf, row.entity.type=u, col.entity.type=i, feature.shard=g", "no feature.shard"),
    ("name=g,feature.shard=global,representation=SPARSE,bf16.features=true", "dense"),
    ("name=g,feature.shard=global,bogus=1", "unknown coordinate config keys"),
    ("feature.shard=global", "missing"),
]


@pytest.mark.parametrize("spec,match", BAD_COORDINATES)
def test_parse_coordinate_config_errors_equal(spec, match):
    for parse, task in ((j_parse.parse_coordinate_config, JTask.LOGISTIC_REGRESSION),
                        (t_parse.parse_coordinate_config, TTask.LOGISTIC_REGRESSION)):
        with pytest.raises(ValueError, match=match):
            parse(spec, task)


def test_parse_kv_shards_and_evaluators_equal():
    for s in ("a=1, b=x|y", "k = v ,"):
        assert t_parse.parse_kv(s) == j_parse.parse_kv(s)
    for bad in ("a=1,a=2", "noequals"):
        for mod in (t_parse, j_parse):
            with pytest.raises(ValueError):
                mod.parse_kv(bad)
    spec = "name=user,feature.bags=userFeatures|songFeatures,intercept=false"
    (tn, tc), (jn, jc) = t_parse.parse_feature_shard_config(spec), j_parse.parse_feature_shard_config(spec)
    assert (tn, tc.feature_bags, tc.has_intercept) == (jn, jc.feature_bags, jc.has_intercept)
    for bad in ("feature.bags=x", "name=a,feature.bags=x,bogus=1", "name=a,feature.bags=x,intercept=maybe"):
        for mod in (t_parse, j_parse):
            with pytest.raises(ValueError):
                mod.parse_feature_shard_config(bad)
    evs = "AUC, PRECISION@5:queryId, RMSE:docId, logistic-loss"
    assert [_canon(e) for e in t_parse.parse_evaluators(evs)] == [
        _canon(e) for e in j_parse.parse_evaluators(evs)
    ]
    for bad, match in (("NOPE", "unknown evaluator"), ("PRECISION@x:queryId", "precision@k"),
                       ("LOGISTIC_LOSS:queryId", "grouped")):
        for mod in (t_parse, j_parse):
            with pytest.raises(ValueError, match=match):
                mod.parse_evaluators(bad)


DRIVERS = {
    "game_training": (j_gt, t_gt),
    "game_scoring": (j_gs, t_gs),
    "legacy_driver": (j_ld, t_ld),
    "feature_indexing": (j_fi, t_fi),
    "name_term_bags": (j_ntb, t_ntb),
}


@pytest.mark.parametrize("driver", sorted(DRIVERS))
def test_parsers_take_the_same_flags(driver):
    jmod, tmod = DRIVERS[driver]

    def flags(p):
        return {(s, a.default, a.required) for a in p._actions for s in a.option_strings}

    assert flags(tmod.build_parser()) == flags(jmod.build_parser())


def test_module_entry_point_help():
    proc = subprocess.run(
        [sys.executable, "-m", "photon_tpu_torch.cli.game_training", "--help"],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
    assert "--coordinate-configurations" in proc.stdout


def test_main_raises_without_a_card(monkeypatch, avro_dirs, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: main() runs on it")
    monkeypatch.setattr(sys, "argv", [
        "photon-torch-game-training", "--input-data-directories", str(avro_dirs / "train"),
        "--root-output-directory", str(tmp_path / "o"), *TRAIN_ARGS,
    ])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        t_gt.main()
    assert not (tmp_path / "o").exists()


# ---------------------------------------------------------------------------
# training and scoring drivers
# ---------------------------------------------------------------------------


def test_training_summary_and_artifacts_equal(trained):
    out, j, t, _ = trained
    js = json.loads((out / "jax" / "training-summary.json").read_text())
    ts = json.loads((out / "port" / "training-summary.json").read_text())
    assert ts["best"] == js["best"] == j["best"] == t["best"]
    assert ts["task"] == js["task"]
    assert len(ts["models"]) == len(js["models"]) == 2
    for a, b in zip(ts["models"], js["models"]):
        assert a["regularizationWeights"] == b["regularizationWeights"]
        np.testing.assert_allclose(a["evaluation"], b["evaluation"], rtol=0, atol=1e-9)
        assert 0.5 < a["evaluation"] <= 1.0
    assert t["decoders"]["training"] == {"decoder": "native", "reason": None}
    for sub in ("best", "models/0", "models/1"):
        _assert_models_close(out / "jax" / sub, out / "port" / sub)
    assert (out / "port" / "driver.log").is_file()
    # both drivers leave their telemetry under obs/
    assert sorted(os.listdir(out / "port")) == sorted(os.listdir(out / "jax")) == [
        "best", "driver.log", "models", "obs", "training-summary.json"]
    assert {"trace.json", "metrics.json", "manifest.jsonl", "series.jsonl"} <= set(
        os.listdir(out / "port" / "obs"))


def test_lifecycle_events_equal(trained):
    _, _, _, events = trained
    names = [n for n, _ in events["port"]]
    assert names == [n for n, _ in events["jax"]]
    assert names[:3] == ["setup", "training_start", "setup"]
    assert names.count("sweep_complete") == 4 and names[-2:] == ["training_finish",
                                                                  "driver_finish"]
    for (name, tp), (_, jp) in zip(events["port"], events["jax"]):
        assert tp.keys() == jp.keys(), name
        for key in ("grid_index", "iteration", "n_grid_points", "num_samples", "coordinates",
                    "update_sequence", "grid_length", "descent_iterations", "num_models"):
            if key in jp:
                assert tp[key] == jp[key], (name, key)
        if name == "training_finish":
            np.testing.assert_allclose(tp["best_evaluation"], jp["best_evaluation"], atol=1e-9)


def test_estimator_failure_event_equal():
    from photon_tpu import game as jgame
    from photon_tpu.optimize.problem import GLMProblemConfig as JProblem
    from photon_tpu.util.events import EventEmitter as JEmitter
    from photon_tpu_torch import game as tgame
    from photon_tpu_torch.optimize.problem import GLMProblemConfig as TProblem
    from photon_tpu_torch.util.events import EventEmitter as TEmitter

    seen = {}
    for key, game, problem, emitter_cls, task in (
        ("jax", jgame, JProblem, JEmitter, JTask), ("port", tgame, TProblem, TEmitter, TTask)
    ):
        emitter = emitter_cls()
        seen[key] = []
        emitter.register(lambda e, sink=seen[key]: sink.append((e.name, e.payload)))
        kw = {"device": "cpu"} if key == "port" else {}
        cfg = game.FixedEffectCoordinateConfig(feature_shard="g", optimization=problem())
        est = game.GameEstimator(
            task=task.LOGISTIC_REGRESSION, coordinate_configs={"g": cfg}, update_sequence=["g"],
            ignore_threshold_for_new_models=True, events=emitter, **kw)
        with pytest.raises(ValueError, match="initial model"):
            est.fit(type("D", (), {"num_samples": 3})())
    assert [n for n, _ in seen["port"]] == [n for n, _ in seen["jax"]] == [
        "setup", "training_failure"]
    assert seen["port"][1][1]["error"] == seen["jax"][1][1]["error"].split(" (reference")[0]


@pytest.fixture(scope="module")
def scored(avro_dirs, trained, tmp_path_factory):
    """Both scoring drivers on the validation data: the host path on each
    package's own best model, the streamed path (3 partitions, 64-row
    batches) on JAX's."""
    out = tmp_path_factory.mktemp("cli-score")
    train_out = trained[0]
    base = ["--input-data-directories", str(avro_dirs / "valid"),
            "--feature-shard-configurations", SHARD_ARG,
            "--evaluators", "AUC,LOGISTIC_LOSS,AUC:userId", "--model-id", "m1"]
    res, events = {}, {"jax": [], "port": []}
    for key, run, model in (("jax", j_gs.run, train_out / "jax" / "best"),
                            ("port", functools.partial(t_gs.run, device="cpu",
                                                       events=_listening(events["port"])),
                             train_out / "port" / "best")):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(j_gs, "EventEmitter", _recording_emitter(j_gs.EventEmitter, events["jax"]))
            res[key, "mono"] = run([*base, "--root-output-directory", str(out / key / "mono"),
                                    "--model-input-directory", str(model),
                                    "--monolithic-scoring"])
            res[key, "stream"] = run([*base, "--root-output-directory", str(out / key / "stream"),
                                      "--model-input-directory", str(train_out / "jax" / "best"),
                                      "--num-output-partitions", "3",
                                      "--score-batch-rows", "64"])
    res["events"] = events
    return out, res


def test_scoring_events_equal(scored):
    _, res = scored
    events = res["events"]
    assert events["port"] == events["jax"]
    assert [n for n, _ in events["port"]] == ["setup", "scoring_finish"] * 2
    assert events["port"][1][1] == {"num_scored": 200}


def _scores_by_uid(score_dir: Path) -> dict:
    return {r["uid"]: r for r in read_avro_dir(score_dir)}


def test_scoring_driver_host_path_equals_jax(scored):
    out, res = scored
    tj, tt = res["jax", "mono"], res["port", "mono"]
    np.testing.assert_allclose(tt["scores"], tj["scores"], rtol=1e-7, atol=1e-9)
    assert tt["evaluations"].keys() == tj["evaluations"].keys()
    for k, v in tj["evaluations"].items():
        np.testing.assert_allclose(tt["evaluations"][k], v, rtol=1e-9, atol=1e-9)
    rj = _scores_by_uid(out / "jax" / "mono" / "scores")
    rt = _scores_by_uid(out / "port" / "mono" / "scores")
    assert rj.keys() == rt.keys() and len(rt) == 200
    for uid, r in rt.items():
        assert (r["label"], r["weight"], r["modelId"]) == (rj[uid]["label"], rj[uid]["weight"], "m1")
        np.testing.assert_allclose(r["predictionScore"], rj[uid]["predictionScore"],
                                   rtol=1e-7, atol=1e-9)
    assert tt["scoring"]["mode"] == "monolithic"


def test_scoring_driver_streamed_path_equals_jax(scored):
    out, res = scored
    tj, tt = res["jax", "stream"], res["port", "stream"]
    sj = json.loads((out / "jax" / "stream" / "scoring-summary.json").read_text())
    st = json.loads((out / "port" / "stream" / "scoring-summary.json").read_text())
    assert st["numScored"] == sj["numScored"] == 200
    for key in ("mode", "batchRows", "numOutputPartitions", "batches"):
        assert st["scoring"][key] == sj["scoring"][key], key
    assert [os.path.basename(p) for p in st["scoring"]["outputFiles"]] == [
        os.path.basename(p) for p in sj["scoring"]["outputFiles"]]
    assert st["scoring"]["writer"] == ["native"] and st["scoring"]["decoder"] == "native"
    # both device scorers compute in float32
    np.testing.assert_allclose(tt["scores"], tj["scores"], rtol=1e-5, atol=1e-5)
    for k, v in tj["evaluations"].items():
        np.testing.assert_allclose(tt["evaluations"][k], v, rtol=1e-5, atol=1e-5)
    for part in range(3):
        name = f"part-{part:05d}.avro"
        uj = [r["uid"] for r in read_avro_dir(out / "jax" / "stream" / "scores" / name)]
        ut = [r["uid"] for r in read_avro_dir(out / "port" / "stream" / "scores" / name)]
        assert ut == uj  # the same round-robin assignment of batches
    # the host path on the same (JAX-trained) model agrees with the stream
    mono = _scores_by_uid(out / "jax" / "mono" / "scores")
    for uid, r in _scores_by_uid(out / "port" / "stream" / "scores").items():
        np.testing.assert_allclose(r["predictionScore"], mono[uid]["predictionScore"],
                                   rtol=1e-5, atol=1e-5)


def test_scoring_driver_feature_cache_cold_then_warm_equals_jax(avro_dirs, trained, scored,
                                                               tmp_path, monkeypatch):
    """``--feature-cache use`` twice on the port's streaming driver: the
    cold run decodes Avro and builds the cache, the warm run replays it
    (no decode) to the same scores bit for bit; JAX's driver with
    ``require`` opens the port's cache, and both equal the uncached
    streamed runs of ``scored``."""
    out, res = scored
    monkeypatch.setenv("PHOTON_FEATURE_CACHE_DIR", str(tmp_path / "croot"))
    base = ["--input-data-directories", str(avro_dirs / "valid"),
            "--feature-shard-configurations", SHARD_ARG,
            "--evaluators", "AUC,LOGISTIC_LOSS,AUC:userId", "--model-id", "m1",
            "--model-input-directory", str(trained[0] / "jax" / "best"),
            "--num-output-partitions", "3", "--score-batch-rows", "64"]
    runs, summaries = {}, {}
    for key, run, mode in (("cold", functools.partial(t_gs.run, device="cpu"), "use"),
                           ("warm", functools.partial(t_gs.run, device="cpu"), "use"),
                           ("jax", j_gs.run, "require")):
        runs[key] = run([*base, "--root-output-directory", str(tmp_path / key),
                         "--feature-cache", mode])
        summaries[key] = json.loads((tmp_path / key / "scoring-summary.json").read_text())
    cold, warm = (summaries[k]["scoring"] for k in ("cold", "warm"))
    assert cold["mode"] == warm["mode"] == "streaming"
    assert (cold["featureCache"]["state"], cold["featureCache"]["source"]) == ("miss", "avro")
    assert (warm["featureCache"]["state"], warm["featureCache"]["source"]) == ("hit", "cache")
    assert summaries["jax"]["scoring"]["featureCache"]["state"] == "hit"
    assert cold["featureCache"]["cacheDir"] == warm["featureCache"]["cacheDir"] == (
        summaries["jax"]["scoring"]["featureCache"]["cacheDir"])
    assert (cold["decoder"], warm["decoder"], warm["decoderReason"]) == ("native", "cache", None)
    assert cold["slo"] is warm["slo"] is None
    assert warm["maxStagedChunks"] <= 4 and warm["batches"] == cold["batches"] == 4
    assert set(warm["stageLatency"]) == {"decode", "queue", "assemble", "h2d", "dispatch",
                                         "pipeline", "readback", "write"}
    np.testing.assert_array_equal(runs["warm"]["scores"], runs["cold"]["scores"])
    np.testing.assert_array_equal(runs["cold"]["scores"], res["port", "stream"]["scores"])
    np.testing.assert_array_equal(runs["jax"]["scores"], res["jax", "stream"]["scores"])
    np.testing.assert_allclose(runs["warm"]["scores"], runs["jax"]["scores"], rtol=1e-5,
                               atol=1e-5)
    for k, v in runs["jax"]["evaluations"].items():
        np.testing.assert_allclose(runs["warm"]["evaluations"][k], v, rtol=1e-5, atol=1e-5)
    for part in range(3):
        name = f"part-{part:05d}.avro"
        assert list(read_avro_dir(tmp_path / "warm" / "scores" / name)) == list(
            read_avro_dir(tmp_path / "cold" / "scores" / name))


def test_scoring_driver_degrades_on_a_dead_producer_like_jax(avro_dirs, trained, scored,
                                                             tmp_path, monkeypatch):
    """``scoring.producer@1=error`` kills the producer thread: without the
    escape both drivers raise ProducerDiedError; with
    PHOTON_SCORE_DEGRADE=1 both fall back to the monolithic path, record
    it in the summary and write the host path's scores."""
    out, res = scored
    base = ["--input-data-directories", str(avro_dirs / "valid"),
            "--feature-shard-configurations", SHARD_ARG,
            "--evaluators", "AUC,LOGISTIC_LOSS,AUC:userId", "--model-id", "m1",
            "--model-input-directory", str(trained[0] / "jax" / "best"),
            "--num-output-partitions", "3", "--score-batch-rows", "64"]
    monkeypatch.setenv("PHOTON_FAULTS", "scoring.producer@1=error")
    drivers = (("jax", j_gs.run), ("port", functools.partial(t_gs.run, device="cpu")))
    try:
        for key, run in drivers:
            with pytest.raises(Exception, match="producer thread died") as err:
                run([*base, "--root-output-directory", str(tmp_path / "fail" / key)])
            assert type(err.value).__name__ == "ProducerDiedError"
        monkeypatch.setenv("PHOTON_SCORE_DEGRADE", "1")
        got = {key: run([*base, "--root-output-directory", str(tmp_path / key)])
               for key, run in drivers}
    finally:
        monkeypatch.delenv("PHOTON_FAULTS")
        t_faults.clear()
        j_faults.clear()
    for key in ("jax", "port"):
        summary = json.loads((tmp_path / key / "scoring-summary.json").read_text())
        assert summary["scoring"]["mode"] == "monolithic" and summary["numScored"] == 200
        assert sorted(os.listdir(tmp_path / key / "scores")) == ["part-00000.avro"]
    np.testing.assert_allclose(got["port"]["scores"], got["jax"]["scores"], rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(got["port"]["scores"], res["jax", "mono"]["scores"], rtol=1e-7,
                               atol=1e-9)
    for k, v in got["jax"]["evaluations"].items():
        np.testing.assert_allclose(got["port"]["evaluations"][k], v, rtol=1e-9, atol=1e-9)


def test_training_driver_feature_cache_require_equals_jax(avro_dirs, trained, tmp_path,
                                                          monkeypatch):
    """Caches built by the port's cache tool feed both training drivers
    with ``--feature-cache require``: the port's models equal its uncached
    run bit for bit, and JAX's run on the same caches within the driver
    tolerances."""
    from photon_tpu_torch.cli import cache_tool

    monkeypatch.setenv("PHOTON_FEATURE_CACHE_DIR", str(tmp_path / "croot"))
    for name in ("train", "valid"):
        assert cache_tool.run(["build", "--input-data-directories", str(avro_dirs / name),
                               "--feature-shard-configurations", SHARD_ARG,
                               "--id-tags", "userId"]) == 0
    argv = ["--input-data-directories", str(avro_dirs / "train"),
            "--validation-data-directories", str(avro_dirs / "valid"),
            "--root-output-directory", "{out}", *TRAIN_ARGS, "--feature-cache", "require"]
    with float64_drivers():
        j, t = _both(j_gt.run, t_gt.run, argv, tmp_path / "train")
    assert t["decoders"] == {"training": {"decoder": "cache", "reason": None},
                             "validation": {"decoder": "cache", "reason": None}}
    assert t["best"] == j["best"] == trained[2]["best"]
    for a, b, c in zip(t["results"], j["results"], trained[2]["results"]):
        assert a.evaluation == c.evaluation
        np.testing.assert_allclose(a.evaluation, b.evaluation, rtol=0, atol=1e-9)
    for sub in ("best", "models/0", "models/1"):
        _assert_models_close(trained[0] / "port" / sub, tmp_path / "train" / "port" / sub,
                             rtol=0, atol=0)
        _assert_models_close(tmp_path / "train" / "jax" / sub,
                             tmp_path / "train" / "port" / sub)


def test_models_cross_load_and_score(avro_dirs, trained, tmp_path):
    """A model saved by either package scores the same in the other."""
    train_out = trained[0]
    base = ["--input-data-directories", str(avro_dirs / "valid"),
            "--feature-shard-configurations", SHARD_ARG, "--monolithic-scoring"]
    port_on_jax = t_gs.run([*base, "--root-output-directory", str(tmp_path / "a"),
                            "--model-input-directory", str(train_out / "jax" / "best")],
                           device="cpu")
    jax_on_port = j_gs.run([*base, "--root-output-directory", str(tmp_path / "b"),
                            "--model-input-directory", str(train_out / "port" / "best")])
    jax_on_jax = j_gs.run([*base, "--root-output-directory", str(tmp_path / "c"),
                           "--model-input-directory", str(train_out / "jax" / "best")])
    np.testing.assert_allclose(port_on_jax["scores"], jax_on_jax["scores"], rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(jax_on_port["scores"], jax_on_jax["scores"], rtol=1e-7,
                               atol=1e-9)


def test_locked_coordinate_warm_start_equals_jax(avro_dirs, trained, tmp_path):
    prior = trained[0] / "jax" / "best"
    argv = [
        "--input-data-directories", str(avro_dirs / "train"),
        "--validation-data-directories", str(avro_dirs / "valid"),
        "--root-output-directory", "{out}",
        "--training-task", "LOGISTIC_REGRESSION",
        "--feature-shard-configurations", SHARD_ARG,
        "--coordinate-configurations",
        "name=global,feature.shard=global,optimizer=LBFGS,max.iter=10,"
        "regularization=L2,reg.weights=1",
        "--coordinate-configurations",
        "name=per-user,random.effect.type=userId,feature.shard=global,"
        "max.iter=8,regularization=L2,reg.weights=1,active.data.lower.bound=3",
        "--coordinate-update-sequence", "global,per-user",
        "--evaluators", "AUC",
        "--model-input-directory", str(prior),
        "--partial-retrain-locked-coordinates", "global",
        "--ignore-threshold-for-new-models",
        "--normalization", "STANDARDIZATION",
        "--compute-variance",
        "--data-summary-directory", str(tmp_path / "{side}-stats"),
    ]
    with float64_drivers():
        j = j_gt.run([str(tmp_path / "jax") if a == "{out}" else a.replace("{side}", "jax")
                      for a in argv])
        t = t_gt.run([str(tmp_path / "port") if a == "{out}" else a.replace("{side}", "port")
                      for a in argv], device="cpu")
    np.testing.assert_allclose(t["results"][0].evaluation, j["results"][0].evaluation,
                               rtol=0, atol=1e-9)
    _assert_models_close(tmp_path / "jax" / "best", tmp_path / "port" / "best")
    # the locked fixed effect comes back as the prior's
    locked_prior = _coefficients(prior / "fixed-effect")
    locked_new = _coefficients(tmp_path / "port" / "best" / "fixed-effect")
    for f, recs in locked_prior.items():
        for mid, vals in recs.items():
            for k, v in vals.items():
                np.testing.assert_allclose(locked_new[f][mid][k], v, rtol=1e-9)
    stats_j, stats_t = (_avro_records(tmp_path / f"{s}-stats") for s in ("jax", "port"))
    assert stats_t.keys() == stats_j.keys()
    for f in stats_j:
        assert len(stats_t[f]) == len(stats_j[f])
        for a, b in zip(stats_t[f], stats_j[f]):
            assert (a["featureName"], a["featureTerm"]) == (b["featureName"], b["featureTerm"])
            for m, v in b["metrics"].items():
                np.testing.assert_allclose(a["metrics"][m], v, rtol=1e-12, atol=1e-12)


def _avro_records(d: Path) -> dict:
    return {str(f.relative_to(d)): list(read_avro_dir(f)) for f in sorted(d.rglob("*.avro"))}


def _mf_records(seed=3, n=500, users=12, items=8):
    rng = np.random.default_rng(seed)
    u_t, v_t = rng.normal(size=(users, 2)), rng.normal(size=(items, 2))
    records = []
    for i in range(n):
        u, m = int(rng.integers(users)), int(rng.integers(items))
        x = rng.normal(size=3)
        margin = 0.5 * x.sum() + 1.5 * float(u_t[u] @ v_t[m])
        records.append({
            "uid": f"s{i}",
            "label": float(rng.uniform() < 1.0 / (1.0 + np.exp(-margin))),
            "features": [{"name": f"f{j}", "term": "", "value": float(x[j])} for j in range(3)],
            "metadataMap": {"userId": f"u{u}", "itemId": f"m{m}"},
            "weight": 1.0,
            "offset": 0.0,
        })
    return records


def test_matrix_factorization_train_and_score_equal_jax(tmp_path):
    data = tmp_path / "data"
    data.mkdir()
    write_avro_file(data / "part-00000.avro", TRAINING_EXAMPLE_AVRO, _mf_records())
    argv = [
        "--input-data-directories", str(data),
        "--validation-data-directories", str(data),
        "--root-output-directory", "{out}",
        "--training-task", "LOGISTIC_REGRESSION",
        "--feature-shard-configurations", SHARD_ARG,
        "--coordinate-configurations",
        "name=global,feature.shard=global,max.iter=25,regularization=L2,reg.weights=1",
        "--coordinate-configurations",
        "name=mf,row.entity.type=userId,col.entity.type=itemId,num.factors=4,"
        "reg.weights=0.5,max.iter=60",
        "--coordinate-update-sequence", "global,mf",
        "--coordinate-descent-iterations", "2",
        "--evaluators", "AUC",
    ]
    with float64_drivers():
        j, t = _both(j_gt.run, t_gt.run, argv, tmp_path / "train")
    np.testing.assert_allclose(t["results"][0].evaluation, j["results"][0].evaluation,
                               rtol=0, atol=1e-9)
    assert t["results"][0].evaluation > 0.7
    _assert_models_close(tmp_path / "train" / "jax" / "best", tmp_path / "train" / "port" / "best")
    score = ["--input-data-directories", str(data), "--root-output-directory", "{out}",
             "--feature-shard-configurations", SHARD_ARG, "--evaluators", "AUC,AUC:itemId",
             "--model-input-directory", str(tmp_path / "train" / "jax" / "best")]
    js, ts = _both(j_gs.run, t_gs.run, score, tmp_path / "score")
    np.testing.assert_allclose(ts["scores"], js["scores"], rtol=1e-5, atol=1e-5)
    for k, v in js["evaluations"].items():
        np.testing.assert_allclose(ts["evaluations"][k], v, atol=1e-5)


# ---------------------------------------------------------------------------
# legacy driver
# ---------------------------------------------------------------------------


def _text_coefficients(path: Path) -> dict:
    lines = path.read_text().splitlines()
    return {k: float(v) for k, v in (ln.split("\t") for ln in lines[1:])}


def _assert_legacy_equal(jdrv, tdrv, out: Path, lambdas):
    assert [s.name for s in tdrv.stage_history] == [s.name for s in jdrv.stage_history]
    assert tdrv.stage.name == jdrv.stage.name == "VALIDATED"
    mj = json.loads((out / "jax" / "metrics.json").read_text())
    mt = json.loads((out / "port" / "metrics.json").read_text())
    assert mt["bestIndex"] == mj["bestIndex"] and mt["stages"] == mj["stages"]
    assert [r["Lambda"] for r in mt["metrics"]] == lambdas
    for a, b in zip(mt["metrics"], mj["metrics"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-9)
    for lam in lambdas:
        name = f"lambda-{lam}.txt"
        cj = _text_coefficients(out / "jax" / "learned-models-text" / name)
        ct = _text_coefficients(out / "port" / "learned-models-text" / name)
        assert ct.keys() == cj.keys()
        np.testing.assert_allclose([ct[k] for k in cj], list(cj.values()), rtol=1e-7, atol=1e-10)
    assert (out / "port" / "best-model-text" / "best.txt").read_text().splitlines()[0] == (
        out / "jax" / "best-model-text" / "best.txt").read_text().splitlines()[0]


def test_legacy_driver_libsvm_equals_jax(tmp_path):
    _write_libsvm(tmp_path / "a1a.libsvm", 0)
    _write_libsvm(tmp_path / "a1a.t.libsvm", 1)
    argv = [
        "--training-data-directory", str(tmp_path / "a1a.libsvm"),
        "--validating-data-directory", str(tmp_path / "a1a.t.libsvm"),
        "--output-directory", "{out}",
        "--input-format", "LIBSVM",
        "--task", "LOGISTIC_REGRESSION",
        "--regularization-type", "L2",
        "--regularization-weights", "0.1,1,10",
        "--normalization-type", "STANDARDIZATION",
        "--max-num-iterations", "50",
    ]
    events = {"jax": [], "port": []}
    with float64_drivers(events["jax"]):
        jdrv, tdrv = _both(j_ld.run, t_ld.run, argv, tmp_path / "out",
                           events=_listening(events["port"]))
    _assert_legacy_equal(jdrv, tdrv, tmp_path / "out", [0.1, 1.0, 10.0])
    assert [n for n, _ in events["port"]] == [n for n, _ in events["jax"]] == [
        "photon_setup", "training_start", "training_finish"]
    assert not (tmp_path / "out" / "port" / "models").exists()  # positional features


def test_legacy_driver_avro_equals_jax(avro_dirs, tmp_path):
    argv = [
        "--training-data-directory", str(avro_dirs / "train"),
        "--validating-data-directory", str(avro_dirs / "valid"),
        "--output-directory", "{out}",
        "--input-format", "AVRO",
        "--task", "LOGISTIC_REGRESSION",
        "--regularization-type", "L2",
        "--regularization-weights", "1,10",
        "--coefficient-box-constraints",
        # an active bound that converges (a stalled projected L-BFGS-B
        # drifts by roundoff in both packages, ROADMAP C)
        '[{"name": "f0", "term": "", "lowerBound": -0.05, "upperBound": 0.05}]',
        "--optimizer", "LBFGSB",
    ]
    with float64_drivers():
        jdrv, tdrv = _both(j_ld.run, t_ld.run, argv, tmp_path / "out")
    _assert_legacy_equal(jdrv, tdrv, tmp_path / "out", [1.0, 10.0])
    out = tmp_path / "out"
    _assert_models_avro_close(out / "jax" / "models", out / "port" / "models")
    _assert_models_avro_close(out / "jax" / "best-model", out / "port" / "best-model")
    text = _text_coefficients(out / "port" / "learned-models-text" / "lambda-1.0.txt")
    assert text["f0\x01"] == 0.05  # the bound holds


def _assert_models_avro_close(a: Path, b: Path):
    ca, cb = _coefficients(a), _coefficients(b)
    assert ca.keys() == cb.keys() and ca
    for f in ca:
        for mid in ca[f]:
            keys = sorted(ca[f][mid], key=str)
            assert sorted(cb[f][mid], key=str) == keys
            np.testing.assert_allclose([cb[f][mid][k] for k in keys],
                                       [ca[f][mid][k] for k in keys], rtol=1e-7, atol=1e-10)


# ---------------------------------------------------------------------------
# index tools
# ---------------------------------------------------------------------------


def test_feature_indexing_and_name_term_bags_equal_jax(avro_dirs, tmp_path):
    argv = ["--input-data-directories", f"{avro_dirs / 'train'},{avro_dirs / 'valid'}",
            "--feature-shard-configurations", SHARD_ARG,
            "--feature-shard-configurations", "name=noicpt,feature.bags=features,intercept=false",
            "--root-output-directory", "{out}", "--num-partitions", "3"]
    j, t = _both(j_fi.run, lambda a, device: t_fi.run(a), argv, tmp_path / "index")
    assert t["shards"] == j["shards"] == {"global": 7, "noicpt": 6}
    for shard, n in t["shards"].items():
        js = j_load_store(tmp_path / "index" / "jax", shard, prefer_native=False)
        ts = t_load_store(tmp_path / "index" / "port", shard)
        assert [ts.get_feature_name(i) for i in range(n)] == [
            js.get_feature_name(i) for i in range(n)]
    for f in ("_index_metadata.json", "indexing-summary.json"):
        assert (tmp_path / "index" / "port" / f).read_text() == (
            tmp_path / "index" / "jax" / f).read_text()

    argv = ["--input-data-directories", str(avro_dirs / "train"), "--feature-bags", "features",
            "--root-output-directory", "{out}"]
    j, t = _both(j_ntb.run, lambda a, device: t_ntb.run(a), argv, tmp_path / "bags")
    assert t["counts"] == j["counts"] == {"features": 6}
    for f in ("features/name-terms.tsv", "bags-summary.json"):
        assert (tmp_path / "bags" / "port" / f).read_text() == (
            tmp_path / "bags" / "jax" / f).read_text()


# ---------------------------------------------------------------------------
# recovery, warm starts and tuning, against JAX's driver
# ---------------------------------------------------------------------------


def _train_argv(avro_dirs, out, *extra):
    return [
        "--input-data-directories", str(avro_dirs / "train"),
        "--validation-data-directories", str(avro_dirs / "valid"),
        "--root-output-directory", str(out), *TRAIN_ARGS, *extra,
    ]


def _each(avro_dirs, root: Path, extra=lambda sub: ()):
    """Run the training command line (plus ``extra(sub)``) through JAX's
    driver and then the port's, at float64, outputs under root/<sub>."""
    out = {}
    with float64_drivers():
        for sub, run in (("jax", j_gt.run), ("port", functools.partial(t_gt.run, device="cpu"))):
            out[sub] = run(_train_argv(avro_dirs, root / sub, *extra(sub)))
    return out["jax"], out["port"]


@pytest.fixture
def clear_faults():
    yield
    j_faults.clear()
    t_faults.clear()


def _summary(out: Path) -> dict:
    return json.loads((out / "training-summary.json").read_text())


def _assert_summaries_close(a: dict, b: dict, tol=1e-9):
    assert a["best"] == b["best"] and len(a["models"]) == len(b["models"])
    for ma, mb in zip(a["models"], b["models"]):
        assert ma["regularizationWeights"].keys() == mb["regularizationWeights"].keys()
        for k, v in ma["regularizationWeights"].items():
            np.testing.assert_allclose(mb["regularizationWeights"][k], v, rtol=tol)
        np.testing.assert_allclose(ma["evaluation"], mb["evaluation"], rtol=0, atol=tol)


def _assert_models_equal(a: Path, b: Path):
    assert _coefficients(a) == _coefficients(b)


def _assert_uninterrupted(trained, root: Path):
    """The port's run under root/port wrote the uninterrupted run's
    summary and models: bit for bit against the port's, within the parity
    tolerances against JAX's (both from the shared ``trained`` runs of the
    same command line)."""
    out = trained[0]
    got = _summary(root / "port")
    assert got["best"] == _summary(out / "port")["best"]
    for a, b in zip(got["models"], _summary(out / "port")["models"], strict=True):
        assert a["evaluation"] == b["evaluation"]
    _assert_summaries_close(_summary(out / "jax"), got)
    for sub in ("best", "models/0", "models/1"):
        _assert_models_equal(out / "port" / sub, root / "port" / sub)
        _assert_models_close(out / "jax" / sub, root / "port" / sub)


def _crash_then_resume(avro_dirs, root, monkeypatch, plan):
    """The port's --checkpoint-sweeps run under ``plan`` dies with
    InjectedCrash, then the same command line with no plan resumes."""
    argv = _train_argv(avro_dirs, root / "port", "--checkpoint-sweeps")
    with float64_drivers():
        monkeypatch.setenv("PHOTON_FAULTS", plan)
        with pytest.raises(BaseException) as crash:
            t_gt.run(argv, device="cpu")
        assert type(crash.value).__name__ == "InjectedCrash"
        assert (root / "port" / "checkpoints" / "descent-checkpoint.json").is_file()
        monkeypatch.delenv("PHOTON_FAULTS")
        return t_gt.run(argv, device="cpu")


def _port_run(avro_dirs, root, *extra):
    with float64_drivers():
        return t_gt.run(_train_argv(avro_dirs, root / "port", *extra), device="cpu")


def test_killed_run_resumes_to_the_uninterrupted_models(avro_dirs, trained, tmp_path,
                                                        monkeypatch, clear_faults):
    """Occurrence 4 of descent.sweep is grid 1's second sweep: grid 0's
    model is on disk, the resume starts after grid 1's sweep 0, and every
    model equals the uninterrupted run's (bit for bit in the port, within
    the parity tolerances against JAX)."""
    t = _crash_then_resume(avro_dirs, tmp_path, monkeypatch, "descent.sweep@4=crash")
    assert t["fit_stats"]["resumed_from"] == (1, 0)
    assert "resumed from checkpoint: grid 1, sweep 0" in (
        tmp_path / "port" / "driver.log").read_text()
    assert t["results"][0].tracker == [] and t["results"][1].tracker
    _assert_uninterrupted(trained, tmp_path)
    lines = (tmp_path / "port" / "checkpoints" / "grid-results.jsonl").read_text().splitlines()
    assert [json.loads(x)["grid_index"] for x in lines] == [0, 1]


def test_resume_after_the_last_sweep_trains_no_sweep(avro_dirs, trained, tmp_path, monkeypatch,
                                                     clear_faults):
    """Write 6 of checkpoint.write is grid 1's grid-done snapshot, after
    its model went to disk: the rerun resumes after grid 1's last sweep,
    takes no sweep, restores grid 0 from disk and writes the uninterrupted
    run's summary and models."""
    t = _crash_then_resume(avro_dirs, tmp_path, monkeypatch, "checkpoint.write@6=crash")
    assert t["fit_stats"]["resumed_from"] == (1, 1)
    assert t["results"][0].tracker == []
    assert not [r for r in t["results"][1].tracker if "sweep_seconds" in r]
    _assert_uninterrupted(trained, tmp_path)


def test_max_restarts_recovers_from_an_injected_nan(avro_dirs, trained, tmp_path, monkeypatch,
                                                   clear_faults):
    """descent.coordinate@3 poisons grid 0's sweep-1 fixed effect; the
    health check raises, the supervisor restarts once from the sweep-0
    checkpoint, and the models equal the uninterrupted run's."""
    monkeypatch.setenv("PHOTON_FAULTS", "descent.coordinate@3=nan")
    t = _port_run(avro_dirs, tmp_path, "--checkpoint-sweeps", "--max-restarts", "1")
    assert len(t["fit_stats"]["restarts"]) == 1
    assert t["fit_stats"]["restarts"][0].startswith("DivergenceError: coordinate 'global'")
    assert "the fit restarted after DivergenceError" in (
        tmp_path / "port" / "driver.log").read_text()
    _assert_uninterrupted(trained, tmp_path)


def test_max_restarts_recovers_from_a_transient_sweep_fault(avro_dirs, trained, tmp_path,
                                                           monkeypatch, clear_faults):
    """descent.sweep@2=unavailable (a transient failure at grid 0's second
    sweep) with PHOTON_MAX_RESTARTS=1: one restart from the sweep-0
    checkpoint, and the uninterrupted models."""
    monkeypatch.setenv("PHOTON_FAULTS", "descent.sweep@2=unavailable")
    monkeypatch.setenv("PHOTON_MAX_RESTARTS", "1")
    t = _port_run(avro_dirs, tmp_path, "--checkpoint-sweeps")
    assert [e.split(":")[0] for e in t["fit_stats"]["restarts"]] == ["InjectedFault"]
    _assert_uninterrupted(trained, tmp_path)


def test_injected_nan_without_restarts_raises_divergence(avro_dirs, tmp_path, monkeypatch,
                                                         clear_faults):
    from photon_tpu.obs.health import DivergenceError as JDivergence
    from photon_tpu_torch.obs.health import DivergenceError as TDivergence

    monkeypatch.setenv("PHOTON_FAULTS", "descent.coordinate@3=nan")
    with float64_drivers():
        with pytest.raises(JDivergence, match="'global' diverged at sweep 1"):
            j_gt.run(_train_argv(avro_dirs, tmp_path / "jax"))
        with pytest.raises(TDivergence, match="'global' diverged at sweep 1"):
            t_gt.run(_train_argv(avro_dirs, tmp_path / "port"), device="cpu")


def test_model_snapshot_then_warm_start_equal_jax(avro_dirs, trained, tmp_path):
    """--model-checkpoint-directory saves the final model as a snapshot
    equal to the run's last model; a second run with
    --warm-start-input-directory starts from it; both packages agree, and
    each package's snapshot loads in the other with equal arrays."""
    from photon_tpu.game.checkpoint import ModelCheckpointStore as JStore
    from photon_tpu_torch.game.checkpoint import ModelCheckpointStore as TStore

    _each(avro_dirs, tmp_path / "snap",
          lambda sub: ("--model-checkpoint-directory", str(tmp_path / "ckpt" / sub)))
    t_model, t_seq = TStore(str(tmp_path / "ckpt" / "port")).load_latest()
    j_model, j_seq = JStore(str(tmp_path / "ckpt" / "jax")).load_latest()
    assert t_seq == j_seq == 0
    trained_last = _coefficients(tmp_path / "snap" / "port" / "models" / "1")
    assert trained_last == _coefficients(tmp_path / "snap" / "port" / "models" / "1")
    for cid in ("global", "per-user"):
        assert type(t_model[cid]).__name__ == type(j_model[cid]).__name__
    np.testing.assert_allclose(t_model["global"].coefficients.means,
                               np.asarray(j_model["global"].model.coefficients.means),
                               rtol=1e-7, atol=1e-10)
    # the other package's snapshot loads with the same arrays it saved
    cross_t, _ = TStore(str(tmp_path / "ckpt" / "jax")).load_latest()
    np.testing.assert_array_equal(cross_t["global"].coefficients.means,
                                  np.asarray(j_model["global"].model.coefficients.means))
    cross_j, _ = JStore(str(tmp_path / "ckpt" / "port")).load_latest()
    np.testing.assert_array_equal(np.asarray(cross_j["global"].model.coefficients.means),
                                  t_model["global"].coefficients.means)

    j, t = _each(avro_dirs, tmp_path / "warm",
                 lambda sub: ("--warm-start-input-directory", str(tmp_path / "ckpt" / sub)))
    _assert_summaries_close(_summary(tmp_path / "warm" / "jax"), _summary(tmp_path / "warm" / "port"))
    for sub in ("best", "models/0", "models/1"):
        _assert_models_close(tmp_path / "warm" / "jax" / sub, tmp_path / "warm" / "port" / sub)
    # a warm start is not the cold fit
    assert _coefficients(tmp_path / "warm" / "port" / "models" / "0") != _coefficients(
        tmp_path / "snap" / "port" / "models" / "0")


def test_tuning_random_equals_jax(avro_dirs, tmp_path):
    """RANDOM tuning: the same candidates (regularization weights) and
    evaluations as JAX's within 1e-9, after the 2 grid models."""
    j, t = _each(avro_dirs, tmp_path, lambda sub: (
        "--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", "2"))
    ts, js = _summary(tmp_path / "port"), _summary(tmp_path / "jax")
    assert len(ts["models"]) == 4
    _assert_summaries_close(js, ts)
    for sub in ("best", "models/2", "models/3"):
        _assert_models_close(tmp_path / "jax" / sub, tmp_path / "port" / sub)


def test_tuning_bayesian_equals_jax(avro_dirs, tmp_path):
    """BAYESIAN tuning: the GP's expected-improvement argmax picks the
    same candidates as JAX's (the same numpy code on evaluations within
    roundoff), with the same evaluations."""
    j, t = _each(avro_dirs, tmp_path, lambda sub: (
        "--hyper-parameter-tuning", "BAYESIAN", "--hyper-parameter-tuning-iter", "3"))
    ts, js = _summary(tmp_path / "port"), _summary(tmp_path / "jax")
    assert len(ts["models"]) == 5
    _assert_summaries_close(js, ts)
    assert all(np.isfinite(m["evaluation"]) for m in ts["models"])


def test_saved_observations_and_priors_with_shrink_radius_equal_jax(avro_dirs, tmp_path):
    """--hyper-parameter-save-observations writes the grid's observations
    as prior JSON (tuning mode NONE); fed back with a shrink radius, RANDOM
    tuning searches the same shrunk box in both packages."""
    from photon_tpu_torch.hyperparameter.serialization import priors_from_json

    obs = {sub: tmp_path / f"obs-{sub}.json" for sub in ("jax", "port")}
    _each(avro_dirs, tmp_path / "grid",
          lambda sub: ("--hyper-parameter-save-observations", str(obs[sub])))
    tj, tt = (json.loads(obs[s].read_text()) for s in ("jax", "port"))
    assert len(tt["records"]) == len(tj["records"]) == 2
    for a, b in zip(tt["records"], tj["records"]):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_allclose(float(a[k]), float(b[k]), rtol=1e-9)
    parsed = priors_from_json(obs["port"].read_text(), ["global", "per-user"],
                              {"global": 1.0, "per-user": 1.0})
    assert [p for p, _ in parsed] == [{"global": 1.0, "per-user": 1.0},
                                      {"global": 10.0, "per-user": 1.0}]

    _each(avro_dirs, tmp_path / "tuned", lambda sub: (
        "--hyper-parameter-tuning", "RANDOM", "--hyper-parameter-tuning-iter", "2",
        "--hyper-parameter-prior-json", str(obs[sub]),
        "--hyper-parameter-shrink-radius", "0.2"))
    ts, js = _summary(tmp_path / "tuned" / "port"), _summary(tmp_path / "tuned" / "jax")
    assert len(ts["models"]) == 4
    _assert_summaries_close(js, ts)
    # the tuned weights lie in the box shrunk around the best prior
    for m in ts["models"][2:]:
        for v in m["regularizationWeights"].values():
            assert 1e-4 <= v <= 1e4


def test_recovery_flag_errors_equal_jax(avro_dirs, tmp_path):
    """--checkpoint-sweeps without --output-mode ALL is refused, as are a
    warm start together with an initial model, and tuning without
    validation data."""
    cases = [
        (["--checkpoint-sweeps", "--output-mode", "BEST"], "requires --output-mode ALL"),
        (["--warm-start-input-directory", "w", "--model-input-directory", "m"],
         "mutually exclusive"),
    ]
    for extra, match in cases:
        for sub, run in (("jax", j_gt.run), ("port", functools.partial(t_gt.run, device="cpu"))):
            with pytest.raises(ValueError, match=match):
                run(_train_argv(avro_dirs, tmp_path / sub, *extra))
            assert not (tmp_path / sub).exists()
    argv = [a for a in _train_argv(avro_dirs, tmp_path / "nv", "--hyper-parameter-tuning",
                                   "RANDOM")]
    i = argv.index("--validation-data-directories")
    del argv[i:i + 2]
    with float64_drivers():
        with pytest.raises(ValueError, match="requires validation data"):
            t_gt.run(argv, device="cpu")


# ---------------------------------------------------------------------------
# out-of-core streaming training
# ---------------------------------------------------------------------------

STREAM_ARGS = [
    "--training-task", "LOGISTIC_REGRESSION",
    "--feature-shard-configurations", SHARD_ARG,
    "--coordinate-configurations",
    "name=per-user,random.effect.type=userId,feature.shard=global,"
    "max.iter=15,regularization=L2,reg.weights=1|10",
    "--coordinate-update-sequence", "per-user",
    "--coordinate-descent-iterations", "2",
    "--output-mode", "ALL",
    "--stream-chunk-rows", "256",
]


def _recording_estimator(fits):
    """The driver's GameEstimator, recording each fit's estimator, data
    and keyword arguments."""

    class Recording(t_gt.GameEstimator):
        def fit(self, data, **kw):
            fits.append((self, data, kw))
            return super().fit(data, **kw)

    return Recording


def _direct_stream_fit(est, data, **kw):
    """The recorded fit again, through GameEstimator directly."""
    direct = t_gt.GameEstimator(
        task=est.task, coordinate_configs=est.coordinate_configs,
        update_sequence=est.update_sequence, descent_iterations=est.descent_iterations,
        device="cpu",
    )
    return direct.fit(data, stream=256, **kw)


def _assert_game_models_bit_equal(a, b):
    assert a.coordinates.keys() == b.coordinates.keys()
    for cid, ma in a.coordinates.items():
        mb = b.coordinates[cid]
        assert list(ma.vocab) == list(mb.vocab)
        for ba, bb in zip(ma.buckets, mb.buckets, strict=True):
            assert np.array_equal(ba.coefficients, bb.coefficients)


def test_streaming_driver_with_snapshot_then_warm_start(avro_dirs, tmp_path, monkeypatch):
    """--stream-chunk-rows with --model-checkpoint-directory, then with
    --warm-start-input-directory on that snapshot: each run's models equal
    GameEstimator(...).fit(data, stream=256) on the data the driver read,
    the cold run's equal the materialized driver's (every bucket fits in
    one chunk at 256 rows, so bit for bit), and the run profile
    carries the train.stream.* stage histograms."""
    monkeypatch.delenv("PHOTON_STREAM_CHUNK_ROWS", raising=False)
    fits = []
    monkeypatch.setattr(t_gt, "GameEstimator", _recording_estimator(fits))
    ckpt = tmp_path / "snapshots"
    base = ["--input-data-directories", str(avro_dirs / "train"), *STREAM_ARGS]
    cold = t_gt.run(base + ["--root-output-directory", str(tmp_path / "cold"),
                            "--model-checkpoint-directory", str(ckpt)], device="cpu")
    warm = t_gt.run(base + ["--root-output-directory", str(tmp_path / "warm"),
                            "--warm-start-input-directory", str(ckpt)], device="cpu")
    assert [kw["stream"] for _, _, kw in fits] == [256, 256]
    assert "stream" in cold["fit_stats"] and "stream" in warm["fit_stats"]

    (est, data, _), (_, data_w, _) = fits
    want = _direct_stream_fit(est, data)
    for got, exp in zip(cold["results"], want, strict=True):
        _assert_game_models_bit_equal(got.model, exp.model)
    # the driver loads the snapshot the cold run saved, as the direct call does
    snap = tmp_path / "snapshot-copy"
    shutil.copytree(ckpt, snap)
    want_w = _direct_stream_fit(est, data_w, warm_start=str(snap))
    for got, exp in zip(warm["results"], want_w, strict=True):
        _assert_game_models_bit_equal(got.model, exp.model)
    assert _coefficients(tmp_path / "warm" / "models" / "0") != _coefficients(
        tmp_path / "cold" / "models" / "0")

    materialized = t_gt.run(
        [a for a in base if a not in ("--stream-chunk-rows", "256")]
        + ["--root-output-directory", str(tmp_path / "materialized")], device="cpu")
    for sub in ("best", "models/0", "models/1"):
        _assert_models_equal(tmp_path / "cold" / sub, tmp_path / "materialized" / sub)
    assert "stream" not in materialized["fit_stats"]

    metrics = json.loads((tmp_path / "cold" / "obs" / "metrics.json").read_text())
    names = json.dumps(metrics)
    for stage in ("queue", "h2d", "dispatch", "readback", "pipeline"):
        assert f"train.stream.stage_seconds.{stage}" in names


def test_streaming_driver_refuses_a_trainable_fixed_effect(avro_dirs, tmp_path):
    from photon_tpu_torch.game.streaming import StreamingModeError

    argv = ["--input-data-directories", str(avro_dirs / "train"),
            "--root-output-directory", str(tmp_path / "o"),
            *[a for a in TRAIN_ARGS if a != "AUC:userId,AUC" and a != "--evaluators"],
            "--stream-chunk-rows", "96"]
    with pytest.raises(StreamingModeError, match="LOCKED"):
        t_gt.run(argv, device="cpu")
    assert not (tmp_path / "o").exists()


# ---------------------------------------------------------------------------
# flags whose modules are not ported
# ---------------------------------------------------------------------------

_TRAIN = ["--input-data-directories", "x", "--root-output-directory", "{out}",
          "--training-task", "LOGISTIC_REGRESSION", "--feature-shard-configurations", SHARD_ARG,
          "--coordinate-configurations", "name=global,feature.shard=global",
          "--coordinate-update-sequence", "global"]
_SCORE = ["--input-data-directories", "x", "--root-output-directory", "{out}",
          "--feature-shard-configurations", SHARD_ARG, "--model-input-directory", "m"]
_INDEX = ["--input-data-directories", "x", "--root-output-directory", "{out}",
          "--feature-shard-configurations", SHARD_ARG]

UNPORTED = [
    (t_gt, _TRAIN, ["--mesh", "1x8"], "--mesh"),
    (t_gt, _TRAIN, ["--precompile"], "--precompile"),
]


@pytest.mark.parametrize("mod,base,extra,flag", UNPORTED,
                         ids=[f"{m.__name__.rsplit('.', 1)[1]}{e[0]}={e[-1]}"
                              for m, _, e, _ in UNPORTED])
def test_unported_flag_raises(tmp_path, mod, base, extra, flag):
    argv = [str(tmp_path / "o") if a == "{out}" else a for a in base] + extra
    kw = {} if mod is t_fi else {"device": "cpu"}
    with pytest.raises(NotImplementedError, match=flag):
        mod.run(argv, **kw)
    assert not (tmp_path / "o").exists()


def test_accepted_defaults_do_not_raise(tmp_path):
    """The values equal to the defaults pass the refusal: --feature-cache
    off, --max-restarts 0, PHOTON_SCORE_DEGRADE=0."""
    import argparse

    from photon_tpu_torch.cli import game_base

    parser = t_gt.build_parser()
    argv = [str(tmp_path / "o") if a == "{out}" else a for a in _TRAIN]
    args = parser.parse_args(argv + ["--feature-cache", "off", "--max-restarts", "0"])
    game_base.refuse_unported(args, parser, t_gt.UNPORTED_FLAGS)
    assert isinstance(args, argparse.Namespace)


def test_score_degrade_env_raises(tmp_path, monkeypatch, avro_dirs, trained):
    """An invalid PHOTON_SCORE_DEGRADE raises up front in both drivers,
    before any streaming starts."""
    monkeypatch.setenv("PHOTON_SCORE_DEGRADE", "true")
    argv = ["--input-data-directories", str(avro_dirs / "valid"),
            "--feature-shard-configurations", SHARD_ARG,
            "--model-input-directory", str(trained[0] / "jax" / "best")]
    for key, run in (("jax", j_gs.run), ("port", functools.partial(t_gs.run, device="cpu"))):
        with pytest.raises(ValueError, match="PHOTON_SCORE_DEGRADE must be 0 or 1"):
            run([*argv, "--root-output-directory", str(tmp_path / key)])
        assert not (tmp_path / key / "scores").exists()


# ---------------------------------------------------------------------------
# argument errors, data validation, partial labels, off-heap stores
# ---------------------------------------------------------------------------

_ARG_ERRORS = [
    (["--coordinate-configurations", "name=global,feature.shard=global"], "duplicate coordinate"),
    (["--feature-shard-configurations", SHARD_ARG], "duplicate feature shard"),
    (["--coordinate-configurations", "name=u,feature.shard=nope"], "unknown shards"),
    (["--partial-retrain-locked-coordinates", "global"], "requires --model-input-directory"),
    (["--ignore-threshold-for-new-models"], "requires --model-input-directory"),
]


@pytest.mark.parametrize("extra,match", _ARG_ERRORS, ids=[m for _, m in _ARG_ERRORS])
def test_training_argument_errors_equal(tmp_path, extra, match):
    argv = [str(tmp_path / "o") if a == "{out}" else a for a in _TRAIN] + extra
    for run, kw in ((j_gt.run, {}), (t_gt.run, {"device": "cpu"})):
        with pytest.raises(ValueError, match=match):
            run(argv, **kw)
    assert not (tmp_path / "o").exists()


def test_training_validates_validation_data_like_jax(avro_dirs, tmp_path):
    from photon_tpu.data.validators import DataValidationError as JError
    from photon_tpu_torch.data.validators import DataValidationError as TError

    bad = tmp_path / "bad"
    bad.mkdir()
    recs = _make_records(3, n=20)
    recs[5]["features"][0]["value"] = float("nan")
    write_avro_file(bad / "part-00000.avro", TRAINING_EXAMPLE_AVRO, recs)
    argv = ["--input-data-directories", str(avro_dirs / "train"),
            "--validation-data-directories", str(bad),
            "--root-output-directory", "{out}", "--training-task", "LOGISTIC_REGRESSION",
            "--feature-shard-configurations", SHARD_ARG,
            "--coordinate-configurations", "name=global,feature.shard=global,max.iter=5",
            "--coordinate-update-sequence", "global", "--evaluators", "AUC"]
    with pytest.raises(JError, match="shard 'global': features contain non-finite"):
        j_gt.run([str(tmp_path / "j") if a == "{out}" else a for a in argv])
    with pytest.raises(TError, match="shard 'global': features contain non-finite"):
        t_gt.run([str(tmp_path / "t") if a == "{out}" else a for a in argv], device="cpu")


@pytest.mark.parametrize("mode", ["stream", "monolithic"])
def test_scoring_partially_labeled_data_equals_jax(trained, tmp_path, mode):
    data = tmp_path / "partial"
    data.mkdir()
    recs = _make_records(4, n=80)
    for r in recs[:30]:
        r["label"] = None
    schema = dict(TRAINING_EXAMPLE_AVRO, fields=[
        {"name": "label", "type": ["null", "double"], "default": None}
        if f["name"] == "label" else f for f in TRAINING_EXAMPLE_AVRO["fields"]])
    write_avro_file(data / "part-00000.avro", schema, recs)
    argv = ["--input-data-directories", str(data), "--root-output-directory", "{out}",
            "--feature-shard-configurations", SHARD_ARG, "--evaluators", "AUC,AUC:userId",
            "--model-input-directory", str(trained[0] / "jax" / "best")]
    if mode == "monolithic":
        argv.append("--monolithic-scoring")
    j, t = _both(j_gs.run, t_gs.run, argv, tmp_path / "out")
    tol = 1e-9 if mode == "monolithic" else 1e-5
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=tol, atol=tol)
    assert t["evaluations"].keys() == j["evaluations"].keys() == {"AUC", "AUC:userId"}
    for k, v in j["evaluations"].items():
        np.testing.assert_allclose(t["evaluations"][k], v, atol=tol)
    log_text = (tmp_path / "out" / "port" / "driver.log").read_text()
    assert "30 excluded for non-finite labels" in log_text
    labels = [r["label"] for r in read_avro_dir(tmp_path / "out" / "port" / "scores")]
    assert sum(x is None for x in labels) == 0  # NaN labels are written as NaN doubles
    assert sum(np.isnan(x) for x in labels) == 30


def test_scoring_falls_back_to_the_host_path_for_wide_random_effects(trained, avro_dirs,
                                                                      tmp_path, monkeypatch):
    """A layout the device scorer cannot express (an index-mapped random
    effect on a shard wider than its dense gather limit) is scored on the
    host, as in JAX."""
    from photon_tpu_torch.game import scoring as t_scoring

    monkeypatch.setattr(t_scoring, "DENSE_COLS_MAX", 4)
    model = trained[0] / "jax" / "best"
    out = t_gs.run(["--input-data-directories", str(avro_dirs / "valid"),
                    "--root-output-directory", str(tmp_path / "t"),
                    "--feature-shard-configurations", SHARD_ARG,
                    "--model-input-directory", str(model)], device="cpu")
    assert out["scoring"]["mode"] == "monolithic"
    want = j_gs.run(["--input-data-directories", str(avro_dirs / "valid"),
                     "--root-output-directory", str(tmp_path / "j"),
                     "--feature-shard-configurations", SHARD_ARG,
                     "--model-input-directory", str(model), "--monolithic-scoring"])
    np.testing.assert_allclose(out["scores"], want["scores"], rtol=1e-12, atol=1e-12)


def test_off_heap_index_store_train_and_score_equal_jax(avro_dirs, tmp_path):
    t_fi.run(["--input-data-directories", str(avro_dirs / "train"),
              "--feature-shard-configurations", SHARD_ARG,
              "--root-output-directory", str(tmp_path / "index"), "--num-partitions", "2"])
    store = ["--off-heap-index-map-dir", str(tmp_path / "index")]
    argv = ["--input-data-directories", str(avro_dirs / "train"),
            "--root-output-directory", "{out}", "--training-task", "LOGISTIC_REGRESSION",
            "--feature-shard-configurations", SHARD_ARG, *store,
            "--coordinate-configurations",
            "name=global,feature.shard=global,max.iter=10,regularization=L2,reg.weights=1",
            "--coordinate-update-sequence", "global"]
    with float64_drivers():
        _both(j_gt.run, t_gt.run, argv, tmp_path / "train")
    _assert_models_close(tmp_path / "train" / "jax" / "best", tmp_path / "train" / "port" / "best")
    score = ["--input-data-directories", str(avro_dirs / "valid"),
             "--root-output-directory", "{out}", "--feature-shard-configurations", SHARD_ARG,
             *store, "--model-input-directory", str(tmp_path / "train" / "port" / "best"),
             "--monolithic-scoring"]
    j, t = _both(j_gs.run, t_gs.run, score, tmp_path / "score")
    np.testing.assert_allclose(t["scores"], j["scores"], rtol=1e-12, atol=1e-12)


def test_date_ranged_input_paths_equal(tmp_path):
    from photon_tpu.cli import game_base as j_base
    from photon_tpu_torch.cli import game_base as t_base

    for day in ("20240101", "20240103", "20240104"):
        (tmp_path / "daily" / day[:4] / day[4:6] / day[6:]).mkdir(parents=True)
    for rng_arg in ("20240101-20240103", "20231231-20240104"):
        args = t_gt.build_parser().parse_args(
            [str(tmp_path) if a == "x" else a for a in _TRAIN]
            + ["--input-data-date-range", rng_arg])
        assert t_base.resolve_input_paths(args) == j_base.resolve_input_paths(args)
        assert len(t_base.resolve_input_paths(args)) >= 2
