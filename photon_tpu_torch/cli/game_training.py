"""GAME training driver (reference cli/game/training/GameTrainingDriver.scala).

Pipeline (reference ``run`` :335-474): read Avro → feature maps → data
validation → per-shard stats + normalization contexts → GameEstimator.fit
over the λ grid (warm-started) → model selection → save model(s).

Counterpart of photon_tpu/cli/game_training.py with the same parser; the
fit runs on ``device`` (the card unless ``run(..., device="cpu")``).
Hyperparameter tuning, checkpoints with resume (``--checkpoint-sweeps``,
which needs ``--output-mode ALL``), supervised restarts, warm starts from
model snapshots, the feature cache (``--feature-cache``: the training
and validation reads go through ``cache.resolve_reader``) and the
``PHOTON_FAULTS`` fault plan work as in JAX's driver, and so does
out-of-core streaming training (``--stream-chunk-rows``, game/
streaming.py; a fit it does not support is refused before any output is
written), and so does ``--precompile`` (every sweep and score program
warmed before the first sweep, game/descent.precompile_coordinates), and
so does ``--mesh`` / ``PHOTON_MESH`` (parallel/mesh.py): ``--mesh 1x1``
fits on a world of one with no launcher, and under ``torchrun
--nproc-per-node N`` every rank runs this driver with ``--mesh DxE``
(D×E = N), reads the same input (the whole of it: a meshed run reads
with ingest shard ``(0, 1)`` whatever ``PHOTON_INGEST_SHARD`` or the
world says), fits its part and returns the same models, while only rank
0 writes the output directory's models, summary and checkpoints (each
other rank keeps its own ``driver-rank<r>.log``). In a world of more
than one rank the fleet plane is on (obs/fleet.py): every rank keeps its
telemetry under ``obs/p<rank>/`` and rank 0 writes
``obs/fleet_report.json``; with ``PHOTON_OBS_FLEET=0`` only rank 0 keeps
``obs/``. The process group ends on every exit path. Without a mesh, a
process of a multi-process run (``PHOTON_INGEST_SHARD=i/n``, or a live
group) reads and fits its own round-robin subset of the part files.

Usage:
    python -m photon_tpu_torch.cli.game_training \
      --input-data-directories /data/train \
      --root-output-directory /out \
      --training-task LOGISTIC_REGRESSION \
      --feature-shard-configurations name=global,feature.bags=features \
      --coordinate-configurations name=global,feature.shard=global,optimizer=LBFGS,regularization=L2,reg.weights=1|10 \
      --coordinate-update-sequence global \
      --coordinate-descent-iterations 1

    torchrun --nproc-per-node 4 -m photon_tpu_torch.cli.game_training \
      ... --mesh 2x2
"""
from __future__ import annotations

import argparse
import dataclasses
import enum
import json
import os
import sys

import numpy as np

from photon_tpu_torch.cli import game_base
from photon_tpu_torch.cli.parsing import parse_coordinate_config
from photon_tpu_torch.data.index_map import INTERCEPT_KEY, INTERSECT
from photon_tpu_torch.data.stats import BasicStatisticalSummary
from photon_tpu_torch.data.validators import DataValidationType, validate_game_data
from photon_tpu_torch.evaluation.multi import GroupedEvaluatorSpec
from photon_tpu_torch.game.config import required_id_tags
from photon_tpu_torch.game.checkpoint import MANIFEST as CKPT_MANIFEST
from photon_tpu_torch.game.estimator import GameEstimator, GameTrainingResult
from photon_tpu_torch.game.streaming import validate_streaming
from photon_tpu_torch.game.tuning import run_hyperparameter_tuning
from photon_tpu_torch.hyperparameter.serialization import priors_to_json
from photon_tpu_torch.io.avro import write_avro_file
from photon_tpu_torch.io.model_io import load_game_model, save_game_model
from photon_tpu_torch.io.schemas import FEATURE_SUMMARIZATION_RESULT_AVRO
from photon_tpu_torch.obs import fleet
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optimize.problem import VarianceComputationType
from photon_tpu_torch.parallel.mesh import destroy_mesh, on_rank0, resolve_mesh
from photon_tpu_torch.types import NormalizationType, TaskType, resolve_device
from photon_tpu_torch.util import EventEmitter, PhotonLogger, faults, prepare_output_dir

MODELS_DIR = "models"
BEST_MODEL_DIR = "best"
SUMMARY_FILE = "training-summary.json"
CHECKPOINTS_DIR = "checkpoints"
#: one JSON line per finished grid point, beside the checkpoints
GRID_RESULTS_FILE = "grid-results.jsonl"


class ModelOutputMode(enum.Enum):
    """Which trained models to persist (reference ModelOutputMode.scala)."""

    NONE = "NONE"
    BEST = "BEST"
    ALL = "ALL"


class HyperparameterTuningMode(enum.Enum):
    NONE = "NONE"
    RANDOM = "RANDOM"
    BAYESIAN = "BAYESIAN"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="game-training",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    game_base.add_common_arguments(p)
    p.add_argument("--training-task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--validation-data-directories", default=None)
    p.add_argument("--validation-data-date-range", default=None)
    p.add_argument(
        "--coordinate-configurations",
        action="append",
        required=True,
        metavar="name=<id>,feature.shard=<shard>,...",
        help="repeatable; one coordinate per instance (see cli/parsing.py)",
    )
    p.add_argument(
        "--coordinate-update-sequence",
        required=True,
        help="comma-separated coordinate ids, trained in order",
    )
    p.add_argument("--coordinate-descent-iterations", type=int, default=1)
    p.add_argument(
        "--normalization", default="NONE", choices=[t.name for t in NormalizationType]
    )
    p.add_argument("--data-summary-directory", default=None)
    p.add_argument(
        "--partial-retrain-locked-coordinates",
        default=None,
        help="comma-separated coordinate ids to keep fixed (requires --model-input-directory)",
    )
    p.add_argument("--model-input-directory", default=None)
    p.add_argument(
        "--ignore-threshold-for-new-models",
        action="store_true",
        help="warm start: entities WITHOUT a prior random-effect model "
        "bypass the active-data lower bound (requires "
        "--model-input-directory; reference GameEstimator.scala:127-133)",
    )
    p.add_argument("--output-mode", default="BEST", choices=[m.name for m in ModelOutputMode])
    p.add_argument(
        "--hyper-parameter-tuning",
        default="NONE",
        choices=[m.name for m in HyperparameterTuningMode],
        help="tune the regularization weights after the grid (needs validation "
        "data and an evaluator)",
    )
    p.add_argument("--hyper-parameter-tuning-iter", type=int, default=10)
    p.add_argument(
        "--hyper-parameter-prior-json", default=None,
        help="observations of earlier runs (the format --hyper-parameter-save-observations "
        "writes) to start the search from",
    )
    p.add_argument(
        "--hyper-parameter-shrink-radius", type=float, default=None,
        help="shrink the search box around the best prior to ±radius (unit cube)",
    )
    p.add_argument(
        "--hyper-parameter-save-observations", default=None,
        help="write every evaluated (weights, metric) pair as prior JSON",
    )
    p.add_argument(
        "--mesh", default=None, metavar="DxE|N|auto",
        help="span the fit over a mesh of ranks: 'DxE' (data x entity, e.g. 1x8), 'N' (N "
        "ranks on the data axis) or 'auto' (every rank on the data axis); D x E must equal "
        "the world size (1 without a launcher, torchrun's --nproc-per-node under it). "
        "Fixed-effect rows shard over every rank, random-effect entities over the entity "
        "axis; checkpoints fingerprint the topology. env PHOTON_MESH overrides; default off",
    )
    p.add_argument(
        "--precompile", action="store_true",
        help="warm every sweep and score program of the fit before its first sweep (each "
        "runs once from a throwaway state), so no sweep pays a one-time cost",
    )
    p.add_argument("--compute-variance", action="store_true")
    p.add_argument("--model-sparsity-threshold", type=float, default=1e-4)
    p.add_argument(
        "--data-validation",
        default="VALIDATE_FULL",
        choices=[t.name for t in DataValidationType],
    )
    p.add_argument(
        "--max-restarts", type=int, default=None,
        help="restart a fit that failed with a transient or divergent error, from its "
        "newest checkpoint (PHOTON_MAX_RESTARTS wins)",
    )
    p.add_argument(
        "--stream-chunk-rows", type=int, default=None, metavar="ROWS",
        help="train OUT-OF-CORE: keep datasets host-resident and stream fixed-shape "
        "chunks of ~ROWS sample rows through the double-buffered sweep pipeline "
        "(game/streaming.py) — bounded device residency, bit-identical coefficients, "
        "zero steady-state one-time costs. Fixed-effect coordinates must be locked "
        "(--partial-retrain-locked-coordinates) or absent. env PHOTON_STREAM_CHUNK_ROWS "
        "overrides the value",
    )
    p.add_argument(
        "--warm-start-input-directory", default=None,
        help="model snapshot directory whose newest snapshot is the initial model",
    )
    p.add_argument(
        "--model-checkpoint-directory", default=None,
        help="save the final model there as the next model snapshot",
    )
    p.add_argument(
        "--checkpoint-sweeps", action="store_true",
        help="checkpoint every sweep under <root>/checkpoints and resume from it when "
        "rerun (needs --output-mode ALL)",
    )
    return p


def _normalization_contexts(norm_type, data, shard_configs, index_maps):
    """Per-shard stats + normalization contexts (reference
    prepareNormalizationContextWrappers, GameEstimator.scala:698)."""
    contexts: dict[str, NormalizationContext] = {}
    summaries: dict[str, BasicStatisticalSummary] = {}
    for shard in shard_configs:
        summary = BasicStatisticalSummary.of(data.shard_dataset(shard))
        summaries[shard] = summary
        icpt = index_maps[shard].get_index(INTERCEPT_KEY)
        contexts[shard] = NormalizationContext.build(
            norm_type,
            mean=summary.mean,
            variance=summary.variance,
            max_magnitude=np.maximum(np.abs(summary.max), np.abs(summary.min)),
            intercept_index=None if icpt < 0 else icpt,
        )
    return contexts, summaries


def _save_summary_stats(path, summaries, index_maps) -> None:
    """Feature statistics as FeatureSummarizationResultAvro records
    (reference ModelProcessingUtils.writeBasicStatistics:515-585), one
    ``<shard>/part-00000.avro`` per feature shard."""
    for shard, s in summaries.items():
        imap = index_maps[shard]
        records = []
        for j in range(len(imap)):
            name, _, term = imap.get_feature_name(j).partition(INTERSECT)
            records.append({
                "featureName": name,
                "featureTerm": term,
                "metrics": {
                    "max": float(s.max[j]),
                    "min": float(s.min[j]),
                    "mean": float(s.mean[j]),
                    "normL1": float(s.norm_l1[j]),
                    "normL2": float(s.norm_l2[j]),
                    "numNonzeros": float(s.num_nonzeros[j]),
                    "variance": float(s.variance[j]),
                },
            })
        shard_dir = os.path.join(path, shard)
        os.makedirs(shard_dir, exist_ok=True)
        write_avro_file(
            os.path.join(shard_dir, "part-00000.avro"), FEATURE_SUMMARIZATION_RESULT_AVRO, records
        )


def _restore_skipped_grid_results(results, grid_results_path, out_root, index_maps, log):
    """Fill the None placeholders a checkpoint resume leaves for grid
    points finished before the interruption: evaluations come from the
    checkpoint's grid-results.jsonl sidecar, models reload from the
    ``models/<i>`` directories written as those points finished."""
    recorded = {}
    if grid_results_path and os.path.exists(grid_results_path):
        with open(grid_results_path) as f:
            for line in f:
                try:
                    row = json.loads(line)
                except json.JSONDecodeError:
                    # a line cut short by the very crash being recovered from
                    continue
                recorded[row["grid_index"]] = row
    out = []
    for gi, r in enumerate(results):
        if r is not None:
            out.append(r)
            continue
        row = recorded.get(gi, {})
        model_dir = os.path.join(out_root, MODELS_DIR, str(gi))
        model = None
        if os.path.isdir(model_dir):
            model = load_game_model(model_dir, index_maps)
        else:
            log.warning(
                "resume: grid %d model not on disk (run with output mode ALL to keep "
                "completed models reloadable)", gi,
            )
        out.append(
            GameTrainingResult(
                model=model,
                evaluation=row.get("evaluation"),
                regularization_weights=row.get("regularization_weights", {}),
                tracker=[],
                wall_time_s=row.get("wall_time_s", 0.0),
                scores=None,
            )
        )
    return out


def _select_best(results: list[GameTrainingResult], evaluator) -> int:
    """Index of the best model (reference selectBestModel :677-720): by
    validation metric when present, else the first."""
    if evaluator is None or all(r.evaluation is None for r in results):
        return 0
    worst = -np.inf if evaluator.larger_is_better else np.inf
    vals = [worst if r.evaluation is None else r.evaluation for r in results]
    return int(np.argmax(vals) if evaluator.larger_is_better else np.argmin(vals))


def run(argv=None, *, device="cuda", events=None) -> dict:
    """``events``: an ``EventEmitter`` whose listeners hear the driver's
    ``setup``, ``training_start`` and ``driver_finish`` and the
    estimator's lifecycle events."""
    parser = build_parser()
    args = parser.parse_args(argv)
    device = resolve_device(device)
    # (re)install the PHOTON_FAULTS plan per run; an unset variable
    # clears any plan left over from an earlier run in this process
    faults.install_from_env()
    # before any output: a mesh that does not cover the world raises here
    mesh = resolve_mesh(args.mesh, device=device)
    try:
        return _run(args, mesh.device if mesh.distributed else device, events, mesh)
    finally:
        destroy_mesh(mesh)


def _run(args, device, events, mesh) -> dict:
    #: whether this process writes the output directory (rank 0 of a mesh)
    primary = mesh.rank == 0
    task = TaskType[args.training_task]
    shard_configs = game_base.parse_shard_configs(args)
    coordinate_configs = {}
    for s in args.coordinate_configurations:
        name, cfg = parse_coordinate_config(s, task)
        if name in coordinate_configs:
            raise ValueError(f"duplicate coordinate {name!r}")
        if args.compute_variance:
            cfg = dataclasses.replace(
                cfg,
                optimization=dataclasses.replace(
                    cfg.optimization, variance_computation=VarianceComputationType.FULL
                ),
            )
        coordinate_configs[name] = cfg
    update_sequence = [c.strip() for c in args.coordinate_update_sequence.split(",") if c.strip()]
    missing_shards = {
        c.feature_shard
        for c in coordinate_configs.values()
        if getattr(c, "feature_shard", None) is not None
    } - set(shard_configs)
    if missing_shards:
        raise ValueError(f"coordinates reference unknown shards {missing_shards}")
    locked = frozenset(
        c.strip() for c in (args.partial_retrain_locked_coordinates or "").split(",") if c.strip()
    )
    if locked and not args.model_input_directory:
        raise ValueError("--partial-retrain-locked-coordinates requires --model-input-directory")
    if args.ignore_threshold_for_new_models and not args.model_input_directory:
        raise ValueError("--ignore-threshold-for-new-models requires --model-input-directory")
    if args.warm_start_input_directory and args.model_input_directory:
        raise ValueError(
            "--warm-start-input-directory and --model-input-directory are mutually "
            "exclusive (both supply the initial model)"
        )

    evaluators = game_base.evaluators_from_args(args)
    validation_evaluator = evaluators[0] if evaluators else None
    evaluator_tags = {ev.id_tag for ev in evaluators if isinstance(ev, GroupedEvaluatorSpec)}
    # the training read needs only coordinate tags; evaluator-only tags are
    # read on the (smaller) validation data alone
    id_tags = sorted(required_id_tags(coordinate_configs.values()))
    validation_id_tags = sorted(set(id_tags) | evaluator_tags)
    if args.stream_chunk_rows is not None:
        # what the fit would refuse, refused before any output is written
        validate_streaming(
            coordinate_configs, locked,
            device_validation=bool(args.validation_data_directories)
            and validation_evaluator is not None,
        )

    save_all = ModelOutputMode[args.output_mode] == ModelOutputMode.ALL
    ckpt_dir = (
        os.path.join(args.root_output_directory, CHECKPOINTS_DIR)
        if args.checkpoint_sweeps
        else None
    )
    if ckpt_dir is not None and not save_all:
        # a resume reloads the models finished before the kill from disk,
        # which only output mode ALL writes: refuse the dead end early
        raise ValueError("--checkpoint-sweeps requires --output-mode ALL")
    resuming = (
        ckpt_dir is not None
        and os.path.exists(os.path.join(ckpt_dir, CKPT_MANIFEST))
        and not args.override_output_directory  # override = wipe + fresh run
    )
    # a resume reuses the existing output tree by definition; otherwise rank
    # 0 makes it, and every rank learns whether it could
    out_root = str(args.root_output_directory)
    if not resuming:
        on_rank0(mesh, lambda: prepare_output_dir(
            out_root, override=args.override_output_directory))
    emitter = events if events is not None else EventEmitter()
    decoders = {}
    walls: dict[str, float] = {}
    log_name = "driver.log" if primary else f"driver-rank{mesh.rank}.log"
    # every rank of a fleet keeps its telemetry under obs/p<k>; without the
    # fleet plane only rank 0 has an obs directory
    profiled = primary or fleet.fleet_enabled()
    # a meshed fit needs the whole input on every rank: its reads take
    # ingest shard (0, 1) whatever the world (cache.ingest_shard)
    read_shard = (0, 1) if mesh.distributed else None
    with game_base.run_profile(out_root if profiled else None), PhotonLogger(
        os.path.join(out_root, log_name), level=args.log_level
    ) as log:
        # driver-level boundary; the estimator adds the per-fit events
        emitter.emit("setup", application=args.application_name)

        with game_base.phase(walls, "read training data"):
            paths = game_base.resolve_input_paths(args)
            index_maps = game_base.prepare_feature_maps(args, shard_configs)
            data, index_maps, decoders["training"] = game_base.read_game_data(
                paths, shard_configs, index_maps, id_tags, log=log, cache=args.feature_cache,
                shard=read_shard,
            )
        log.info(
            "read %d samples, shards %s",
            data.num_samples,
            {s: m.num_cols for s, m in data.feature_shards.items()},
        )

        validation_data = None
        if args.validation_data_directories:
            with game_base.phase(walls, "read validation data"):
                v_args = argparse.Namespace(
                    input_data_directories=args.validation_data_directories,
                    input_data_date_range=args.validation_data_date_range,
                    input_data_days_range=None,
                )
                validation_data, _, decoders["validation"] = game_base.read_game_data(
                    game_base.resolve_input_paths(v_args), shard_configs, index_maps,
                    validation_id_tags, log=log, cache=args.feature_cache, shard=read_shard,
                )

        with game_base.phase(walls, "data validation"):
            mode = DataValidationType[args.data_validation]
            validate_game_data(data, task, mode)
            if validation_data is not None:
                validate_game_data(validation_data, task, mode)

        norm_type = NormalizationType[args.normalization]
        contexts = None
        if norm_type != NormalizationType.NONE or args.data_summary_directory:
            with game_base.phase(walls, "feature statistics"):
                contexts, summaries = _normalization_contexts(
                    norm_type, data, shard_configs, index_maps
                )
            if args.data_summary_directory:
                _save_summary_stats(args.data_summary_directory, summaries, index_maps)
            if norm_type == NormalizationType.NONE:
                contexts = None

        initial_model = None
        if args.model_input_directory:
            with game_base.phase(walls, "load initial model"):
                initial_model = load_game_model(args.model_input_directory, index_maps)

        if mesh.distributed:
            log.info("training spans a %s mesh of ranks (axes %s)",
                     "x".join(str(n) for n in mesh.dims), mesh.axis_names)
        estimator = GameEstimator(
            task=task,
            coordinate_configs=coordinate_configs,
            update_sequence=update_sequence,
            descent_iterations=args.coordinate_descent_iterations,
            mesh=mesh,
            normalization_contexts=contexts,
            ignore_threshold_for_new_models=args.ignore_threshold_for_new_models,
            locked_coordinates=locked,
            validation_evaluator=validation_evaluator,
            device=device,
            events=emitter,
            max_restarts=args.max_restarts,
            precompile=args.precompile,
        )

        emitter.emit("training_start", task=task.name)

        def save(directory, result):
            if not primary:
                return
            with game_base.phase(walls, "save models"):
                save_game_model(
                    os.path.join(out_root, directory),
                    result.model,
                    index_maps,
                    optimization_configurations=result.regularization_weights,
                    sparsity_threshold=args.model_sparsity_threshold,
                )

        grid_results_path = (
            os.path.join(ckpt_dir, GRID_RESULTS_FILE) if ckpt_dir is not None else None
        )
        flushed = set()

        def grid_callback(gi, result):
            # under --checkpoint-sweeps each grid point's model and its
            # sidecar line go to disk as the point finishes, because a
            # resume reloads them from there; mid-fit, so every rank of a
            # mesh learns whether rank 0 could write them
            def write():
                save(os.path.join(MODELS_DIR, str(gi)), result)
                with open(grid_results_path, "a") as f:
                    f.write(json.dumps({
                        "grid_index": gi,
                        "regularization_weights": result.regularization_weights,
                        "evaluation": result.evaluation,
                        "wall_time_s": result.wall_time_s,
                    }) + "\n")

            on_rank0(mesh, write)
            flushed.add(gi)

        with game_base.phase(walls, "train"):
            results = estimator.fit(
                data,
                validation_data=validation_data,
                initial_model=initial_model,
                grid_callback=grid_callback if ckpt_dir is not None else None,
                checkpoint_dir=ckpt_dir,
                warm_start=args.warm_start_input_directory,
                model_checkpoint_dir=args.model_checkpoint_directory,
                stream=args.stream_chunk_rows,
            )
        fit_stats = estimator.last_fit_stats
        if fit_stats["resumed_from"] is not None:
            log.info("resumed from checkpoint: grid %d, sweep %d", *fit_stats["resumed_from"])
        for error in fit_stats["restarts"]:
            log.warning("the fit restarted after %s", error)
        # None placeholders: grid points finished before a resume
        if any(r is None for r in results):
            results = _restore_skipped_grid_results(
                results, grid_results_path, out_root, index_maps, log
            )

        tuning_mode = HyperparameterTuningMode[args.hyper_parameter_tuning]
        if tuning_mode != HyperparameterTuningMode.NONE:
            if validation_data is None or validation_evaluator is None:
                raise ValueError("hyperparameter tuning requires validation data + an evaluator")
            prior_json = None
            if args.hyper_parameter_prior_json:
                with open(args.hyper_parameter_prior_json) as f:
                    prior_json = f.read()
            with game_base.phase(walls, "hyperparameter tuning"):
                tuned = run_hyperparameter_tuning(
                    estimator,
                    data,
                    validation_data,
                    num_iterations=args.hyper_parameter_tuning_iter,
                    mode=tuning_mode.name,
                    prior_json=prior_json,
                    shrink_radius=args.hyper_parameter_shrink_radius,
                )
            results = results + tuned
        if args.hyper_parameter_save_observations and primary:
            # written for the plain λ grid too (mode NONE): every model
            # with a validation evaluation is a usable prior
            observations = [
                (r.regularization_weights, float(r.evaluation))
                for r in results
                if r.evaluation is not None
            ]
            with open(args.hyper_parameter_save_observations, "w") as f:
                f.write(priors_to_json(observations))

        if save_all:
            for i, r in enumerate(results):
                if i in flushed or r.model is None:
                    continue  # written as its grid point finished, now or before a resume
                save(os.path.join(MODELS_DIR, str(i)), r)
        best = _select_best(results, validation_evaluator)
        log.info(
            "trained %d models; best #%d (metric=%s)", len(results), best, results[best].evaluation
        )
        if ModelOutputMode[args.output_mode] != ModelOutputMode.NONE:
            if results[best].model is None:
                raise RuntimeError(
                    f"best model (grid {best}) was trained by an interrupted run but is "
                    "not on disk; rerun checkpointed jobs with --output-mode ALL"
                )
            save(BEST_MODEL_DIR, results[best])
        summary = {
            "models": [
                {
                    "regularizationWeights": r.regularization_weights,
                    "evaluation": r.evaluation,
                    "wallTimeS": r.wall_time_s,
                }
                for r in results
            ],
            "best": best,
            "task": task.name,
        }
        if primary:
            with open(os.path.join(out_root, SUMMARY_FILE), "w") as f:
                json.dump(summary, f, indent=2)
        if profiled:
            game_base.export_run_profile(out_root, log, meta={"driver": "game_training"})
        emitter.emit("driver_finish", num_models=len(results))
    return {
        "results": results,
        "best": best,
        "output": out_root,
        "index_maps": index_maps,
        "decoders": decoders,
        "fit_stats": fit_stats,
        "walls": walls,
    }


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
