"""Legacy single-GLM driver (reference photon-client Driver.scala:71-740).

Staged pipeline with stage assertions (DriverStage.scala:45-46):
INIT → PREPROCESSED → TRAINED → VALIDATED → DIAGNOSED. Trains one GLM per
regularization weight with warm starts (``train_glm_grid`` on ``device``,
the card unless ``run(..., device="cpu")``), computes validation metrics
per λ, selects the best model, with ``--diagnose`` writes the model
diagnostics (``diagnostics/report.{html,txt,json}``, the bootstrap and
learning-curve retrains on the device), and writes text coefficients and
an Avro model. Counterpart of photon_tpu/cli/legacy_driver.py with the
same parser.

Usage:
    python -m photon_tpu_torch.cli.legacy_driver \
      --training-data-directory a1a.libsvm --input-format LIBSVM \
      --task LOGISTIC_REGRESSION --regularization-type L2 \
      --regularization-weights 0.1,1,10 --output-directory /out
"""
from __future__ import annotations

import argparse
import enum
import json
import os
import sys

import numpy as np
import torch

from photon_tpu_torch.cli import game_base
from photon_tpu_torch.data.dataset import (
    DataSet,
    choose_sparse,
    to_device_batch,
    to_device_sparse_batch,
)
from photon_tpu_torch.data.libsvm import read_libsvm
from photon_tpu_torch.data.stats import BasicStatisticalSummary
from photon_tpu_torch.data.validators import DataValidationType, validate
from photon_tpu_torch.diagnostics import diagnose_models
from photon_tpu_torch.evaluation.evaluators import EvaluatorType, evaluate
from photon_tpu_torch.io.data_reader import AvroDataReader, FeatureShardConfig
from photon_tpu_torch.io.model_io import save_glm
from photon_tpu_torch.model_training import TrainedModel, train_glm_grid
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.ops.objective import matvec
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.problem import (
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import NormalizationType, OptimizerType, TaskType, resolve_device
from photon_tpu_torch.util import EventEmitter, PhotonLogger, Timed, prepare_output_dir

LEARNED_MODELS_TEXT = "learned-models-text"
BEST_MODEL_TEXT = "best-model-text"
MODELS_AVRO_DIR = "models"
BEST_MODEL_AVRO_DIR = "best-model"

_DEFAULT_METRIC = {
    TaskType.LOGISTIC_REGRESSION: EvaluatorType.AUC,
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM: EvaluatorType.AUC,
    TaskType.LINEAR_REGRESSION: EvaluatorType.RMSE,
    TaskType.POISSON_REGRESSION: EvaluatorType.POISSON_LOSS,
}

class DriverStage(enum.IntEnum):
    """Reference DriverStage.scala — strictly ordered pipeline stages."""

    INIT = 0
    PREPROCESSED = 1
    TRAINED = 2
    VALIDATED = 3
    DIAGNOSED = 4


class LegacyDriver:
    """Staged driver object; records completed stages like the reference's
    ``stageHistory``. ``events`` (an ``EventEmitter``, optional) hears
    the stage events of :meth:`run`."""

    def __init__(self, args, *, device="cuda", events=None):
        self.args = args
        self.device = resolve_device(device)
        self.events = events
        self.stage = DriverStage.INIT
        self.stage_history: list[DriverStage] = []
        self.train_data: DataSet | None = None
        self.validation_data: DataSet | None = None
        self.normalization = NormalizationContext.identity()
        self.models: list[TrainedModel] = []
        self.metrics: list[dict] = []  # one row per trained model, in order
        self.best_index: int | None = None
        self.num_features = 0
        self.index_maps: dict = {}
        self.diagnostics_report: dict | None = None

    def _assert_stage(self, expected: DriverStage) -> None:
        if self.stage != expected:
            raise RuntimeError(
                f"stage assertion failed: at {self.stage.name}, expected {expected.name}"
            )

    def _advance(self, to: DriverStage) -> None:
        self.stage_history.append(self.stage)
        self.stage = to

    def _read(self, path: str) -> DataSet:
        if self.args.input_format.upper() == "LIBSVM":
            return read_libsvm(path, add_intercept=self.args.add_intercept)
        shard = {
            "global": FeatureShardConfig(
                feature_bags=("features",), has_intercept=self.args.add_intercept
            )
        }
        reader = AvroDataReader(index_maps=self.index_maps or None)
        game = reader.read(path, shard)
        self.index_maps = reader.index_maps
        return game.shard_dataset("global")

    def preprocess(self) -> None:
        self._assert_stage(DriverStage.INIT)
        task = TaskType[self.args.task]
        mode = DataValidationType[self.args.data_validation]
        with Timed("load training data"):
            self.index_maps = {}
            self.train_data = self._read(self.args.training_data_directory)
        self.num_features = self.train_data.num_features
        validate(self.train_data, task, mode)
        if self.args.validating_data_directory:
            with Timed("load validation data"):
                self.validation_data = self._read(self.args.validating_data_directory)
            if self.validation_data.num_features != self.num_features:
                # LIBSVM dimension inference can differ between files; align
                # to the larger dimension (the reference shares one IndexMap)
                d = max(self.validation_data.num_features, self.num_features)
                self.train_data.num_features = d
                self.validation_data.num_features = d
                self.num_features = d
            validate(self.validation_data, task, mode)

        norm_type = NormalizationType[self.args.normalization_type]
        if norm_type != NormalizationType.NONE:
            with Timed("summarize features"):
                summary = BasicStatisticalSummary.of(self.train_data)
            self.normalization = NormalizationContext.build(
                norm_type,
                mean=summary.mean,
                variance=summary.variance,
                max_magnitude=np.maximum(np.abs(summary.max), np.abs(summary.min)),
                intercept_index=self.num_features - 1 if self.args.add_intercept else None,
            )
        self._advance(DriverStage.PREPROCESSED)

    def _constraint_bounds(self):
        """CLI constraint string → (lower, upper) arrays via the feature
        index map (reference GLMSuite.createConstraintFeatureMap)."""
        if not self.args.coefficient_box_constraints:
            return None, None
        from photon_tpu_torch.optimize.constraints import bounds_arrays, parse_constraint_string

        imap = self.index_maps.get("global")
        if imap is None:
            raise ValueError(
                "--coefficient-box-constraints requires name/term feature keys "
                "(AVRO input with an index map); LIBSVM features are positional"
            )
        cmap = parse_constraint_string(self.args.coefficient_box_constraints, dict(iter(imap)))
        lower, upper = bounds_arrays(cmap, self.num_features)
        # bounds are in original feature units; the projection runs in the
        # transformed space (w_orig = w' .* factor), so scale them; the
        # intercept absorbs every shift and cannot be boxed under one
        norm = self.normalization
        if lower is not None and norm.factors is not None:
            factors = norm.factors.detach().cpu().numpy().astype(np.float64)
            lower = lower / factors
            upper = upper / factors
        if (
            lower is not None
            and norm.shifts is not None
            and norm.intercept_index is not None
            and (
                np.isfinite(lower[norm.intercept_index])
                or np.isfinite(upper[norm.intercept_index])
            )
        ):
            raise ValueError(
                "cannot box-constrain the intercept under a shifting normalization "
                "(the intercept absorbs all feature shifts)"
            )
        return lower, upper

    def train(self) -> None:
        self._assert_stage(DriverStage.PREPROCESSED)
        a = self.args
        lower, upper = self._constraint_bounds()
        config = GLMProblemConfig(
            task=TaskType[a.task],
            optimizer=OptimizerType[a.optimizer],
            optimizer_config=OptimizerConfig(
                max_iterations=a.max_num_iterations,
                tolerance=a.tolerance,
                lower_bounds=lower,
                upper_bounds=upper,
            ),
            regularization=RegularizationContext(
                regularization_type=RegularizationType[a.regularization_type],
                elastic_net_alpha=a.elastic_net_alpha,
            ),
        )
        self.problem_config = config
        weights = [float(w) for w in a.regularization_weights.split(",")]
        with Timed("train GLM grid"):
            self.models = train_glm_grid(
                self.train_data, config, weights, normalization=self.normalization,
                device=self.device,
            )
        self._advance(DriverStage.TRAINED)

    def validate_models(self) -> None:
        self._assert_stage(DriverStage.TRAINED)
        task = TaskType[self.args.task]
        data = self.validation_data or self.train_data
        metric_types = [_DEFAULT_METRIC[task]]
        if task == TaskType.LOGISTIC_REGRESSION:
            metric_types.append(EvaluatorType.LOGISTIC_LOSS)
        # the layout the training path chose: a shard trained sparse is
        # scored sparse, never densified here
        dtype = self._model_dtype()
        to_device = (
            to_device_sparse_batch
            if choose_sparse(data.num_samples, data.num_features, len(data.values))
            else to_device_batch
        )
        batch = to_device(data, dtype=dtype, device=self.device)
        best_val, best_i = None, 0
        primary = metric_types[0]
        for i, tm in enumerate(self.models):
            margins = matvec(batch, tm.model.coefficients.means) + batch.offsets
            row = {
                m.name: float(evaluate(m, margins, batch.labels, batch.weights))
                for m in metric_types
            }
            self.metrics.append(dict(row, Lambda=tm.regularization_weight))
            v = row[primary.name]
            if (
                best_val is None
                or (primary.larger_is_better and v > best_val)
                or (not primary.larger_is_better and v < best_val)
            ):
                best_val, best_i = v, i
        self.best_index = best_i
        self._advance(DriverStage.VALIDATED)

    def _model_dtype(self) -> torch.dtype:
        """The trained models' type (float32 unless the fit ran wider):
        validation and diagnostics build their batches at it."""
        return self.models[0].model.coefficients.means.dtype if self.models else torch.float32

    def diagnose(self) -> None:
        """Model diagnostics of every trained model on the validation data
        (the training data without it), with the bootstrap and
        learning-curve retrains of the validation-selected model under the
        driver's own problem configuration and normalization."""
        self._assert_stage(DriverStage.VALIDATED)
        data = self.validation_data or self.train_data
        with Timed("diagnostics"):
            self.diagnostics_report = diagnose_models(
                self.models,
                data,
                TaskType[self.args.task],
                output_dir=os.path.join(self.args.output_directory, "diagnostics"),
                train_data=self.train_data,
                config=self.problem_config,
                normalization=self.normalization,
                best_index=self.best_index,
                index_to_name=self.index_maps.get("global"),
                dtype=self._model_dtype(),
                device=self.device,
            )
        self._advance(DriverStage.DIAGNOSED)

    def save(self) -> None:
        out = self.args.output_directory
        index_to_name = self.index_maps.get("global")
        task = TaskType[self.args.task]

        def coef_lines(tm: TrainedModel) -> str:
            means = tm.model.coefficients.means.detach().cpu().numpy()
            lines = [f"# lambda={tm.regularization_weight}"]
            for j in np.flatnonzero(np.abs(means) > 0):
                name = index_to_name.get_feature_name(int(j)) if index_to_name else str(int(j))
                lines.append(f"{name}\t{means[j]:.17g}")
            return "\n".join(lines) + "\n"

        os.makedirs(os.path.join(out, LEARNED_MODELS_TEXT), exist_ok=True)
        for tm in self.models:
            lam = tm.regularization_weight
            with open(os.path.join(out, LEARNED_MODELS_TEXT, f"lambda-{lam}.txt"), "w") as f:
                f.write(coef_lines(tm))
            if index_to_name is not None:
                save_glm(
                    os.path.join(out, MODELS_AVRO_DIR, f"lambda-{lam}.avro"),
                    tm.model, task, index_to_name, model_id=f"lambda-{lam}",
                )
        if self.best_index is not None:
            best = self.models[self.best_index]
            os.makedirs(os.path.join(out, BEST_MODEL_TEXT), exist_ok=True)
            with open(os.path.join(out, BEST_MODEL_TEXT, "best.txt"), "w") as f:
                f.write(coef_lines(best))
            if index_to_name is not None:
                save_glm(
                    os.path.join(out, BEST_MODEL_AVRO_DIR, "best.avro"),
                    best.model, task, index_to_name, model_id="best",
                )
        with open(os.path.join(out, "metrics.json"), "w") as f:
            json.dump(
                {
                    "metrics": self.metrics,
                    "bestIndex": self.best_index,
                    "stages": [s.name for s in self.stage_history] + [self.stage.name],
                },
                f,
                indent=2,
            )

    def run(self) -> None:
        emitter = self.events if self.events is not None else EventEmitter()
        out = self.args.output_directory
        with game_base.run_profile(out), PhotonLogger(
            os.path.join(out, "driver.log"), level=self.args.log_level
        ) as log:
            emitter.emit("photon_setup")
            self.preprocess()
            emitter.emit("training_start")
            self.train()
            emitter.emit("training_finish")
            self.validate_models()
            if self.args.diagnose:
                self.diagnose()
            self.save()
            log.info(
                "stages completed: %s",
                [s.name for s in self.stage_history] + [self.stage.name],
            )
            game_base.export_run_profile(out, log, meta={"driver": "legacy_driver"})


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="photon-driver", description=__doc__)
    p.add_argument("--training-data-directory", required=True)
    p.add_argument("--validating-data-directory", default=None)
    p.add_argument("--output-directory", required=True)
    p.add_argument("--override-output-directory", action="store_true")
    p.add_argument("--input-format", default="AVRO", choices=["AVRO", "LIBSVM"])
    p.add_argument("--task", required=True, choices=[t.name for t in TaskType])
    p.add_argument("--optimizer", default="LBFGS", choices=[o.name for o in OptimizerType])
    p.add_argument("--max-num-iterations", type=int, default=100)
    p.add_argument("--tolerance", type=float, default=1e-7)
    p.add_argument(
        "--regularization-type", default="NONE", choices=[r.name for r in RegularizationType]
    )
    p.add_argument("--regularization-weights", default="0")
    p.add_argument("--elastic-net-alpha", type=float, default=None)
    p.add_argument(
        "--normalization-type", default="NONE", choices=[t.name for t in NormalizationType]
    )
    p.add_argument("--add-intercept", action=argparse.BooleanOptionalAction, default=True)
    p.add_argument(
        "--data-validation", default="VALIDATE_FULL", choices=[t.name for t in DataValidationType]
    )
    p.add_argument(
        "--coefficient-box-constraints",
        default=None,
        help="JSON array of maps with keys name/term/lowerBound/upperBound "
        "('*' wildcards as in the reference); bounds are enforced by "
        "projection after every optimizer step "
        "(reference PhotonOptionNames.scala:42, GLMSuite.scala:190-290)",
    )
    p.add_argument(
        "--diagnose",
        action="store_true",
        help="write model diagnostics (metrics, calibration, error independence, "
        "feature importance, learning curves and bootstrap intervals) to "
        "<output>/diagnostics/report.{html,txt,json}",
    )
    p.add_argument("--log-level", default="info")
    return p


def run(argv=None, *, device="cuda", events=None) -> LegacyDriver:
    """``events``: an ``EventEmitter`` whose listeners hear
    ``photon_setup``, ``training_start`` and ``training_finish``."""
    args = build_parser().parse_args(argv)
    device = resolve_device(device)
    prepare_output_dir(args.output_directory, override=args.override_output_directory)
    driver = LegacyDriver(args, device=device, events=events)
    driver.run()
    return driver


def main() -> None:
    run(sys.argv[1:])


if __name__ == "__main__":
    main()
