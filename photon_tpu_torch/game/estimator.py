"""GameEstimator: train a GAME model by block coordinate descent.

Counterpart of photon_tpu/game/estimator.GameEstimator.fit on one device:
one model per λ-grid point with warm starts across the grid, the pooled
RE bucket shapes (``ShapePool``), normalization contexts per feature
shard, locked coordinates, an initial model (warm start, with
``ignore_threshold_for_new_models`` and the carry-over of prior entities
that got no new data), per-sweep validation with the best sweep's model
returned, and fixed-effect, random-effect and matrix-factorization
coordinates, the lifecycle events of JAX's ``events=`` bus, the
divergence policies of the health check, mid-descent checkpoints with
resume, supervised restarts and model snapshots for warm starts, and
out-of-core streaming (``fit(stream=...)``, game/streaming.py). No mesh
or precompile; its telemetry is the descent's, the recovery loop's and
the stream's counters (JAX's ``fit.*`` spans are not carried).
``device`` defaults to "cuda" and raises without a card unless "cpu" is
asked for.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_tpu_torch.game.config import (
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.checkpoint import DescentCheckpointer, ModelCheckpointStore
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    MatrixFactorizationCoordinate,
    RandomEffectCoordinate,
    build_coordinate,
)
from photon_tpu_torch.game.data import (
    GameData,
    ShapePool,
    build_random_effect_dataset,
    profile_random_effect_shapes,
    re_bucket_entity_cap,
    re_shape_budget,
)
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.game.model import (
    GameModel,
    RandomEffectModel,
    merge_random_effect_carryover,
)
from photon_tpu_torch.game.recovery import max_restarts_from_env, run_with_recovery
from photon_tpu_torch.game.streaming import (
    RESIDENCY_SLACK_BYTES,
    StreamConfig,
    StreamingFixedEffectCoordinate,
    StreamingRandomEffectCoordinate,
    StreamTelemetry,
    validate_streaming,
)
from photon_tpu_torch.game.validation import DeviceValidationScorer
from photon_tpu_torch.obs import memory as obs_memory
from photon_tpu_torch.obs.health import resolve_policy
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.types import TaskType, resolve_device

logger = logging.getLogger(__name__)


def _carry_over_prior_models(model: GameModel, initial: GameModel) -> GameModel:
    """Prior per-entity models with no new data survive a warm start."""
    merged = dict(model.coordinates)
    for cid, new_cm in model.coordinates.items():
        prior_cm = initial.coordinates.get(cid)
        if isinstance(new_cm, RandomEffectModel) and isinstance(prior_cm, RandomEffectModel):
            merged[cid] = merge_random_effect_carryover(new_cm, prior_cm)
    return dataclasses.replace(model, coordinates=merged)


@dataclasses.dataclass
class GameTrainingResult:
    model: GameModel
    #: the best sweep's validation metric (None without validation)
    evaluation: float | None
    regularization_weights: dict
    tracker: list
    wall_time_s: float
    #: Σ coordinate margins of the returned model's states, [N] on the host
    scores: np.ndarray


@dataclasses.dataclass
class GameEstimator:
    """``normalization_contexts``: feature shard → NormalizationContext for
    the fixed effects on it; ``locked_coordinates`` are scored, never
    trained (their states come from the initial model);
    ``ignore_threshold_for_new_models`` lets entities without a prior
    model bypass ``active_data_lower_bound`` (needs an initial model);
    ``validation_evaluator`` (EvaluatorType or GroupedEvaluatorSpec)
    scores ``validation_data`` after every sweep and picks the model.
    ``events`` (a ``util.events.EventEmitter``) receives ``setup``,
    ``sweep_complete``, ``training_finish`` and ``training_failure`` with
    the JAX package's payloads; the dispatch and compile fields, which
    the port does not count, are None.

    ``on_divergence`` is what a non-finite sweep does (obs/health.py):
    ``"raise"`` (the default), ``"warn"`` or ``"halt_coordinate"``; None
    reads ``PHOTON_ON_DIVERGENCE``. ``max_restarts`` > 0 restarts a fit
    that failed with a transient or divergent error, from its newest
    checkpoint when ``fit`` has a ``checkpoint_dir``
    (game/recovery.py); ``PHOTON_MAX_RESTARTS`` wins over it."""

    task: TaskType
    coordinate_configs: Mapping[str, object]
    update_sequence: Sequence[str]
    descent_iterations: int = 1
    normalization_contexts: Mapping[str, NormalizationContext] | None = None
    locked_coordinates: frozenset = frozenset()
    ignore_threshold_for_new_models: bool = False
    validation_evaluator: object | None = None
    dtype: torch.dtype = torch.float32
    seed: int = 0
    device: str | torch.device = "cuda"
    events: object | None = None
    on_divergence: str | None = None
    max_restarts: int | None = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self.on_divergence = resolve_policy(self.on_divergence)
        self.max_restarts = max_restarts_from_env(self.max_restarts)
        missing = [c for c in self.update_sequence if c not in self.coordinate_configs]
        if missing:
            raise ValueError(f"update sequence names unknown coordinates: {missing}")
        if self.locked_coordinates and not set(self.locked_coordinates) <= set(
            self.coordinate_configs
        ):
            raise ValueError("locked coordinates must be configured")
        #: host seconds of the last fit's phases (build, validation build,
        #: grid), the checkpoint it resumed from and the errors it restarted on
        self.last_fit_stats: dict | None = None

    def _existing_model_keys(self, cid, initial_model):
        if not self.ignore_threshold_for_new_models or initial_model is None:
            return None
        prior = initial_model.coordinates.get(cid)
        return prior.modeled_keys() if isinstance(prior, RandomEffectModel) else set()

    def _build_shape_pool(self, data: GameData, initial_model=None) -> ShapePool | None:
        budgets, profiles = [], []
        for cid, cfg in self.coordinate_configs.items():
            if not isinstance(cfg, RandomEffectCoordinateConfig):
                continue
            b = re_shape_budget(cfg.shape_budget)
            if b is None:
                continue
            prof = profile_random_effect_shapes(
                data, cfg, existing_model_keys=self._existing_model_keys(cid, initial_model)
            )
            if prof is None:
                continue
            budgets.append(b)
            profiles.append(prof)
        if not profiles:
            return None
        pool = ShapePool(budget=min(budgets))
        for d_pad, n_trn in profiles:
            pool.observe(d_pad, n_trn)
        return pool.freeze()

    def _build_coordinates(self, data: GameData, initial_model=None, shape_pool=None,
                           stream_cfg: StreamConfig | None = None):
        if shape_pool is None:
            shape_pool = self._build_shape_pool(data, initial_model)
        norm = self.normalization_contexts or {}
        coords = {}
        telemetry = StreamTelemetry() if stream_cfg is not None else None
        for cid, cfg in self.coordinate_configs.items():
            ds = None
            if isinstance(cfg, RandomEffectCoordinateConfig):
                ds = build_random_effect_dataset(
                    data, cfg, seed=self.seed,
                    existing_model_keys=self._existing_model_keys(cid, initial_model),
                    shape_pool=shape_pool,
                )
                logger.info(
                    "coordinate %s: %d entities in %d buckets (padding waste %.1f%%)",
                    cid, ds.num_entities, len(ds.buckets),
                    100.0 * ds.padding_waste()["total_waste"],
                )
            fe_norm = (
                norm.get(cfg.feature_shard, NormalizationContext())
                if isinstance(cfg, FixedEffectCoordinateConfig)
                else NormalizationContext()
            )
            if stream_cfg is not None:
                kw = dict(dtype=self.dtype, device=self.device, stream=stream_cfg,
                          telemetry=telemetry)
                coords[cid] = (
                    StreamingFixedEffectCoordinate.build_streaming(data, cfg, fe_norm, **kw)
                    if isinstance(cfg, FixedEffectCoordinateConfig)
                    else StreamingRandomEffectCoordinate.build_streaming(ds, cfg, **kw)
                )
                continue
            coords[cid] = build_coordinate(
                data, cfg, normalization=fe_norm, re_dataset=ds,
                dtype=self.dtype, device=self.device, seed=self.seed,
            )
        return coords

    def _grid_length(self) -> int:
        return max(len(c.regularization_weights) for c in self.coordinate_configs.values())

    def fit(
        self,
        data: GameData,
        *,
        validation_data: GameData | None = None,
        initial_model: GameModel | None = None,
        grid_callback=None,
        shape_pool=None,
        checkpoint_dir: str | None = None,
        warm_start: str | None = None,
        model_checkpoint_dir: str | None = None,
        stream=None,
    ) -> list[GameTrainingResult]:
        """One GameModel per λ-grid point, warm-starting across the grid.
        ``grid_callback(grid_index, result)`` fires as each point ends.

        ``checkpoint_dir`` saves the states after every sweep
        (game/checkpoint.py), and a rerun with the same arguments resumes
        from the last saved sweep with the same models bit for bit; grid points finished before the interruption
        come back as None (their models went out through
        ``grid_callback``). ``warm_start`` names a model snapshot
        directory whose newest valid snapshot is the initial model (an
        empty one cold-starts with a warning); it excludes
        ``initial_model``. ``model_checkpoint_dir`` saves the last grid
        point's model there as the next snapshot after the fit.

        ``stream`` (a StreamConfig, or an int chunk size) trains out of
        core: the data stays on
        the host and every sweep streams fixed-shape chunks through the
        two-deep pipeline of game/streaming.py, with the same
        coefficients, bounded device residency (an armed residency
        guard) and no one-time cost after sweep 0.
        ``last_fit_stats["stream"]`` then holds the pipeline's report."""
        stream_cfg = None
        if stream is not None:
            stream_cfg = StreamConfig.resolve(stream)
            validate_streaming(
                self.coordinate_configs, self.locked_coordinates,
                device_validation=validation_data is not None
                and self.validation_evaluator is not None,
            )
        if warm_start is not None:
            if initial_model is not None:
                raise ValueError(
                    "pass either warm_start (a model checkpoint directory) or "
                    "initial_model, not both"
                )
            loaded = ModelCheckpointStore(warm_start).load_latest()
            if loaded is None:
                logger.warning(
                    "warm_start directory %s holds no model snapshot; cold-starting",
                    warm_start,
                )
            else:
                initial_model, warm_seq = loaded
                logger.info("warm-starting from model snapshot seq %d in %s", warm_seq, warm_start)
        emitter = self.events
        if emitter is not None:
            emitter.emit(
                "setup",
                coordinates=list(self.coordinate_configs),
                update_sequence=list(self.update_sequence),
                grid_length=self._grid_length(),
                descent_iterations=self.descent_iterations,
                num_samples=int(data.num_samples),
            )

        def attempt():
            return self._fit(
                data, validation_data=validation_data, initial_model=initial_model,
                grid_callback=grid_callback, shape_pool=shape_pool,
                checkpoint_dir=checkpoint_dir, stream_cfg=stream_cfg,
            )

        restarts = []
        try:
            if self.max_restarts:
                if checkpoint_dir is None:
                    logger.warning(
                        "max_restarts=%d without checkpoint_dir: a restart retrains "
                        "from scratch instead of resuming mid-descent", self.max_restarts,
                    )
                results = run_with_recovery(
                    attempt, max_restarts=self.max_restarts,
                    on_restart=lambda i, e: restarts.append(f"{type(e).__name__}: {e}"),
                )
            else:
                results = attempt()
        except Exception as e:
            # a failed fit leaves no earlier fit's numbers behind
            self.last_fit_stats = None
            if emitter is not None:
                emitter.emit("training_failure", error=f"{type(e).__name__}: {e}")
            raise
        self.last_fit_stats["restarts"] = restarts
        if model_checkpoint_dir is not None:
            final = [r for r in results if r is not None]
            if final:
                seq = ModelCheckpointStore(model_checkpoint_dir).save(final[-1].model)
                logger.info("saved model snapshot seq %d to %s", seq, model_checkpoint_dir)
        if emitter is not None:
            evals = [r.evaluation for r in results if r is not None and r.evaluation is not None]
            ev = self.validation_evaluator
            pick = max if ev is None or ev.larger_is_better else min
            emitter.emit(
                "training_finish",
                n_grid_points=len(results),
                best_evaluation=pick(evals) if evals else None,
                wall_time_s=round(self.last_fit_stats["wall_s"], 4),
                dispatches=None,
            )
        return results

    def _fingerprint(self, data: GameData) -> str:
        """What a checkpoint's states depend on: resuming under anything
        else is a hard error, not silent reuse (the JAX fingerprint less
        its mesh term)."""
        return repr((
            self.task,
            sorted((cid, repr(cfg)) for cid, cfg in self.coordinate_configs.items()),
            tuple(self.update_sequence),
            self.descent_iterations,
            sorted(self.locked_coordinates),
            self.seed,
            data.num_samples,
            # layout knobs: they change the per-bucket state shapes
            re_bucket_entity_cap(),
            sorted(
                (cid, re_shape_budget(cfg.shape_budget))
                for cid, cfg in self.coordinate_configs.items()
                if isinstance(cfg, RandomEffectCoordinateConfig)
            ),
        ))

    def _fit(self, data, *, validation_data, initial_model, grid_callback, shape_pool,
             checkpoint_dir=None, stream_cfg=None):
        if self.ignore_threshold_for_new_models and initial_model is None:
            raise ValueError("ignore_threshold_for_new_models requires an initial model")
        t0 = time.perf_counter()
        coordinates = self._build_coordinates(data, initial_model, shape_pool, stream_cfg)
        telemetry = (
            self._arm_stream_guard(coordinates, stream_cfg) if stream_cfg is not None else None
        )
        states = (
            self._place_states(self._states_from_model(initial_model, coordinates), coordinates)
            if initial_model is not None
            else None
        )
        build_s = time.perf_counter() - t0
        validation_fn = None
        t_val = time.perf_counter()
        if validation_data is not None and self.validation_evaluator is not None:
            validation_fn = DeviceValidationScorer.build(
                validation_data, coordinates, self.validation_evaluator
            ).evaluate
        validation_build_s = time.perf_counter() - t_val
        larger = (
            self.validation_evaluator.larger_is_better if self.validation_evaluator else True
        )
        checkpointer = ckpt = fingerprint = None
        if checkpoint_dir is not None:
            fingerprint = self._fingerprint(data)
            checkpointer = DescentCheckpointer(checkpoint_dir)
            ckpt = checkpointer.load(expect_fingerprint=fingerprint)
            if ckpt is not None:
                ckpt.states = self._place_states(ckpt.states, coordinates)
                if ckpt.best_states is not None:
                    ckpt.best_states = self._place_states(ckpt.best_states, coordinates)
                logger.info(
                    "resuming from checkpoint: grid %d, sweep %d", ckpt.grid_index, ckpt.iteration
                )
        results, grid_s = [], []
        for gi in range(self._grid_length()):
            if ckpt is not None and gi < ckpt.grid_index:
                # finished before the interruption; the checkpoint's states
                # carry the warm start forward
                results.append(None)
                if gi == ckpt.grid_index - 1:
                    states = ckpt.states
                continue
            t_grid = time.perf_counter()
            reg_weights = {}
            for cid, coord in coordinates.items():
                ws = self.coordinate_configs[cid].regularization_weights
                reg_weights[cid] = ws[min(gi, len(ws) - 1)]
                if gi > 0:
                    coord.with_regularization_weight(reg_weights[cid])
            start_iteration, initial_best = 0, None
            if ckpt is not None and gi == ckpt.grid_index and ckpt.iteration >= 0:
                states = ckpt.states
                start_iteration = ckpt.iteration + 1
                if ckpt.best_states is not None:
                    initial_best = (ckpt.best_states, ckpt.best_metric)
            sweep_callback = None
            if checkpointer is not None:
                sweep_callback = lambda it, st, bs, bm, _gi=gi: checkpointer.on_sweep(  # noqa: E731
                    _gi, it, st, bs, bm, fingerprint=fingerprint
                )
            cd = run_coordinate_descent(
                coordinates,
                self.update_sequence,
                self.descent_iterations,
                initial_states=states,
                locked_coordinates=self.locked_coordinates,
                validation_fn=validation_fn,
                larger_is_better=larger,
                start_iteration=start_iteration,
                initial_best=initial_best,
                sweep_callback=sweep_callback,
                sweep_hook=self._sweep_hook(gi),
                on_divergence=self.on_divergence,
            )
            final, total = cd.states, cd.total
            if cd.best_states is not None:
                final = cd.best_states
                total = sum(coordinates[cid].score(s) for cid, s in final.items())
            model = self._to_model(coordinates, final)
            if initial_model is not None:
                model = _carry_over_prior_models(model, initial_model)
            result = GameTrainingResult(
                model=model,
                evaluation=cd.best_metric,
                regularization_weights=reg_weights,
                tracker=cd.tracker,
                wall_time_s=time.perf_counter() - t_grid,
                scores=total.detach().to("cpu", torch.float64).numpy(),
            )
            results.append(result)
            grid_s.append(result.wall_time_s)
            if grid_callback is not None:
                grid_callback(gi, result)
            states = cd.states  # warm start the next grid point
            if checkpointer is not None:
                checkpointer.mark_grid_done(gi, states, fingerprint)
        self.last_fit_stats = {
            "build_s": build_s,
            "validation_build_s": validation_build_s,
            "grid_s": grid_s,
            "wall_s": time.perf_counter() - t0,
            # (grid, last completed sweep) of the checkpoint this fit resumed
            "resumed_from": None if ckpt is None else (ckpt.grid_index, ckpt.iteration),
        }
        if telemetry is not None:
            self.last_fit_stats["stream"] = {
                **telemetry.report(),
                # per bucket: solved in one chunk (the bit-parity class)
                "single_chunk_buckets": {
                    cid: c.single_chunk_buckets() for cid, c in coordinates.items()
                    if isinstance(c, StreamingRandomEffectCoordinate)
                },
            }
        return results

    @staticmethod
    def _place_states(states: dict, coordinates) -> dict:
        """Every state loaded on the host (warm start, checkpoint) where
        its coordinate keeps it (``Coordinate.place_state``)."""
        return {cid: coordinates[cid].place_state(st) for cid, st in states.items()}

    @staticmethod
    def _arm_stream_guard(coordinates, stream_cfg: StreamConfig) -> StreamTelemetry:
        """The streaming fit's shared telemetry, with its residency guard
        armed unless ``assert_residency`` is off: limit = 2 × the largest
        chunk's bytes + 3·D·itemsize per fixed effect (its state and the
        normalization's vectors stay on the card for a score stream) +
        slack, over the allocator's bytes now. On the card a product on
        the compute stream first brings the BLAS library's workspace into
        that baseline, as any earlier fit in the process would have."""
        streaming = list(coordinates.values())
        telemetry = streaming[0].telemetry
        if not stream_cfg.assert_residency:
            return telemetry
        chunk_bytes = max(c.max_chunk_device_bytes() for c in streaming)
        table_bytes = sum(
            c.table_device_bytes() for c in streaming
            if isinstance(c, StreamingFixedEffectCoordinate)
        )
        device = streaming[0].device
        if device.type == "cuda":
            x = torch.ones((2, 2), device=device)
            torch.mm(x, x)
            torch.cuda.synchronize(device)
            del x
        limit = 2 * chunk_bytes + table_bytes + RESIDENCY_SLACK_BYTES
        telemetry.guard = obs_memory.ResidencyGuard(limit)
        logger.info(
            "streaming residency guard armed: limit %d B (2 x %d chunk + %d tables + %d "
            "slack) over a %d B baseline", limit, chunk_bytes, table_bytes,
            RESIDENCY_SLACK_BYTES, telemetry.guard.baseline_bytes,
        )
        return telemetry

    def _sweep_hook(self, grid_index: int):
        if self.events is None:
            return None
        return lambda it, row: self.events.emit(
            "sweep_complete",
            grid_index=grid_index,
            iteration=it,
            sweep_seconds=row["sweep_seconds"],
            dispatches=None,
            compiles=None,
            health=row["health"],
        )

    def _to_model(self, coordinates, states) -> GameModel:
        # every coordinate with a state ships, locked ones outside the
        # update sequence included (they shaped every residual)
        ordered = list(self.update_sequence) + [
            cid for cid in coordinates if cid not in self.update_sequence
        ]
        return GameModel(
            coordinates={
                cid: coordinates[cid].to_model(states[cid]) for cid in ordered if cid in states
            },
            task=self.task,
        )

    def _states_from_model(self, model: GameModel, coordinates) -> dict:
        """Warm-start / partial-retrain states from a prior GameModel, on
        the host (a fixed effect's where its normalization lives); the
        caller places them (``_place_states``)."""
        states = {}
        for cid, coord in coordinates.items():
            if cid not in model.coordinates:
                continue
            prior = model.coordinates[cid]
            if isinstance(coord, FixedEffectCoordinate):
                w = torch.as_tensor(np.array(prior.coefficients.means, dtype=np.float64)).to(
                    device=self.device, dtype=self.dtype
                )
                states[cid] = coord.normalization.model_to_transformed_space(w)
            elif isinstance(coord, RandomEffectCoordinate):
                lookup = prior.dense_coefficient_lookup()
                prior_idx = {k: i for i, k in enumerate(prior.vocab)}
                bucket_states = []
                for hb in coord.dataset.buckets:
                    # float32 host block, as the reference builds it
                    w0 = np.zeros((hb.features.shape[0], hb.features.shape[2]), np.float32)
                    for i, ent in enumerate(hb.entity_ids):
                        pi = prior_idx.get(coord.dataset.vocab[ent])
                        vec = lookup[pi] if pi is not None else None
                        if vec is None:
                            continue
                        cols = hb.col_index[i]
                        valid = cols >= 0
                        w0[i][valid] = vec[cols[valid]]
                    bucket_states.append(torch.as_tensor(w0).to(dtype=self.dtype))
                states[cid] = bucket_states
            elif isinstance(coord, MatrixFactorizationCoordinate):
                u0, v0 = (t.cpu().numpy().copy() for t in coord.initial_state())
                r_prior = {k: i for i, k in enumerate(prior.row_vocab)}
                c_prior = {k: i for i, k in enumerate(prior.col_vocab)}
                k_common = min(u0.shape[1], prior.row_factors.shape[1])
                for i, key in enumerate(coord.row_vocab):
                    pi = r_prior.get(key)
                    if pi is not None:
                        u0[i, :k_common] = prior.row_factors[pi, :k_common]
                for i, key in enumerate(coord.col_vocab):
                    pi = c_prior.get(key)
                    if pi is not None:
                        v0[i, :k_common] = prior.col_factors[pi, :k_common]
                states[cid] = tuple(torch.as_tensor(a).to(dtype=self.dtype) for a in (u0, v0))
        return states
