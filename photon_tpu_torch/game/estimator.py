"""GameEstimator: train a GAME model by block coordinate descent.

Counterpart of a minimal photon_tpu/game/estimator.GameEstimator.fit: one
model per λ-grid point with warm starts across the grid, the pooled RE
bucket shapes (``ShapePool``). No normalization contexts, locked
coordinates, streaming, mesh, precompile or checkpoints yet. ``device``
defaults to "cuda" and raises without a card unless "cpu" is asked for.
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
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_tpu_torch.game.data import (
    GameData,
    ShapePool,
    build_random_effect_dataset,
    profile_random_effect_shapes,
    re_shape_budget,
)
from photon_tpu_torch.game.descent import run_coordinate_descent
from photon_tpu_torch.game.model import GameModel
from photon_tpu_torch.types import TaskType, resolve_device

logger = logging.getLogger(__name__)


@dataclasses.dataclass
class GameTrainingResult:
    model: GameModel
    regularization_weights: dict
    tracker: list
    wall_time_s: float
    #: Σ coordinate margins after the last sweep, [N] on the host
    scores: np.ndarray


@dataclasses.dataclass
class GameEstimator:
    task: TaskType
    coordinate_configs: Mapping[str, object]
    update_sequence: Sequence[str]
    descent_iterations: int = 1
    dtype: torch.dtype = torch.float32
    seed: int = 0
    device: str | torch.device = "cuda"

    def __post_init__(self):
        self.device = resolve_device(self.device)
        missing = [c for c in self.update_sequence if c not in self.coordinate_configs]
        if missing:
            raise ValueError(f"update sequence names unknown coordinates: {missing}")
        #: host seconds of the last fit's phases (build, per grid point)
        self.last_fit_stats: dict | None = None

    def _build_shape_pool(self, data: GameData) -> ShapePool | None:
        budgets, profiles = [], []
        for cfg in self.coordinate_configs.values():
            if not isinstance(cfg, RandomEffectCoordinateConfig):
                continue
            b = re_shape_budget(cfg.shape_budget)
            prof = profile_random_effect_shapes(data, cfg) if b is not None else None
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

    def _build_coordinates(self, data: GameData, shape_pool=None):
        if shape_pool is None:
            shape_pool = self._build_shape_pool(data)
        coords = {}
        for cid, cfg in self.coordinate_configs.items():
            if isinstance(cfg, FixedEffectCoordinateConfig):
                coords[cid] = FixedEffectCoordinate.build(
                    data, cfg, dtype=self.dtype, device=self.device
                )
            elif isinstance(cfg, RandomEffectCoordinateConfig):
                ds = build_random_effect_dataset(
                    data, cfg, seed=self.seed, shape_pool=shape_pool
                )
                coords[cid] = RandomEffectCoordinate.build(
                    ds, cfg, dtype=self.dtype, device=self.device
                )
                logger.info(
                    "coordinate %s: %d entities in %d buckets (padding waste %.1f%%)",
                    cid, ds.num_entities, len(ds.buckets), 100.0 * ds.padding_waste(),
                )
            else:
                raise TypeError(f"unknown coordinate config for {cid}")
        return coords

    def _grid_length(self) -> int:
        return max(len(c.regularization_weights) for c in self.coordinate_configs.values())

    def fit(self, data: GameData, *, shape_pool=None) -> list[GameTrainingResult]:
        """One GameModel per λ-grid point, warm-starting across the grid."""
        t0 = time.perf_counter()
        coordinates = self._build_coordinates(data, shape_pool)
        build_s = time.perf_counter() - t0
        results, states = [], None
        for gi in range(self._grid_length()):
            t_grid = time.perf_counter()
            reg_weights = {}
            for cid, coord in coordinates.items():
                ws = self.coordinate_configs[cid].regularization_weights
                reg_weights[cid] = ws[min(gi, len(ws) - 1)]
                if gi > 0:
                    coord.with_regularization_weight(reg_weights[cid])
            cd = run_coordinate_descent(
                coordinates,
                self.update_sequence,
                self.descent_iterations,
                initial_states=states,
            )
            model = self._to_model(coordinates, cd.states)
            results.append(
                GameTrainingResult(
                    model=model,
                    regularization_weights=reg_weights,
                    tracker=cd.tracker,
                    wall_time_s=time.perf_counter() - t_grid,
                    scores=cd.total.detach().cpu().numpy(),
                )
            )
            states = cd.states
        self.last_fit_stats = {
            "build_s": build_s,
            "wall_s": time.perf_counter() - t0,
        }
        return results

    def _to_model(self, coordinates, states) -> GameModel:
        ordered = list(self.update_sequence) + [
            cid for cid in coordinates if cid not in self.update_sequence
        ]
        return GameModel(
            coordinates={
                cid: coordinates[cid].to_model(states[cid])
                for cid in ordered
                if cid in states
            },
            task=self.task,
        )
