"""GAME coordinates: device-resident training and scoring units.

Counterpart of photon_tpu/game/coordinate.py, single device, no mesh.

- ``FixedEffectCoordinate`` keeps the shard on the device as a dense
  block or a padded-ELL batch (with the column-window layout on the card);
  training is one L-BFGS solve on the residual offsets, scoring one matvec.
- ``RandomEffectCoordinate`` keeps size-bucketed entity blocks; training
  is one lane-batched L-BFGS per bucket, scoring a gather, a row dot and
  a write to each kept sample's (unique) position.

``sweep_step`` is the coordinate-descent step: residual = total − own
score, train on it, rescore, fold the new score back into the total.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.game.config import (
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import GameData, RandomEffectDataset, choose_sparse
from photon_tpu_torch.game.model import (
    BucketCoefficients,
    Coefficients,
    FixedEffectModel,
    RandomEffectModel,
)
from photon_tpu_torch.ops.objective import matvec
from photon_tpu_torch.ops.sparse_windows import maybe_build_windows
from photon_tpu_torch.optimize.problem import GLMProblem, GLMProblemConfig
from photon_tpu_torch.types import LabeledBatch, SparseBatch

Tensor = torch.Tensor


def numpy_dtype(dtype: torch.dtype):
    return torch.empty((), dtype=dtype).numpy().dtype


def _use_sparse(representation: FeatureRepresentation, shard, dtype) -> bool:
    if representation == FeatureRepresentation.SPARSE:
        return True
    if representation == FeatureRepresentation.DENSE:
        return False
    itemsize = torch.empty((), dtype=dtype).element_size()
    return choose_sparse(shard.num_rows, shard.num_cols, len(shard.values), itemsize)


class Coordinate:
    def sweep_step(self, total: Tensor, score: Tensor, state):
        """→ (new_state, new_score, new_total, info)"""
        residual = total - score
        new_state, info = self.train(residual, state)
        new_score = self.score(new_state)
        return new_state, new_score, residual + new_score, info


@dataclasses.dataclass(eq=False)
class FixedEffectCoordinate(Coordinate):
    config: FixedEffectCoordinateConfig
    batch: LabeledBatch | SparseBatch
    problem: GLMProblem
    dtype: torch.dtype
    device: torch.device
    num_features: int

    @staticmethod
    def build(
        data: GameData,
        config: FixedEffectCoordinateConfig,
        *,
        dtype: torch.dtype,
        device: torch.device,
    ) -> "FixedEffectCoordinate":
        shard = data.feature_shards[config.feature_shard]

        def col(a):
            return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

        if _use_sparse(config.representation, shard, dtype):
            ell_idx, ell_val = shard.to_ell(dtype=numpy_dtype(dtype))
            batch = SparseBatch(
                indices=torch.as_tensor(ell_idx).to(device=device, dtype=torch.int64),
                values=torch.as_tensor(ell_val).to(device=device),
                labels=col(data.labels),
                offsets=col(data.offsets),
                weights=col(data.weights),
                windows=maybe_build_windows(
                    ell_idx, ell_val, shard.num_cols,
                    device=device, dtype=dtype, force=config.column_windows,
                ),
            )
        else:
            batch = LabeledBatch(
                features=col(shard.to_dense(dtype=numpy_dtype(dtype))),
                labels=col(data.labels),
                offsets=col(data.offsets),
                weights=col(data.weights),
            )
        problem = GLMProblem.build(
            config.optimization.with_regularization_weight(
                config.regularization_weights[0]
            )
        )
        return FixedEffectCoordinate(
            config=config, batch=batch,
            problem=problem, dtype=dtype, device=device,
            num_features=shard.num_cols,
        )

    def with_regularization_weight(self, w: float) -> "FixedEffectCoordinate":
        self.problem = GLMProblem.build(
            self.config.optimization.with_regularization_weight(w)
        )
        return self

    def initial_state(self) -> Tensor:
        return torch.zeros(self.num_features, dtype=self.dtype, device=self.device)

    def train(self, residual_scores: Tensor, state: Tensor):
        res = self.problem.solve(self.batch, state, extra_offsets=residual_scores)
        return res.x, res

    def score(self, state: Tensor) -> Tensor:
        """x·w, offsets excluded."""
        return matvec(self.batch, state)

    def to_model(self, state: Tensor) -> FixedEffectModel:
        return FixedEffectModel(
            coefficients=Coefficients(means=state.detach().cpu().numpy().copy()),
            feature_shard=self.config.feature_shard,
            task=self.config.optimization.task,
        )


@dataclasses.dataclass(eq=False)
class _DeviceBucket:
    features: Tensor  # [E, n_act, d] ACTIVE rows only
    labels: Tensor
    offsets: Tensor
    weights: Tensor  # 0 on padding rows
    sample_pos: Tensor  # [E, n_act] int64, num_samples ⇒ padding
    score_feats: Tensor  # [M, d] every kept row, padding-free
    score_slot: Tensor  # [M] entity slot in this bucket
    score_pos: Tensor  # [M] global sample position (unique)


@dataclasses.dataclass(eq=False)
class RandomEffectCoordinate(Coordinate):
    config: RandomEffectCoordinateConfig
    dataset: RandomEffectDataset
    device_buckets: list
    problem_config: GLMProblemConfig
    num_samples: int
    dtype: torch.dtype
    device: torch.device

    @staticmethod
    def build(
        dataset: RandomEffectDataset,
        config: RandomEffectCoordinateConfig,
        *,
        dtype: torch.dtype,
        device: torch.device,
    ) -> "RandomEffectCoordinate":
        def f(a):
            return torch.as_tensor(a).to(device=device, dtype=dtype)

        def i(a):
            return torch.as_tensor(a).to(device=device, dtype=torch.int64)

        device_buckets = [
            _DeviceBucket(
                features=f(b.features), labels=f(b.labels), offsets=f(b.offsets),
                weights=f(b.weights), sample_pos=i(b.sample_pos),
                score_feats=f(b.score_feats), score_slot=i(b.score_slot),
                score_pos=i(b.score_pos),
            )
            for b in dataset.buckets
        ]
        return RandomEffectCoordinate(
            config=config,
            dataset=dataset,
            device_buckets=device_buckets,
            problem_config=config.optimization.with_regularization_weight(
                config.regularization_weights[0]
            ),
            num_samples=dataset.num_samples,
            dtype=dtype,
            device=device,
        )

    def with_regularization_weight(self, w: float) -> "RandomEffectCoordinate":
        self.problem_config = self.config.optimization.with_regularization_weight(w)
        return self

    def initial_state(self) -> list[Tensor]:
        return [
            torch.zeros(
                (b.features.shape[0], b.features.shape[2]),
                dtype=self.dtype, device=self.device,
            )
            for b in self.device_buckets
        ]

    def _solve_bucket(self, db: _DeviceBucket, w0: Tensor, res_pad: Tensor):
        """One lane-batched solve over every entity of one size bucket; the
        residual is gathered by sample position (padding reads the zero
        sentinel at index num_samples)."""
        extra = res_pad[torch.clamp(db.sample_pos, max=self.num_samples)]
        batch = LabeledBatch(
            features=db.features, labels=db.labels,
            offsets=db.offsets + extra, weights=db.weights,
        )
        return GLMProblem.build(self.problem_config).solve(batch, w0)

    def train(self, residual_scores: Tensor, state: list[Tensor]):
        res_pad = torch.cat([residual_scores, residual_scores.new_zeros(1)])
        infos = [
            self._solve_bucket(db, w0, res_pad)
            for db, w0 in zip(self.device_buckets, state)
        ]
        return [r.x for r in infos], infos

    def score(self, state: list[Tensor]) -> Tensor:
        """Flat scoring: each kept sample's compacted row dotted with its
        entity's coefficients, written to its position. Every kept sample
        appears once per coordinate, so the writes never collide."""
        out = torch.zeros(self.num_samples, dtype=self.dtype, device=self.device)
        for db, coefs in zip(self.device_buckets, state):
            s = (db.score_feats * coefs[db.score_slot]).sum(-1)
            out[db.score_pos] = s
        return out

    def to_model(self, state: list[Tensor]) -> RandomEffectModel:
        buckets = tuple(
            BucketCoefficients(
                entity_ids=hb.entity_ids,
                col_index=hb.col_index,
                coefficients=coefs.detach().cpu().numpy().copy(),
            )
            for hb, coefs in zip(self.dataset.buckets, state)
        )
        return RandomEffectModel(
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard,
            task=self.problem_config.task,
            vocab=self.dataset.vocab,
            buckets=buckets,
            num_features=self.dataset.num_features,
        )
