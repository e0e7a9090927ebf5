"""GAME coordinates: device-resident training and scoring units.

Counterpart of photon_tpu/game/coordinate.py, single device, no mesh.

- ``FixedEffectCoordinate`` keeps the shard on the device as a dense
  block or a padded-ELL batch (with the column-window layout on the card);
  training is one solve on the residual offsets in the normalization's
  transformed space, scoring one matvec plus the margin shift.
- ``RandomEffectCoordinate`` keeps size-bucketed entity blocks; training
  is one lane-batched L-BFGS per bucket, scoring a gather, a row dot and
  a write to each kept sample's (unique) position.
- ``MatrixFactorizationCoordinate`` keeps the two factor tables [R, k] and
  [C, k]; training is one joint L-BFGS over both, its gradient from
  autograd through the per-sample row gathers.

``sweep_step`` is the coordinate-descent step: residual = total − own
score, train on it, rescore, fold the new score back into the total.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.data.dataset import choose_sparse
from photon_tpu_torch.game.config import (
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    MatrixFactorizationCoordinateConfig,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.game.data import (
    PAD_ENTITY_KEY,
    GameData,
    RandomEffectDataset,
    entity_row_indices,
)
from photon_tpu_torch.game.model import (
    BucketCoefficients,
    Coefficients,
    FixedEffectModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.ops.losses import POSITIVE_RESPONSE_THRESHOLD, loss_for_task
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.ops.objective import matvec
from photon_tpu_torch.ops.sparse_windows import maybe_build_windows
from photon_tpu_torch.optimize.lbfgs import minimize_lbfgs
from photon_tpu_torch.optimize.problem import GLMProblem, GLMProblemConfig
from photon_tpu_torch.types import LabeledBatch, SparseBatch, numpy_dtype

Tensor = torch.Tensor


def _use_sparse(representation: FeatureRepresentation, shard, dtype, bf16=False) -> bool:
    if representation == FeatureRepresentation.SPARSE:
        return True
    if representation == FeatureRepresentation.DENSE:
        return False
    itemsize = 2 if bf16 else torch.empty((), dtype=dtype).element_size()
    return choose_sparse(shard.num_rows, shard.num_cols, len(shard.values), itemsize)


def _to_host(t: Tensor) -> np.ndarray:
    """A host copy that owns its memory (never a view of a live state)."""
    return t.detach().to("cpu", torch.float64).numpy().copy()


def down_sampled_weights(data: GameData, rate: float, classification: bool, seed: int):
    """The fixed effect's down-sampling mask: one uniform draw per row from
    ``default_rng(seed)``; classification zeroes the dropped negatives and
    reweights the kept ones by 1/rate, other tasks zero the dropped rows."""
    weights = np.asarray(data.weights, dtype=np.float64).copy()
    if not 0.0 < rate < 1.0:
        return weights
    keep_draw = np.random.default_rng(seed).uniform(size=data.num_samples) < rate
    if classification:
        neg = data.labels <= POSITIVE_RESPONSE_THRESHOLD
        weights[neg & ~keep_draw] = 0.0
        weights[neg & keep_draw] /= rate
    else:
        weights[~keep_draw] = 0.0
    return weights


def fold_residual(offsets: Tensor, sample_pos: Tensor, res_pad: Tensor) -> Tensor:
    """offsets + the residual gathered by sample position; ``res_pad`` is
    the [N] residual with a zero sentinel appended at index N, which
    padding positions (≥ N) read. The same elementwise ops on the card and
    on the host, so a host fold equals a device fold bit for bit."""
    n = res_pad.shape[0] - 1
    return offsets + res_pad[torch.clamp(sample_pos, max=n)]


def solve_lanes(problem_config: GLMProblemConfig, features: Tensor, labels: Tensor,
                offsets: Tensor, weights: Tensor, w0: Tensor):
    """One lane-batched solve of independent per-entity problems:
    features [B, rows, d], the row vectors [B, rows], w0 [B, d]. A
    materialized bucket (B = E) and a streaming chunk of its entity lanes
    (B = ec) both solve through this function."""
    batch = LabeledBatch(features=features, labels=labels, offsets=offsets, weights=weights)
    return GLMProblem.build(problem_config).solve(batch, w0)


def score_rows(feats: Tensor, coef_rows: Tensor) -> Tensor:
    """Per-row dot of score rows [M, d] with their entity's coefficient
    rows [M, d]; every output row depends on its own input row only."""
    return (feats * coef_rows).sum(-1)


class Coordinate:
    def sweep_step(self, total: Tensor, score: Tensor, state):
        """→ (new_state, new_score, new_total, info)"""
        residual = total - score
        new_state, info = self.train(residual, state)
        new_score = self.score(new_state)
        return new_state, new_score, residual + new_score, info

    def place_state(self, state):
        """A state loaded on the host (checkpoint resume, warm start)
        where this coordinate keeps its state: on the fit's device."""
        if isinstance(state, Tensor):
            return state.to(self.device)
        return type(state)(self.place_state(s) for s in state)


@dataclasses.dataclass(eq=False)
class FixedEffectCoordinate(Coordinate):
    config: FixedEffectCoordinateConfig
    batch: LabeledBatch | SparseBatch
    normalization: NormalizationContext
    problem: GLMProblem
    dtype: torch.dtype
    device: torch.device
    num_features: int

    @property
    def feature_shard(self) -> str:
        return self.config.feature_shard

    @staticmethod
    def build(
        data: GameData,
        config: FixedEffectCoordinateConfig,
        normalization: NormalizationContext = NormalizationContext(),
        *,
        dtype: torch.dtype,
        device: torch.device,
        seed: int = 0,
    ) -> "FixedEffectCoordinate":
        shard = data.feature_shards[config.feature_shard]
        opt = config.optimization
        weights = down_sampled_weights(
            data, opt.down_sampling_rate, opt.task.is_classification, seed
        )

        def col(a):
            return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dtype)

        feat_dtype = torch.bfloat16 if config.bf16_features else dtype
        if _use_sparse(config.representation, shard, dtype, config.bf16_features):
            ell_idx, ell_val = shard.to_ell(dtype=numpy_dtype(dtype))
            values = torch.as_tensor(ell_val).to(device=device, dtype=feat_dtype)
            if config.bf16_features:
                # the window layout holds the same (rounded) values
                ell_val = values.to("cpu", dtype).numpy()
            batch = SparseBatch(
                indices=torch.as_tensor(ell_idx).to(device=device, dtype=torch.int64),
                values=values,
                labels=col(data.labels),
                offsets=col(data.offsets),
                weights=col(weights),
                windows=maybe_build_windows(
                    ell_idx, ell_val, shard.num_cols,
                    device=device, dtype=dtype, force=config.column_windows,
                ),
            )
        else:
            batch = LabeledBatch(
                features=torch.as_tensor(shard.to_dense(dtype=numpy_dtype(dtype))).to(
                    device=device, dtype=feat_dtype
                ),
                labels=col(data.labels),
                offsets=col(data.offsets),
                weights=col(weights),
            )
        normalization = normalization.to(device=device, dtype=dtype)
        problem = GLMProblem.build(
            opt.with_regularization_weight(config.regularization_weights[0]), normalization
        )
        return FixedEffectCoordinate(
            config=config, batch=batch, normalization=normalization,
            problem=problem, dtype=dtype, device=device,
            num_features=shard.num_cols,
        )

    def with_regularization_weight(self, w: float) -> "FixedEffectCoordinate":
        self.problem = GLMProblem.build(
            self.config.optimization.with_regularization_weight(w), self.normalization
        )
        return self

    def initial_state(self) -> Tensor:
        return torch.zeros(self.num_features, dtype=self.dtype, device=self.device)

    def train(self, residual_scores: Tensor, state: Tensor):
        res = self.problem.solve(self.batch, state, extra_offsets=residual_scores)
        return res.x, res

    def score(self, state: Tensor) -> Tensor:
        """x·(w .* factor) + margin shift, offsets excluded."""
        return self.score_batch(self.batch, state)

    def score_batch(self, batch, state: Tensor) -> Tensor:
        """The score of the rows of ``batch`` (the resident batch, or a
        streamed chunk of it)."""
        s = matvec(batch, self.normalization.effective_coefficients(state))
        if self.normalization.shifts is not None:
            s = s + self.normalization.margin_shift(state)
        return s

    def to_model(self, state: Tensor) -> FixedEffectModel:
        """Original-space means; variances of the transformed-space solve."""
        variances = self.problem.variances(self.batch, state)
        return FixedEffectModel(
            coefficients=Coefficients(
                means=_to_host(self.normalization.model_to_original_space(state)),
                variances=None if variances is None else _to_host(variances),
            ),
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
        return solve_lanes(
            self.problem_config, db.features, db.labels,
            fold_residual(db.offsets, db.sample_pos, res_pad), db.weights, w0,
        )

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
            out[db.score_pos] = score_rows(db.score_feats, coefs[db.score_slot])
        return out

    def to_model(self, state: list[Tensor]) -> RandomEffectModel:
        """Per-bucket coefficients and, when configured, the variances of
        each entity's problem on its active rows and data offsets."""
        problem = GLMProblem.build(self.problem_config)
        buckets = []
        for db, coefs, hb in zip(self.device_buckets, state, self.dataset.buckets):
            variances = problem.variances(
                LabeledBatch(db.features, db.labels, db.offsets, db.weights), coefs
            )
            buckets.append(
                BucketCoefficients(
                    entity_ids=hb.entity_ids,
                    col_index=hb.col_index,
                    coefficients=_to_host(coefs),
                    variances=None if variances is None else _to_host(variances),
                )
            )
        return RandomEffectModel(
            random_effect_type=self.config.random_effect_type,
            feature_shard=self.config.feature_shard,
            task=self.problem_config.task,
            vocab=self.dataset.vocab,
            buckets=tuple(buckets),
            num_features=self.dataset.num_features,
            projection_matrix=self.dataset.projection_matrix,
        )


@dataclasses.dataclass(eq=False)
class MatrixFactorizationCoordinate(Coordinate):
    """score = ⟨u_row, v_col⟩ on rows of positive weight. State is the pair
    (U [R, k], V [C, k]); a training step is one L-BFGS over x = [U; V]
    flattened, with the value Σ w·loss(offset + residual + ⟨u, v⟩) +
    λ/2·‖x‖² and its gradient by autograd (the row gathers' backward is an
    index_add, so on the card two runs may differ in the last bits)."""

    config: MatrixFactorizationCoordinateConfig
    row_vocab: np.ndarray
    col_vocab: np.ndarray
    row_idx: Tensor  # [N] int64
    col_idx: Tensor  # [N] int64
    labels: Tensor
    offsets: Tensor
    weights: Tensor
    l2_weight: float
    dtype: torch.dtype
    device: torch.device
    seed: int

    @staticmethod
    def build(
        data: GameData,
        config: MatrixFactorizationCoordinateConfig,
        *,
        dtype: torch.dtype,
        device: torch.device,
        seed: int = 0,
    ) -> "MatrixFactorizationCoordinate":
        r_keys = np.asarray(data.id_tags[config.row_entity_type])
        c_keys = np.asarray(data.id_tags[config.col_entity_type])
        row_vocab = np.unique(r_keys[r_keys != PAD_ENTITY_KEY])
        col_vocab = np.unique(c_keys[c_keys != PAD_ENTITY_KEY])
        # padding rows point at factor row 0 and carry weight 0
        row_idx = entity_row_indices({k: i for i, k in enumerate(row_vocab)}, r_keys, 0)
        col_idx = entity_row_indices({k: i for i, k in enumerate(col_vocab)}, c_keys, 0)

        def f(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=device, dtype=dtype)

        return MatrixFactorizationCoordinate(
            config=config,
            row_vocab=row_vocab,
            col_vocab=col_vocab,
            row_idx=torch.as_tensor(row_idx).to(device),
            col_idx=torch.as_tensor(col_idx).to(device),
            labels=f(data.labels),
            offsets=f(data.offsets),
            weights=f(data.weights),
            l2_weight=float(config.regularization_weights[0]),
            dtype=dtype,
            device=device,
            seed=seed,
        )

    def with_regularization_weight(self, w: float) -> "MatrixFactorizationCoordinate":
        self.l2_weight = float(w)
        return self

    def initial_state(self) -> tuple[Tensor, Tensor]:
        k = self.config.num_factors
        rng = np.random.default_rng(self.seed)
        scale = self.config.init_scale / np.sqrt(k)
        u = rng.normal(scale=scale, size=(len(self.row_vocab), k))
        v = rng.normal(scale=scale, size=(len(self.col_vocab), k))

        def t(a):
            return torch.as_tensor(a).to(device=self.device, dtype=self.dtype)

        return t(u), t(v)

    def value_and_grad_fn(self, residual_scores: Tensor, shapes):
        """x ↦ (f(x), ∇f(x)) of the joint factor problem on the residual."""
        loss = loss_for_task(self.config.optimization.task)
        offsets = self.offsets + residual_scores
        (r, k), (c, _) = shapes
        l2 = self.l2_weight

        def value_and_grad(x: Tensor):
            with torch.enable_grad():
                x = x.detach().requires_grad_(True)
                u = x[: r * k].reshape(r, k)
                v = x[r * k :].reshape(c, k)
                margin = offsets + (u[self.row_idx] * v[self.col_idx]).sum(-1)
                value = (self.weights * loss.loss(margin, self.labels)).sum() + (
                    0.5 * l2 * (x * x).sum()
                )
                (grad,) = torch.autograd.grad(value, x)
            return value.detach(), grad

        return value_and_grad

    def train(self, residual_scores: Tensor, state):
        u0, v0 = state
        vg = self.value_and_grad_fn(residual_scores, (tuple(u0.shape), tuple(v0.shape)))
        res = minimize_lbfgs(
            vg, torch.cat([u0.reshape(-1), v0.reshape(-1)]),
            self.config.optimization.optimizer_config,
        )
        n_u = u0.numel()
        return (res.x[:n_u].reshape(u0.shape), res.x[n_u:].reshape(v0.shape)), res

    def score(self, state) -> Tensor:
        u, v = state
        s = (u[self.row_idx] * v[self.col_idx]).sum(-1)
        return torch.where(self.weights > 0, s, torch.zeros_like(s))

    def to_model(self, state) -> MatrixFactorizationModel:
        return MatrixFactorizationModel(
            row_entity_type=self.config.row_entity_type,
            col_entity_type=self.config.col_entity_type,
            row_vocab=self.row_vocab,
            col_vocab=self.col_vocab,
            row_factors=_to_host(state[0]),
            col_factors=_to_host(state[1]),
        )


def build_coordinate(
    data: GameData,
    config,
    *,
    normalization: NormalizationContext = NormalizationContext(),
    re_dataset: RandomEffectDataset | None = None,
    dtype: torch.dtype,
    device: torch.device,
    seed: int = 0,
) -> Coordinate:
    """Config → coordinate."""
    if isinstance(config, FixedEffectCoordinateConfig):
        return FixedEffectCoordinate.build(
            data, config, normalization, dtype=dtype, device=device, seed=seed
        )
    if isinstance(config, RandomEffectCoordinateConfig):
        if re_dataset is None:
            raise ValueError("random-effect coordinate needs a built dataset")
        return RandomEffectCoordinate.build(re_dataset, config, dtype=dtype, device=device)
    if isinstance(config, MatrixFactorizationCoordinateConfig):
        return MatrixFactorizationCoordinate.build(
            data, config, dtype=dtype, device=device, seed=seed
        )
    raise TypeError(f"unknown coordinate config {type(config)}")
