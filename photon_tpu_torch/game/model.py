"""GAME model containers: fixed effect, random effect, matrix
factorization, combined.

Counterpart of photon_tpu/game/model.py. Models are host numpy: they
leave the device at the end of a fit and go back to it in the scorer
(``GameScorer``); ``score``/``score_cold`` here are the host reference
paths (float64 numpy) the device scorers are held to.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Mapping, NamedTuple

import numpy as np
import torch

from photon_tpu_torch.game.data import GameData, RandomEffectDataset, entity_row_indices
from photon_tpu_torch.models.coefficients import Coefficients as GLMCoefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_tpu_torch.types import TaskType


def _build_vocab_index(vocab: np.ndarray) -> dict:
    return {k: i for i, k in enumerate(vocab)}


class Coefficients(NamedTuple):
    """Host coefficient means and optional variances."""

    means: np.ndarray
    variances: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class FixedEffectModel:
    """One GLM over every sample's shard features (original space)."""

    coefficients: Coefficients
    feature_shard: str
    task: TaskType

    def score(self, data: GameData) -> np.ndarray:
        """x·w per sample, offsets excluded."""
        shard = data.feature_shards[self.feature_shard]
        w = np.asarray(self.coefficients.means, dtype=np.float64)
        contrib = shard.values * w[shard.indices]
        rows = np.repeat(np.arange(shard.num_rows), np.diff(shard.indptr))
        scores = np.zeros(shard.num_rows)
        np.add.at(scores, rows, contrib)
        return scores


@dataclasses.dataclass(frozen=True)
class BucketCoefficients:
    """Coefficients of one RE bucket: [E, d_max] in the projected space."""

    entity_ids: np.ndarray
    col_index: np.ndarray
    coefficients: np.ndarray
    variances: np.ndarray | None = None


@dataclasses.dataclass(frozen=True)
class RandomEffectModel:
    """Per-entity GLMs in their projected spaces: the compacted columns
    ``col_index`` of the shard, or ``projection_matrix``'s k columns."""

    random_effect_type: str
    feature_shard: str
    task: TaskType
    vocab: np.ndarray
    buckets: tuple[BucketCoefficients, ...]
    num_features: int
    projection_matrix: np.ndarray | None = None

    @functools.cached_property
    def entity_row_index(self) -> dict:
        return _build_vocab_index(self.vocab)

    def score(self, data: GameData, dataset: RandomEffectDataset) -> np.ndarray:
        """Scores aligned to sample position, via the dataset's flat score
        arrays (the dataset this model was trained on)."""
        scores = np.zeros(data.num_samples)
        for bucket, coefs in zip(dataset.buckets, self.buckets):
            c = np.asarray(coefs.coefficients)[bucket.score_slot]
            s = np.einsum("md,md->m", bucket.score_feats, c)
            np.add.at(scores, bucket.score_pos, s)
        return scores

    @functools.cached_property
    def _coefficient_csr(self):
        """[entities + 1 (zero row), d] sparse coefficients; d is the
        projected width under a random projection, else the shard width."""
        from scipy import sparse

        d = (
            self.projection_matrix.shape[1]
            if self.projection_matrix is not None
            else self.num_features
        )
        rows, cols, vals = [], [], []
        for b in self.buckets:
            for i, e in enumerate(b.entity_ids):
                w = b.coefficients[i]
                if self.projection_matrix is not None:
                    nz = np.flatnonzero(w)
                    rows.extend([e] * len(nz))
                    cols.extend(nz.tolist())
                    vals.extend(w[nz].tolist())
                else:
                    cidx = b.col_index[i]
                    valid = (cidx >= 0) & (w != 0)
                    rows.extend([e] * int(valid.sum()))
                    cols.extend(cidx[valid].tolist())
                    vals.extend(w[valid].tolist())
        return sparse.csr_matrix((vals, (rows, cols)), shape=(len(self.vocab) + 1, d))

    def score_cold(self, data: GameData) -> np.ndarray:
        """Score any data by entity lookup; unseen entities score 0."""
        from scipy import sparse

        shard = data.feature_shards[self.feature_shard]
        coef = self._coefficient_csr
        entity_per_row = entity_row_indices(
            self.entity_row_index, data.id_tags[self.random_effect_type], len(self.vocab)
        )
        x = sparse.csr_matrix(
            (shard.values, shard.indices, shard.indptr),
            shape=(shard.num_rows, shard.num_cols),
        )
        if self.projection_matrix is not None:
            x_eff = np.asarray(x @ self.projection_matrix)
            per_row = np.asarray(coef[entity_per_row].todense())
            return np.einsum("nd,nd->n", x_eff, per_row)
        return np.asarray(x.multiply(coef[entity_per_row]).sum(axis=1)).ravel()

    def modeled_keys(self) -> set:
        """Entity keys that have a trained model in some bucket."""
        return {self.vocab[e] for b in self.buckets for e in b.entity_ids}

    def dense_coefficient_lookup(self) -> list:
        """entity index → shard-space coefficient vector (the projected
        vector under a random projection); None where unmodeled."""
        out: list = [None] * len(self.vocab)
        for b in self.buckets:
            for i, e in enumerate(b.entity_ids):
                if self.projection_matrix is not None:
                    out[e] = b.coefficients[i]
                else:
                    w = np.zeros(self.num_features)
                    cols = b.col_index[i]
                    valid = cols >= 0
                    w[cols[valid]] = b.coefficients[i][valid]
                    out[e] = w
        return out

    def entity_model(self, key: str) -> GeneralizedLinearModel | None:
        """One entity's GLM (float64, on the host), or None."""
        idx = np.flatnonzero(self.vocab == key)
        if len(idx) == 0:
            return None
        w = self.dense_coefficient_lookup()[int(idx[0])]
        if w is None:
            return None
        return model_for_task(
            self.task, GLMCoefficients(means=torch.as_tensor(np.asarray(w, np.float64)))
        )


def merge_random_effect_carryover(
    new: RandomEffectModel, prior: RandomEffectModel
) -> RandomEffectModel:
    """Prior per-entity models whose entities got no new training data
    carry over unchanged: entities modeled in ``new`` win, the others are
    appended as one extra bucket (vocab extended as needed)."""
    if new.num_features != prior.num_features:
        raise ValueError(
            "cannot carry over prior random-effect models: feature dimension "
            f"changed ({prior.num_features} -> {new.num_features})"
        )
    pm_new, pm_prior = new.projection_matrix, prior.projection_matrix
    if (pm_new is None) != (pm_prior is None) or (
        pm_new is not None and not np.array_equal(pm_new, pm_prior)
    ):
        raise ValueError(
            "cannot carry over prior random-effect models across a different "
            "random-projection matrix"
        )
    new_modeled = np.asarray(sorted(new.modeled_keys()))
    carry_keys, carry_cols, carry_coefs, carry_vars = [], [], [], []
    any_var = False
    for b in prior.buckets:
        keys_b = np.asarray(prior.vocab)[b.entity_ids]
        mask = ~np.isin(keys_b, new_modeled)
        if not mask.any():
            continue
        carry_keys.append(keys_b[mask])
        carry_cols.append(np.asarray(b.col_index)[mask])
        carry_coefs.append(np.asarray(b.coefficients)[mask])
        carry_vars.append(None if b.variances is None else np.asarray(b.variances)[mask])
        any_var = any_var or b.variances is not None
    if not carry_keys:
        return new

    all_keys = np.concatenate(carry_keys)
    missing = np.setdiff1d(all_keys, np.asarray(new.vocab))
    vocab = (
        np.concatenate([np.asarray(new.vocab), missing])
        if len(missing)
        else np.asarray(new.vocab)
    )
    sorter = np.argsort(vocab)
    entity_ids = sorter[np.searchsorted(vocab, all_keys, sorter=sorter)]

    d_max = max(c.shape[1] for c in carry_cols)
    e_n = len(all_keys)
    col_index = np.full((e_n, d_max), -1, dtype=np.int64)
    coefficients = np.zeros((e_n, d_max))
    variances = np.zeros((e_n, d_max)) if any_var else None
    row = 0
    for i, cols in enumerate(carry_cols):
        r, d = cols.shape
        col_index[row : row + r, :d] = cols
        coefficients[row : row + r, :d] = carry_coefs[i]
        if variances is not None and carry_vars[i] is not None:
            variances[row : row + r, :d] = carry_vars[i]
        row += r
    carry_bucket = BucketCoefficients(
        entity_ids=entity_ids.astype(np.int64),
        col_index=col_index,
        coefficients=coefficients,
        variances=variances,
    )
    return dataclasses.replace(new, vocab=vocab, buckets=tuple(new.buckets) + (carry_bucket,))


@dataclasses.dataclass(frozen=True)
class MatrixFactorizationModel:
    """Latent factor tables of a row × col entity interaction: a sample
    scores ⟨u_row, v_col⟩, and 0 where either entity is unseen."""

    row_entity_type: str
    col_entity_type: str
    row_vocab: np.ndarray
    col_vocab: np.ndarray
    row_factors: np.ndarray  # [R, k]
    col_factors: np.ndarray  # [C, k]

    @property
    def num_factors(self) -> int:
        return self.row_factors.shape[1]

    @functools.cached_property
    def row_index(self) -> dict:
        return _build_vocab_index(self.row_vocab)

    @functools.cached_property
    def col_index(self) -> dict:
        return _build_vocab_index(self.col_vocab)

    def score_cold(self, data: GameData) -> np.ndarray:
        u = np.concatenate([self.row_factors, np.zeros((1, self.num_factors))])
        v = np.concatenate([self.col_factors, np.zeros((1, self.num_factors))])
        ri = entity_row_indices(
            self.row_index, data.id_tags[self.row_entity_type], len(self.row_index)
        )
        ci = entity_row_indices(
            self.col_index, data.id_tags[self.col_entity_type], len(self.col_index)
        )
        return np.einsum("nk,nk->n", u[ri], v[ci])


@dataclasses.dataclass(frozen=True)
class GameModel:
    """coordinate id → model, scored additively."""

    coordinates: Mapping[str, FixedEffectModel | RandomEffectModel | MatrixFactorizationModel]
    task: TaskType

    def score(
        self,
        data: GameData,
        datasets: Mapping[str, RandomEffectDataset] | None = None,
    ) -> np.ndarray:
        """Sum of coordinate scores (margins, before offsets and link)."""
        total = np.zeros(data.num_samples)
        for cid, model in self.coordinates.items():
            if isinstance(model, FixedEffectModel):
                total += model.score(data)
            elif datasets is not None and cid in datasets:
                total += model.score(data, datasets[cid])
            else:
                total += model.score_cold(data)
        return total

    def predict(self, data: GameData, **kw) -> np.ndarray:
        """Mean response: the task's link of score + offset."""
        margins = torch.as_tensor(self.score(data, **kw) + data.offsets)
        glm = model_for_task(self.task, GLMCoefficients(means=torch.zeros(1, dtype=torch.float64)))
        return glm.compute_mean(margins).numpy()

    def required_id_tags(self) -> set[str]:
        """Entity id-tag columns the model needs from scoring data."""
        tags: set[str] = set()
        for cm in self.coordinates.values():
            if isinstance(cm, RandomEffectModel):
                tags.add(cm.random_effect_type)
            elif isinstance(cm, MatrixFactorizationModel):
                tags.add(cm.row_entity_type)
                tags.add(cm.col_entity_type)
        return tags

    def __getitem__(self, cid: str):
        return self.coordinates[cid]
