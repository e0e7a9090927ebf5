"""Per-sweep validation scoring from the live coordinate states.

Counterpart of photon_tpu/game/validation.py. The validation structure is
built once per fit (feature blocks in each coordinate's projected space,
entity → (bucket, slot) maps, all on the device); each sweep then scores
the validation rows by gathers and row dots over the CURRENT states, with
no model built and nothing read back but the metric.

The numbers are those of the model path: fixed effects score through the
training coordinate's own ``score`` on the validation batch, random
effects as ``RandomEffectModel.score_cold`` (columns outside an entity's
compacted space and unseen entities add 0), MF as
``MatrixFactorizationModel.score_cold``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.evaluation.evaluators import evaluate
from photon_tpu_torch.evaluation.multi import GroupedEvaluatorSpec, run_grouped
from photon_tpu_torch.game.coordinate import (
    FixedEffectCoordinate,
    MatrixFactorizationCoordinate,
    RandomEffectCoordinate,
    _use_sparse,
)
from photon_tpu_torch.game.data import GameData, entity_row_indices
from photon_tpu_torch.parallel.mesh import LOCAL
from photon_tpu_torch.types import LabeledBatch, SparseBatch, numpy_dtype

Tensor = torch.Tensor


@dataclasses.dataclass(eq=False)
class _FixedEffectValScorer:
    #: the training coordinate re-pointed at the validation batch
    coordinate: FixedEffectCoordinate

    def __call__(self, state: Tensor) -> Tensor:
        return self.coordinate.score(state)


@dataclasses.dataclass(eq=False)
class _REBucketValBlock:
    rows: Tensor  # [m] validation row indices
    slots: Tensor  # [m] entity slot within the bucket state
    x_proj: Tensor  # [m, d_bucket] features in the entity's projected space


@dataclasses.dataclass(eq=False)
class _RandomEffectValScorer:
    blocks: list  # per bucket: _REBucketValBlock | None
    num_rows: int
    dtype: torch.dtype
    device: torch.device

    def __call__(self, state: list[Tensor]) -> Tensor:
        out = torch.zeros(self.num_rows, dtype=self.dtype, device=self.device)
        for blk, coefs in zip(self.blocks, state):
            if blk is None:
                continue
            # every validation row sits in one bucket block at most
            out[blk.rows] = (blk.x_proj * coefs[blk.slots].to(self.dtype)).sum(-1)
        return out


@dataclasses.dataclass(eq=False)
class _MFValScorer:
    row_idx: Tensor  # [n] into u (num_rows ⇒ unseen, the zero row)
    col_idx: Tensor  # [n] into v

    def __call__(self, state) -> Tensor:
        u, v = state
        u_pad = torch.cat([u, u.new_zeros((1, u.shape[1]))])
        v_pad = torch.cat([v, v.new_zeros((1, v.shape[1]))])
        return (u_pad[self.row_idx] * v_pad[self.col_idx]).sum(-1)


def _concat_aranges(lengths: np.ndarray) -> np.ndarray:
    total = int(lengths.sum())
    starts = np.concatenate(([0], np.cumsum(lengths)[:-1]))
    return np.arange(total) - np.repeat(starts, lengths)


def _build_re_scorer(coord: RandomEffectCoordinate, data: GameData) -> _RandomEffectValScorer:
    ds = coord.dataset
    dtype, dev = coord.dtype, coord.device
    n = data.num_samples
    keys = np.asarray(data.id_tags[ds.random_effect_type])
    shard = data.feature_shards[ds.feature_shard]
    oov = len(ds.vocab)
    ent_of_row = entity_row_indices(ds.entity_index, keys, oov)
    bucket_of = np.full(oov + 1, -1, dtype=np.int64)
    slot_of = np.zeros(oov + 1, dtype=np.int64)
    for bi, b in enumerate(ds.buckets):
        bucket_of[b.entity_ids] = bi
        slot_of[b.entity_ids] = np.arange(len(b.entity_ids))
    row_bucket = bucket_of[ent_of_row]

    nnz_row = np.repeat(np.arange(n), np.diff(shard.indptr))
    nnz_col = shard.indices.astype(np.int64)
    nnz_val = shard.values
    host_dtype = numpy_dtype(dtype)
    blocks: list = []
    for bi, b in enumerate(ds.buckets):
        in_b = np.flatnonzero(row_bucket == bi)
        if len(in_b) == 0:
            blocks.append(None)
            continue
        m = len(in_b)
        local_row = np.full(n, -1, dtype=np.int64)
        local_row[in_b] = np.arange(m)
        sel = local_row[nnz_row] >= 0
        r_sel = local_row[nnz_row[sel]]
        c_sel = nnz_col[sel]
        v_sel = nnz_val[sel]
        x_proj = np.zeros((m, b.col_index.shape[1]), dtype=host_dtype)
        if ds.projection_matrix is not None:
            k = ds.projection_matrix.shape[1]
            np.add.at(
                x_proj[:, :k], r_sel,
                (v_sel[:, None] * ds.projection_matrix[c_sel]).astype(host_dtype),
            )
        else:
            # global column → the entity's local column by one searchsorted
            # over sorted (slot, column) keys
            slot_sel = slot_of[ent_of_row[in_b][r_sel]]
            cols_b = b.col_index.astype(np.int64)
            d_e = (cols_b >= 0).sum(axis=1)
            big = np.int64(ds.num_features) + 1
            flat_keys = np.repeat(np.arange(cols_b.shape[0]), d_e) * big + cols_b[cols_b >= 0]
            flat_local = _concat_aranges(d_e)
            probe = slot_sel * big + c_sel
            if len(flat_keys):
                pos = np.minimum(np.searchsorted(flat_keys, probe), len(flat_keys) - 1)
                match = flat_keys[pos] == probe
                x_proj[r_sel[match], flat_local[pos[match]]] = v_sel[match].astype(host_dtype)
        blocks.append(
            _REBucketValBlock(
                rows=torch.as_tensor(in_b).to(dev),
                slots=torch.as_tensor(slot_of[ent_of_row[in_b]]).to(dev),
                x_proj=torch.as_tensor(x_proj).to(dev),
            )
        )
    return _RandomEffectValScorer(blocks=blocks, num_rows=n, dtype=dtype, device=dev)


@dataclasses.dataclass(eq=False)
class DeviceValidationScorer:
    """Built once per fit; ``evaluate(states)`` runs on the device per
    sweep. ``evaluator`` is an EvaluatorType or a GroupedEvaluatorSpec
    (e.g. ``AUC:userId``), whose group codes are factorized at build."""

    scorers: dict
    labels: Tensor
    weights: Tensor
    offsets: Tensor
    evaluator: object
    group_codes: Tensor | None = None
    num_groups: int = 0
    group_rows: Tensor | None = None  # positive-weight row indices

    @staticmethod
    def build(
        validation_data: GameData, coordinates: dict, evaluator
    ) -> "DeviceValidationScorer":
        scorers: dict = {}
        dtype = dev = None
        for cid, coord in coordinates.items():
            dtype, dev = coord.dtype, coord.device
            if isinstance(coord, FixedEffectCoordinate):
                shard = validation_data.feature_shards[coord.feature_shard]
                nv = validation_data.num_samples
                zeros = torch.zeros(nv, dtype=dtype, device=dev)
                ones = torch.ones(nv, dtype=dtype, device=dev)
                np_dtype = numpy_dtype(dtype)
                if _use_sparse(
                    coord.config.representation, shard, dtype, coord.config.bf16_features
                ):
                    idx, val = shard.to_ell(dtype=np_dtype)
                    batch = SparseBatch(
                        indices=torch.as_tensor(idx).to(device=dev),
                        values=torch.as_tensor(val).to(dev),
                        labels=zeros, offsets=zeros, weights=ones,
                    )
                else:
                    batch = LabeledBatch(
                        features=torch.as_tensor(shard.to_dense(np_dtype)).to(dev),
                        labels=zeros, offsets=zeros, weights=ones,
                    )
                # the whole validation batch on every rank of a mesh
                scorers[cid] = _FixedEffectValScorer(
                    dataclasses.replace(coord, batch=batch, mesh=LOCAL)
                )
            elif isinstance(coord, RandomEffectCoordinate):
                scorers[cid] = _build_re_scorer(coord, validation_data)
            elif isinstance(coord, MatrixFactorizationCoordinate):
                ri = entity_row_indices(
                    {k: i for i, k in enumerate(coord.row_vocab)},
                    validation_data.id_tags[coord.config.row_entity_type],
                    len(coord.row_vocab),
                )
                ci = entity_row_indices(
                    {k: i for i, k in enumerate(coord.col_vocab)},
                    validation_data.id_tags[coord.config.col_entity_type],
                    len(coord.col_vocab),
                )
                scorers[cid] = _MFValScorer(
                    row_idx=torch.as_tensor(ri).to(dev), col_idx=torch.as_tensor(ci).to(dev)
                )
            else:
                raise TypeError(f"no validation scorer for {type(coord)}")
        if dev is None:
            raise ValueError("validation needs at least one coordinate")

        group_codes = group_rows = None
        num_groups = 0
        if isinstance(evaluator, GroupedEvaluatorSpec):
            if evaluator.id_tag not in validation_data.id_tags:
                raise ValueError(
                    f"grouped evaluator {evaluator.name!r} needs id tag "
                    f"{evaluator.id_tag!r} on the validation data (present: "
                    f"{sorted(validation_data.id_tags)})"
                )
            # rows of weight 0 are padding and take no part
            keep = np.asarray(validation_data.weights) > 0
            tags = np.asarray(validation_data.id_tags[evaluator.id_tag])[keep]
            if len(tags) == 0:
                raise ValueError("grouped validation evaluator has no positive-weight rows")
            _, codes = np.unique(tags, return_inverse=True)
            group_codes = torch.as_tensor(codes.reshape(-1)).to(dev)
            num_groups = int(codes.max()) + 1
            group_rows = torch.as_tensor(np.flatnonzero(keep)).to(dev)

        def col(a):
            return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(device=dev, dtype=dtype)

        return DeviceValidationScorer(
            scorers=scorers,
            labels=col(validation_data.labels),
            weights=col(validation_data.weights),
            offsets=col(validation_data.offsets),
            evaluator=evaluator,
            group_codes=group_codes,
            num_groups=num_groups,
            group_rows=group_rows,
        )

    def margins(self, states: dict) -> Tensor:
        total = self.offsets
        for cid, scorer in self.scorers.items():
            total = total + scorer(states[cid]).to(total.dtype)
        return total

    def evaluate(self, states: dict) -> float:
        m = self.margins(states)
        ev = self.evaluator
        if isinstance(ev, GroupedEvaluatorSpec):
            kind, k = ev.device_kind
            v, n_valid = run_grouped(
                kind, k, m[self.group_rows], self.labels[self.group_rows],
                self.group_codes, self.num_groups,
            )
            return float(v) if int(n_valid) > 0 else float("nan")
        return float(evaluate(ev, m, self.labels, self.weights))
