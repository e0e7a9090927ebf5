"""GameScorer: score a GameModel on the device, batch by batch.

Counterpart of the batch program of photon_tpu/game/scoring.GameScorer
(``__init__``, ``_pack_random_effect``, ``_score_fn``, ``_host_batch``,
``score_data``): each batch is assembled on the host at a fixed row
count, sent to the device, and its margins + offsets stay there until one
read-back at the end. Fixed effects gather their coefficients per ELL
slot; a random effect under a random projection gathers one projection
row per nonzero slot (x·P without densifying x), an index-mapped one
gathers its columns from the batch's zero-padded dense block; MF adds
⟨u, v⟩. Each entity table has a trailing zero row that unseen entities
read. No streaming pipeline, precompile or donation yet.
"""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from photon_tpu_torch.game.data import (
    GameData,
    _ceil_pow2,
    entity_row_indices,
    pad_game_data,
    slice_game_data,
)
from photon_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.types import numpy_dtype, resolve_device

DEFAULT_BATCH_ROWS = 8192
#: widest index-mapped RE feature shard the scorer densifies per batch
DENSE_COLS_MAX = 4096


def score_batch_rows(config_value: int | None = None) -> int:
    """Rows per scoring batch: ``PHOTON_SCORE_BATCH_ROWS`` env > the
    given value > DEFAULT_BATCH_ROWS."""
    env = os.environ.get("PHOTON_SCORE_BATCH_ROWS", "").strip()
    if env:
        v = int(env)
    elif config_value is not None:
        v = int(config_value)
    else:
        return DEFAULT_BATCH_ROWS
    if v < 1:
        raise ValueError(f"score batch rows must be >= 1, got {v}")
    return v


class UnsupportedModelLayout(ValueError):
    """A model layout the device scorer cannot express (an index-mapped
    random effect on a shard wider than the dense gather limit, or an
    unknown coordinate model); the host path ``GameModel.score`` can."""


@dataclasses.dataclass(frozen=True)
class _FixedSpec:
    cid: str
    shard: str


@dataclasses.dataclass(frozen=True)
class _RandomSpec:
    cid: str
    shard: str
    tag: str
    projected: bool
    num_entities: int


@dataclasses.dataclass(frozen=True)
class _MFSpec:
    cid: str
    row_tag: str
    col_tag: str
    num_rows: int
    num_cols: int


class GameScorer:
    """Scores = Σ coordinate margins + offsets, computed on ``device``."""

    def __init__(
        self,
        model: GameModel,
        *,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.float32,
        batch_rows: int | None = None,
    ):
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = model
        self.batch_rows = score_batch_rows(batch_rows)
        self._fixed: list[_FixedSpec] = []
        self._random: list[_RandomSpec] = []
        self._mf: list[_MFSpec] = []
        self._ell_shards: dict[str, int] = {}
        self._dense_shards: dict[str, int] = {}
        self._params: dict = {"fe": {}, "re": {}, "mf": {}}
        for cid, cm in model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                w = np.asarray(cm.coefficients.means)
                self._fixed.append(_FixedSpec(cid=cid, shard=cm.feature_shard))
                self._ell_shards.setdefault(cm.feature_shard, len(w))
                self._params["fe"][cid] = self._tensor(w)
            elif isinstance(cm, RandomEffectModel):
                self._params["re"][cid] = self._pack_random_effect(cid, cm)
            elif isinstance(cm, MatrixFactorizationModel):
                k = cm.num_factors
                self._mf.append(
                    _MFSpec(
                        cid=cid, row_tag=cm.row_entity_type, col_tag=cm.col_entity_type,
                        num_rows=len(cm.row_vocab), num_cols=len(cm.col_vocab),
                    )
                )
                self._params["mf"][cid] = {
                    "u": self._tensor(np.concatenate([cm.row_factors, np.zeros((1, k))])),
                    "v": self._tensor(np.concatenate([cm.col_factors, np.zeros((1, k))])),
                }
            else:
                raise UnsupportedModelLayout(f"unknown coordinate model for {cid!r}")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.require(np.asarray(a), requirements="W")).to(
            device=self.device, dtype=dtype or self.dtype
        )

    def _pack_random_effect(self, cid: str, cm: RandomEffectModel) -> dict:
        """Per-entity coefficients in their projected space; row E (zeros)
        scores unseen entities as 0. Projected: the [D, k] matrix rides
        along. Index-mapped: the column map back to the shard, invalid slots
        pointing at the batch block's appended zero column."""
        e_n = len(cm.vocab)
        if cm.projection_matrix is not None:
            k = cm.projection_matrix.shape[1]
            coef = np.zeros((e_n + 1, k))
            for b in cm.buckets:
                coef[np.asarray(b.entity_ids)] = np.asarray(b.coefficients)[:, :k]
            self._random.append(
                _RandomSpec(cid=cid, shard=cm.feature_shard, tag=cm.random_effect_type,
                            projected=True, num_entities=e_n)
            )
            self._ell_shards.setdefault(cm.feature_shard, cm.num_features)
            return {"coef": self._tensor(coef), "proj": self._tensor(cm.projection_matrix)}
        d_shard = cm.num_features
        if d_shard > DENSE_COLS_MAX:
            raise UnsupportedModelLayout(
                f"random-effect coordinate {cid!r} scores on shard "
                f"{cm.feature_shard!r} with {d_shard} columns, wider than the "
                f"dense gather limit {DENSE_COLS_MAX}; "
                "score it with GameModel.score on the host"
            )
        d_pack = max((int(np.asarray(b.col_index).shape[1]) for b in cm.buckets), default=1)
        coef = np.zeros((e_n + 1, d_pack))
        col = np.full((e_n + 1, d_pack), d_shard, dtype=np.int64)
        for b in cm.buckets:
            ids = np.asarray(b.entity_ids)
            ci = np.asarray(b.col_index)
            coef[ids, : ci.shape[1]] = np.asarray(b.coefficients)
            col[ids, : ci.shape[1]] = np.where(ci >= 0, ci, d_shard)
        self._random.append(
            _RandomSpec(cid=cid, shard=cm.feature_shard, tag=cm.random_effect_type,
                        projected=False, num_entities=e_n)
        )
        self._dense_shards.setdefault(cm.feature_shard, d_shard)
        return {"coef": self._tensor(coef), "col": self._tensor(col, torch.int64)}

    def _score_fn(self, batch: dict) -> torch.Tensor:
        """Total margin + offsets for one padded batch, all coordinates."""
        total = batch["offsets"]
        for s in self._fixed:
            idx, val = batch["ell"][s.shard]
            total = total + (val * self._params["fe"][s.cid][idx]).sum(-1)
        for s in self._random:
            tab = self._params["re"][s.cid]
            e = batch["eidx"][s.cid]
            coef = tab["coef"][e]
            if s.projected:
                idx, val = batch["ell"][s.shard]
                # x·P by one P row per nonzero slot (padding slots hold 0)
                x_eff = torch.einsum("bs,bsk->bk", val, tab["proj"][idx])
                total = total + (coef * x_eff).sum(-1)
            else:
                xg = torch.gather(batch["dense"][s.shard], 1, tab["col"][e])
                total = total + (coef * xg).sum(-1)
        for s in self._mf:
            tabs = self._params["mf"][s.cid]
            ri, ci = batch["mf"][s.cid]
            total = total + (tabs["u"][ri] * tabs["v"][ci]).sum(-1)
        return total

    def _host_batch(self, chunk: GameData) -> dict:
        """Pad a chunk to ``batch_rows`` and assemble the numpy batch: ELL
        blocks at power-of-two widths, dense blocks with an appended zero
        column, entity table rows."""
        if chunk.num_samples > self.batch_rows:
            raise ValueError(
                f"chunk has {chunk.num_samples} rows > batch_rows={self.batch_rows}"
            )
        padded = pad_game_data(chunk, self.batch_rows)
        np_dtype = numpy_dtype(self.dtype)
        batch: dict = {"offsets": padded.offsets.astype(np_dtype), "ell": {},
                       "dense": {}, "eidx": {}, "mf": {}}
        for shard, width in self._ell_shards.items():
            m = padded.feature_shards[shard]
            if m.num_cols != width:
                raise ValueError(
                    f"shard {shard!r} has {m.num_cols} columns; the model has {width}"
                )
            k_raw = int(np.max(np.diff(m.indptr))) if m.num_rows else 1
            idx, val = m.to_ell(dtype=np_dtype, nnz_pad_multiple=_ceil_pow2(max(k_raw, 1)))
            batch["ell"][shard] = (idx.astype(np.int64), val)
        for shard, width in self._dense_shards.items():
            m = padded.feature_shards[shard]
            if m.num_cols != width:
                raise ValueError(
                    f"shard {shard!r} has {m.num_cols} columns; the model has {width}"
                )
            x = np.zeros((self.batch_rows, width + 1), dtype=np_dtype)
            rows = np.repeat(np.arange(m.num_rows), np.diff(m.indptr))
            x[rows, m.indices] = m.values
            batch["dense"][shard] = x
        for s in self._random:
            cm = self.model.coordinates[s.cid]
            batch["eidx"][s.cid] = entity_row_indices(
                cm.entity_row_index, padded.id_tags[s.tag], s.num_entities
            )
        for s in self._mf:
            cm = self.model.coordinates[s.cid]
            batch["mf"][s.cid] = (
                entity_row_indices(cm.row_index, padded.id_tags[s.row_tag], s.num_rows),
                entity_row_indices(cm.col_index, padded.id_tags[s.col_tag], s.num_cols),
            )
        return batch

    def _to_device(self, batch: dict) -> dict:
        def put(a):
            return torch.as_tensor(a).to(self.device)

        return {
            "offsets": put(batch["offsets"]),
            "ell": {k: (put(i), put(v)) for k, (i, v) in batch["ell"].items()},
            "dense": {k: put(x) for k, x in batch["dense"].items()},
            "eidx": {k: put(e) for k, e in batch["eidx"].items()},
            "mf": {k: (put(r), put(c)) for k, (r, c) in batch["mf"].items()},
        }

    def score_data(self, data: GameData) -> np.ndarray:
        """Scores (margins + offsets) for every row of ``data``."""
        n = data.num_samples
        parts = []
        for lo in range(0, n, self.batch_rows):
            hi = min(lo + self.batch_rows, n)
            batch = self._to_device(self._host_batch(slice_game_data(data, lo, hi)))
            parts.append(self._score_fn(batch)[: hi - lo])
        if not parts:
            return np.zeros(0)
        return torch.cat(parts).cpu().numpy()
