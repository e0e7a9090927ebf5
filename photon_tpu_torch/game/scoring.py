"""GameScorer: score a GameModel on the device, batch by batch.

Counterpart of photon_tpu/game/scoring.GameScorer (``__init__``,
``_pack_random_effect``, ``_score_fn``, ``_host_batch``, ``score_data``),
monolithic: each batch is assembled on the host at a fixed row count, sent
to the device, and its margins + offsets stay there until one read-back at
the end. No streaming pipeline, precompile or donation yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.game.data import (
    GameData,
    _ceil_pow2,
    entity_row_indices,
    pad_game_data,
    slice_game_data,
)
from photon_tpu_torch.game.model import FixedEffectModel, GameModel, RandomEffectModel
from photon_tpu_torch.types import numpy_dtype, resolve_device

DEFAULT_BATCH_ROWS = 8192
#: widest RE feature shard the scorer densifies per batch
DENSE_COLS_MAX = 4096


class UnsupportedModelLayout(ValueError):
    """A model layout the device scorer cannot express."""


@dataclasses.dataclass(frozen=True)
class _FixedSpec:
    cid: str
    shard: str


@dataclasses.dataclass(frozen=True)
class _RandomSpec:
    cid: str
    shard: str
    tag: str
    num_entities: int


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
        self.batch_rows = batch_rows or DEFAULT_BATCH_ROWS
        self._fixed: list[_FixedSpec] = []
        self._random: list[_RandomSpec] = []
        self._ell_shards: dict[str, int] = {}
        self._dense_shards: dict[str, int] = {}
        self._params: dict = {"fe": {}, "re": {}}
        for cid, cm in model.coordinates.items():
            if isinstance(cm, FixedEffectModel):
                w = np.asarray(cm.coefficients.means)
                self._fixed.append(_FixedSpec(cid=cid, shard=cm.feature_shard))
                self._ell_shards.setdefault(cm.feature_shard, len(w))
                self._params["fe"][cid] = self._tensor(w)
            elif isinstance(cm, RandomEffectModel):
                self._params["re"][cid] = self._pack_random_effect(cid, cm)
            else:
                raise UnsupportedModelLayout(f"unknown coordinate model for {cid!r}")

    def _tensor(self, a, dtype=None) -> torch.Tensor:
        return torch.as_tensor(np.require(np.asarray(a), requirements="W")).to(
            device=self.device, dtype=dtype or self.dtype
        )

    def _pack_random_effect(self, cid: str, cm: RandomEffectModel) -> dict:
        """Per-entity coefficients in their compacted space plus the column
        map back to the shard; row E (zeros) scores unseen entities as 0 and
        invalid column slots point at the appended zero column."""
        d_shard = cm.num_features
        if d_shard > DENSE_COLS_MAX:
            raise UnsupportedModelLayout(
                f"random-effect coordinate {cid!r} scores on a shard of "
                f"{d_shard} columns, wider than the dense gather limit "
                f"{DENSE_COLS_MAX}"
            )
        e_n = len(cm.vocab)
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
                        num_entities=e_n)
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
            xg = torch.gather(batch["dense"][s.shard], 1, tab["col"][e])
            total = total + (tab["coef"][e] * xg).sum(-1)
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
                       "dense": {}, "eidx": {}}
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
        return batch

    def _to_device(self, batch: dict) -> dict:
        def put(a):
            return torch.as_tensor(a).to(self.device)

        return {
            "offsets": put(batch["offsets"]),
            "ell": {k: (put(i), put(v)) for k, (i, v) in batch["ell"].items()},
            "dense": {k: put(x) for k, x in batch["dense"].items()},
            "eidx": {k: put(e) for k, e in batch["eidx"].items()},
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
