"""GAME host data: columnar GameData, CSR shards, the bucketed RE build.

Counterpart of photon_tpu/game/data.py, carried as the port's own numpy
copy (the JAX package is not imported). Bucket arrays come out identical
to the JAX build for the same data, config and seed: the reservoir draw,
the random-projection draw, the Pearson cap, the DP row levels, the shape
pool, the greedy consolidation and the fill are the same code. Not
carried over: the mesh's shard-major entity order.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Mapping, Sequence

import numpy as np

from photon_tpu_torch.data.dataset import DataSet, csr_to_ell
from photon_tpu_torch.game.config import ProjectorType, RandomEffectCoordinateConfig
from photon_tpu_torch.ops.losses import POSITIVE_RESPONSE_THRESHOLD

#: entity key of padding rows: weight 0, no random-effect entity
PAD_ENTITY_KEY = "__photon_pad__"

@dataclasses.dataclass
class CSRMatrix:
    """Features-only CSR block (one feature shard)."""

    indptr: np.ndarray
    indices: np.ndarray
    values: np.ndarray
    num_cols: int

    @property
    def num_rows(self) -> int:
        return self.indptr.shape[0] - 1

    def to_dense(self, dtype=np.float32) -> np.ndarray:
        out = np.zeros((self.num_rows, self.num_cols), dtype=dtype)
        rows = np.repeat(np.arange(self.num_rows), np.diff(self.indptr))
        out[rows, self.indices] = self.values
        return out

    def to_ell(self, dtype=np.float32, nnz_pad_multiple: int = 8):
        return csr_to_ell(
            self.indptr, self.indices, self.values,
            dtype=dtype, nnz_pad_multiple=nnz_pad_multiple,
        )

    @staticmethod
    def from_dense(x: np.ndarray) -> "CSRMatrix":
        n, d = x.shape
        mask = x != 0
        indptr = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(mask.sum(axis=1), out=indptr[1:])
        return CSRMatrix(
            indptr=indptr,
            indices=np.nonzero(mask)[1].astype(np.int32),
            values=x[mask].astype(np.float64),
            num_cols=d,
        )


@dataclasses.dataclass
class GameData:
    """Columnar GAME dataset: N samples, feature shards, entity id tags,
    and optional per-sample ids (``uids``, carried to score output)."""

    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    feature_shards: Mapping[str, CSRMatrix]
    id_tags: Mapping[str, np.ndarray]
    uids: Sequence[str | None] | None = None
    #: ingest provenance set by the reader that produced the data (the
    #: feature cache tags ``{"source": "cache", ...}``); None for data
    #: built on the host or decoded from Avro. Informational only: slices,
    #: concatenations and padding drop it, as in the JAX package
    provenance: Mapping | None = None

    def __post_init__(self):
        n = self.num_samples
        for name, shard in self.feature_shards.items():
            if shard.num_rows != n:
                raise ValueError(f"shard {name} has {shard.num_rows} rows != {n}")
        for tag, col in self.id_tags.items():
            if len(col) != n:
                raise ValueError(f"id tag {tag} has {len(col)} rows != {n}")
        if self.uids is not None and len(self.uids) != n:
            raise ValueError(f"uids has {len(self.uids)} rows != {n}")

    @property
    def num_samples(self) -> int:
        return self.labels.shape[0]

    def shard_dataset(self, shard: str):
        """One feature shard with the shared label, offset and weight
        columns as a flat DataSet (the single-GLM view)."""
        m = self.feature_shards[shard]
        return DataSet(
            indptr=m.indptr, indices=m.indices, values=m.values, labels=self.labels,
            offsets=self.offsets, weights=self.weights, num_features=m.num_cols,
        )

    @staticmethod
    def build(
        labels: np.ndarray,
        feature_shards: Mapping[str, CSRMatrix],
        *,
        offsets: np.ndarray | None = None,
        weights: np.ndarray | None = None,
        id_tags: Mapping[str, Sequence] | None = None,
        uids: Sequence[str | None] | None = None,
    ) -> "GameData":
        n = len(labels)
        return GameData(
            labels=np.asarray(labels, dtype=np.float64),
            offsets=np.zeros(n) if offsets is None else np.asarray(offsets),
            weights=np.ones(n) if weights is None else np.asarray(weights),
            feature_shards=dict(feature_shards),
            id_tags={t: np.asarray(v).astype(str) for t, v in (id_tags or {}).items()},
            uids=uids,
        )


def slice_game_data(data: GameData, lo: int, hi: int) -> GameData:
    """Row range [lo, hi) with CSR rows re-based."""
    lo, hi = max(0, int(lo)), min(data.num_samples, int(hi))
    shards = {}
    for name, m in data.feature_shards.items():
        nz_lo, nz_hi = int(m.indptr[lo]), int(m.indptr[hi])
        shards[name] = CSRMatrix(
            indptr=(m.indptr[lo : hi + 1] - nz_lo).astype(m.indptr.dtype),
            indices=m.indices[nz_lo:nz_hi],
            values=m.values[nz_lo:nz_hi],
            num_cols=m.num_cols,
        )
    return GameData(
        labels=data.labels[lo:hi],
        offsets=data.offsets[lo:hi],
        weights=data.weights[lo:hi],
        feature_shards=shards,
        id_tags={t: np.asarray(col)[lo:hi] for t, col in data.id_tags.items()},
        uids=None if data.uids is None else list(data.uids[lo:hi]),
    )


def concat_game_data(pieces: Sequence[GameData]) -> GameData:
    """Row-wise concatenation (the pieces must share shards and id tags)."""
    if not pieces:
        raise ValueError("concat_game_data needs at least one piece")
    if len(pieces) == 1:
        return pieces[0]
    first = pieces[0]
    for p in pieces[1:]:
        if set(p.feature_shards) != set(first.feature_shards) or set(p.id_tags) != set(
            first.id_tags
        ):
            raise ValueError("GameData pieces disagree on shards or id tags")
        if (p.uids is None) != (first.uids is None):
            raise ValueError("GameData pieces disagree on uid presence")
    shards = {}
    for name in first.feature_shards:
        mats = [p.feature_shards[name] for p in pieces]
        num_cols = mats[0].num_cols
        if any(m.num_cols != num_cols for m in mats):
            raise ValueError(f"shard {name} width differs across pieces")
        indptrs = [mats[0].indptr]
        base = int(mats[0].indptr[-1])
        for m in mats[1:]:
            indptrs.append(m.indptr[1:] + base)
            base += int(m.indptr[-1])
        shards[name] = CSRMatrix(
            indptr=np.concatenate(indptrs),
            indices=np.concatenate([m.indices for m in mats]),
            values=np.concatenate([m.values for m in mats]),
            num_cols=num_cols,
        )
    return GameData(
        labels=np.concatenate([p.labels for p in pieces]),
        offsets=np.concatenate([p.offsets for p in pieces]),
        weights=np.concatenate([p.weights for p in pieces]),
        feature_shards=shards,
        id_tags={
            t: np.concatenate([np.asarray(p.id_tags[t]) for p in pieces])
            for t in first.id_tags
        },
        uids=None if first.uids is None else [u for p in pieces for u in p.uids],
    )


def entity_row_indices(index, keys, oov: int) -> np.ndarray:
    """Entity keys → dense table rows, ``oov`` for unseen keys."""
    keys = np.asarray(keys)
    return np.fromiter((index.get(k, oov) for k in keys), dtype=np.int64, count=len(keys))


def pad_game_data(data: GameData, multiple: int) -> GameData:
    """Round the sample count up to ``multiple`` with zero-weight rows that
    have empty feature rows and the PAD_ENTITY_KEY id tag."""
    n = data.num_samples
    target = -(-n // multiple) * multiple
    if target == n:
        return data
    pad = target - n
    shards = {
        name: CSRMatrix(
            indptr=np.concatenate(
                [m.indptr, np.full(pad, m.indptr[-1], dtype=m.indptr.dtype)]
            ),
            indices=m.indices,
            values=m.values,
            num_cols=m.num_cols,
        )
        for name, m in data.feature_shards.items()
    }
    id_tags = {
        tag: np.concatenate([np.asarray(col).astype(str), np.full(pad, PAD_ENTITY_KEY)])
        for tag, col in data.id_tags.items()
    }
    return GameData(
        labels=np.concatenate([data.labels, np.zeros(pad)]),
        offsets=np.concatenate([data.offsets, np.zeros(pad)]),
        weights=np.concatenate([data.weights, np.zeros(pad)]),
        feature_shards=shards,
        id_tags=id_tags,
        uids=None if data.uids is None else list(data.uids) + [None] * pad,
    )


# ---------------------------------------------------------------------------
# Random-effect dataset build
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class REBucket:
    """One (n_max, d_max) size bucket. Train blocks hold only ACTIVE rows;
    the flat score arrays hold every kept row (active and passive) with no
    padding.

    features [E, n_max, d_max]; labels/offsets/weights/active_mask
    [E, n_max]; col_index [E, d_max] (−1 pad; all −1 under a random
    projection); sample_pos [E, n_max] (num_samples ⇒ pad); entity_ids
    [E]; score_feats [M, d_max] (rows of sample weight 0 zeroed);
    score_slot/score_pos [M].
    """

    features: np.ndarray
    labels: np.ndarray
    offsets: np.ndarray
    weights: np.ndarray
    active_mask: np.ndarray
    col_index: np.ndarray
    sample_pos: np.ndarray
    entity_ids: np.ndarray
    score_feats: np.ndarray
    score_slot: np.ndarray
    score_pos: np.ndarray

    @property
    def padded_samples(self) -> int:
        return self.features.shape[1]

    @property
    def projected_dim(self) -> int:
        return self.features.shape[2]


@dataclasses.dataclass
class RandomEffectDataset:
    random_effect_type: str
    feature_shard: str
    vocab: np.ndarray
    entity_index: dict
    buckets: list[REBucket]
    num_samples: int
    num_features: int
    #: [num_features, k] Gaussian matrix under a RANDOM projector, else None
    projection_matrix: np.ndarray | None = None

    @property
    def num_entities(self) -> int:
        return len(self.vocab)

    def shape_stats(self) -> dict:
        """Bucket solves and the distinct (rows, d) shapes among them."""
        shapes = sorted({(b.padded_samples, b.projected_dim) for b in self.buckets})
        return {
            "bucket_solves": len(self.buckets),
            "distinct_shapes": len(shapes),
            "shapes": [list(s) for s in shapes],
        }

    def memory_budget(self, bytes_per_element: int = 4) -> dict:
        """Device bytes of the bucketed layout: per bucket the [E, n, d]
        feature block, four [E, n] vectors plus int32 sample positions, and
        the flat score arrays."""
        per_bucket = []
        total = 0
        coefficients = 0
        for b in self.buckets:
            e, n_rows, d = b.features.shape
            feat = e * n_rows * d * bytes_per_element
            vecs = 4 * e * n_rows * bytes_per_element + e * n_rows * 4
            score = b.score_feats.size * bytes_per_element + 2 * (b.score_pos.size * 4)
            per_bucket.append(
                {
                    "shape": [e, n_rows, d],
                    "bytes": int(feat + vecs + score),
                    "score_rows": int(b.score_pos.size),
                }
            )
            total += feat + vecs + score
            coefficients += e * d
        return {
            "buckets": per_bucket,
            "total_bytes": int(total),
            "coefficient_count": int(coefficients),
            "coefficient_bytes": int(coefficients * bytes_per_element),
        }

    def padding_waste(self) -> dict:
        """Active rows against padded training rows, per bucket and in
        total (the flat score arrays carry no padding)."""
        per_bucket = []
        used_total = padded_total = score_rows_total = 0
        for b in self.buckets:
            used = int((b.active_mask > 0).sum())
            padded = int(b.labels.size)
            per_bucket.append(
                {
                    "shape": list(b.features.shape),
                    "used_cells": used,
                    "padded_cells": padded,
                    "waste": round(1.0 - used / padded, 4) if padded else 0.0,
                    "score_rows": int(b.score_pos.size),
                }
            )
            used_total += used
            padded_total += padded
            score_rows_total += int(b.score_pos.size)
        return {
            "buckets": per_bucket,
            "total_used": used_total,
            "total_padded": padded_total,
            "score_rows": score_rows_total,
            "total_waste": (
                round(1.0 - used_total / padded_total, 4) if padded_total else 0.0
            ),
        }


def _ceil_pow2(n: int, floor: int = 8) -> int:
    p = floor
    while p < n:
        p *= 2
    return p


def _ceil_pow2_vec(arr: np.ndarray, floor: int) -> np.ndarray:
    a = np.maximum(np.asarray(arr, dtype=np.int64), floor)
    return (1 << np.ceil(np.log2(a)).astype(np.int64)).astype(np.int64)


def re_bucket_entity_cap() -> int:
    """Entities per bucket at most (same-shape chunks beyond it):
    ``PHOTON_RE_MAX_BUCKET_ENTITIES``, default 8,000,000."""
    cap_env = os.environ.get("PHOTON_RE_MAX_BUCKET_ENTITIES", "").strip()
    ent_cap = int(cap_env) if cap_env else 8_000_000
    if ent_cap < 1:
        raise ValueError(f"PHOTON_RE_MAX_BUCKET_ENTITIES must be >= 1, got {ent_cap}")
    return ent_cap


#: default cap on the distinct (rows, d) bucket shapes of one fit
DEFAULT_SHAPE_BUDGET = 11


def re_shape_budget(config_value: int | None = None) -> int | None:
    """The config's ``shape_budget`` (0 disables → None), else the default."""
    if config_value is not None:
        return config_value if config_value > 0 else None
    return DEFAULT_SHAPE_BUDGET


def _split_shape_budget(budget: int | None, n_groups: int) -> int | None:
    if budget is None or n_groups <= 1:
        return budget
    return max(1, budget // n_groups)


def _optimal_row_levels(
    sizes: np.ndarray,
    waste_target: float = 0.12,
    max_levels: int = 16,
    shape_budget: int | None = None,
) -> np.ndarray:
    """Row-count levels minimizing padded rows: DP-partition the sorted
    distinct sizes into K contiguous segments (cost = entities × segment
    max), smallest K whose waste ≤ ``waste_target``, K ≤ the budget."""
    if shape_budget is not None:
        max_levels = min(max_levels, int(shape_budget))
    u, c = np.unique(np.asarray(sizes, dtype=np.int64), return_counts=True)
    n_u = len(u)
    if n_u <= 1:
        return u
    cum = np.concatenate(([0], np.cumsum(c)))
    used = float((u * c).sum())
    budget = used / max(1.0 - waste_target, 1e-9)
    dp_prev = np.full(n_u + 1, np.inf)
    dp_prev[0] = 0.0
    args: list[np.ndarray] = []
    best_k = None
    for k in range(1, min(max_levels, n_u) + 1):
        dp_k = np.full(n_u + 1, np.inf)
        arg_k = np.zeros(n_u + 1, dtype=np.int64)
        for j in range(1, n_u + 1):
            cand = dp_prev[:j] + (cum[j] - cum[:j]) * u[j - 1]
            a = int(np.argmin(cand))
            dp_k[j] = cand[a]
            arg_k[j] = a
        args.append(arg_k)
        dp_prev = dp_k
        if dp_k[n_u] <= budget:
            best_k = k
            break
    if best_k is None:
        best_k = len(args)
    levels = []
    j, k = n_u, best_k
    while k > 0:
        i = args[k - 1][j]
        levels.append(int(u[j - 1]))
        j = int(i)
        k -= 1
    return np.asarray(sorted(levels), dtype=np.int64)


def _pack_shape_keys(n_pad: np.ndarray, d_pad: np.ndarray) -> np.ndarray:
    return n_pad.astype(np.int64) << 32 | d_pad.astype(np.int64)


#: voluntary consolidation stops at merges adding this many padded cells
_MERGE_CELL_BUDGET = 1_000_000


def _rows_are_canonical(indices: np.ndarray, num_rows: int, num_cols: int) -> bool:
    """Every stored row's columns are exactly 0..num_cols-1 in order."""
    if num_cols <= 0:
        return False
    idx2d = indices.reshape(num_rows, num_cols)
    expect = np.arange(num_cols, dtype=indices.dtype)
    chunk = max(1, (1 << 22) // num_cols)
    for start in range(0, num_rows, chunk):
        block = idx2d[start : start + chunk]
        if not np.array_equal(block, np.broadcast_to(expect, block.shape)):
            return False
    return True


def _is_dense_shard(shard: CSRMatrix) -> bool:
    return (
        shard.num_cols > 0
        and bool(np.all((shard.indptr[1:] - shard.indptr[:-1]) == shard.num_cols))
        and _rows_are_canonical(shard.indices, shard.num_rows, shard.num_cols)
    )


def _consolidate_shapes(
    keys: np.ndarray,
    counts: np.ndarray,
    max_buckets: int | None,
    cell_allowance: int | None = None,
) -> np.ndarray | None:
    """Greedy merges of size buckets: repeatedly merge the pair whose union
    shape (elementwise max) adds the fewest padded cells, while that costs
    under ``_MERGE_CELL_BUDGET`` (and ``cell_allowance`` in total), and
    regardless of cost while more than ``max_buckets`` shapes remain
    (``PHOTON_RE_MAX_BUCKETS`` overrides; ≤ 0 disables). Returns the merged
    key per input class, or None when nothing merges."""
    env = os.environ.get("PHOTON_RE_MAX_BUCKETS", "").strip()
    if env:
        max_buckets = int(env)
    if max_buckets is not None and max_buckets <= 0:
        return None
    shapes = [[int(k >> 32), int(k & 0xFFFFFFFF), int(c)] for k, c in zip(keys, counts)]
    target = list(range(len(shapes)))
    alive = set(target)
    merged_any = False
    while len(alive) > 1:
        best = None
        alive_list = sorted(alive)
        for ai in range(len(alive_list)):
            for bi in range(ai + 1, len(alive_list)):
                a, b = shapes[alive_list[ai]], shapes[alive_list[bi]]
                nm, dm = max(a[0], b[0]), max(a[1], b[1])
                added = a[2] * (nm * dm - a[0] * a[1]) + b[2] * (nm * dm - b[0] * b[1])
                if best is None or added < best[0]:
                    best = (added, alive_list[ai], alive_list[bi], nm, dm)
        added, ai, bi, nm, dm = best
        over_cap = max_buckets is not None and len(alive) > max_buckets
        budget = _MERGE_CELL_BUDGET
        if cell_allowance is not None:
            budget = min(budget, cell_allowance + 1)
        if not over_cap and added >= budget:
            break
        shapes[ai] = [nm, dm, shapes[ai][2] + shapes[bi][2]]
        alive.discard(bi)
        if cell_allowance is not None:
            cell_allowance = max(0, cell_allowance - added)
        merged_any = True
        for i, t in enumerate(target):
            if t == bi:
                target[i] = ai
    if not merged_any:
        return None
    return np.asarray(
        [
            np.int64(shapes[target[i]][0]) << 32 | np.int64(shapes[target[i]][1])
            for i in range(len(keys))
        ]
    )


class ShapePool:
    """Cross-coordinate bucket-shape pool: the row-level DP runs once per
    d-group over the pooled per-entity sizes of every coordinate, so all
    coordinates snap to one shared level set. Protocol: ``observe`` per
    coordinate, ``freeze`` once, then pass the pool to the build."""

    def __init__(self, budget: int | None, waste_target: float = 0.12):
        self.budget = budget
        self.waste_target = waste_target
        self._sizes: dict[int, list[np.ndarray]] = {}
        self._levels: dict[int, np.ndarray] = {}
        self._frozen = False

    def observe(self, d_pad: np.ndarray, n_trn: np.ndarray) -> None:
        if self._frozen:
            raise RuntimeError("ShapePool is frozen")
        d_pad = np.asarray(d_pad, dtype=np.int64)
        n_trn = np.asarray(n_trn, dtype=np.int64)
        for dv in np.unique(d_pad):
            self._sizes.setdefault(int(dv), []).append(n_trn[d_pad == dv])

    def freeze(self) -> "ShapePool":
        if not self._frozen:
            group_budget = _split_shape_budget(self.budget, len(self._sizes))
            for dv, chunks in self._sizes.items():
                self._levels[dv] = _optimal_row_levels(
                    np.concatenate(chunks),
                    waste_target=self.waste_target,
                    shape_budget=group_budget,
                )
            self._frozen = True
        return self

    def covers(self, d: int) -> bool:
        return self._frozen and int(d) in self._levels

    def levels_for(self, d: int, sizes: np.ndarray) -> np.ndarray:
        levels = self._levels[int(d)]
        top = int(np.max(sizes)) if len(sizes) else 0
        if top > int(levels[-1]):
            levels = np.concatenate([levels, [top]])
        return levels


def profile_random_effect_shapes(
    data: GameData,
    config: RandomEffectCoordinateConfig,
    *,
    existing_model_keys=None,
) -> tuple[np.ndarray, np.ndarray] | None:
    """Exact (d_pad, n_trn) per-entity shape profile without the block
    fills; None for shards it cannot price cheaply (general sparse index
    compaction, Pearson capping)."""
    shard = data.feature_shards[config.feature_shard]
    if config.projector_type == ProjectorType.RANDOM:
        d_proj = config.random_projection_dim or 64
    elif config.features_to_samples_ratio is None and _is_dense_shard(shard):
        d_proj = shard.num_cols
    else:
        return None
    keys = np.asarray(data.id_tags[config.random_effect_type])
    valid = keys[keys != PAD_ENTITY_KEY]
    vocab, counts = np.unique(valid, return_counts=True)
    entity_kept = counts >= config.active_data_lower_bound
    if existing_model_keys is not None:
        entity_kept = entity_kept | ~np.isin(vocab, np.asarray(list(existing_model_keys)))
    counts = counts[entity_kept]
    ub = config.active_data_upper_bound
    n_trn = np.maximum(np.minimum(counts, ub) if ub is not None else counts, 1).astype(
        np.int64
    )
    d_pad = np.full(len(n_trn), _ceil_pow2(max(int(d_proj), 1)), np.int64)
    return d_pad, n_trn


def _concat_ranges(starts: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """Vectorized ``concat([arange(s, s+l) ...])``."""
    total = int(lengths.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int64)
    nz = lengths > 0
    starts_nz = starts[nz].astype(np.int64)
    lengths_nz = lengths[nz].astype(np.int64)
    ends_nz = np.cumsum(lengths_nz)
    out = np.ones(total, dtype=np.int64)
    out[0] = starts_nz[0]
    out[ends_nz[:-1]] = starts_nz[1:] - (starts_nz[:-1] + lengths_nz[:-1] - 1)
    return np.cumsum(out)


def build_random_effect_dataset(
    data: GameData,
    config: RandomEffectCoordinateConfig,
    *,
    seed: int = 0,
    intercept_col: int | None = None,
    existing_model_keys=None,
    shape_pool: ShapePool | None = None,
) -> RandomEffectDataset:
    """Group samples by entity, apply the bounds and reservoir sampling,
    project each entity's columns (index compaction with an optional
    Pearson cap, or a Gaussian random projection), and pack ACTIVE rows
    into padded train blocks at DP-optimal (n, d) levels and every kept
    row into flat score arrays (photon_tpu/game/data.py:894).

    ``existing_model_keys`` (a warm start that ignores the threshold for
    new models): entities WITHOUT a prior model bypass the active lower
    bound. ``intercept_col`` always survives the Pearson cap."""
    rng = np.random.default_rng(seed)
    shard = data.feature_shards[config.feature_shard]
    keys = np.asarray(data.id_tags[config.random_effect_type])
    n = data.num_samples

    # --- group rows by entity ---------------------------------------------
    valid_idx = np.flatnonzero(keys != PAD_ENTITY_KEY)
    vocab, entity_of_valid = np.unique(keys[valid_idx], return_inverse=True)
    num_v = len(vocab)
    counts = np.bincount(entity_of_valid, minlength=num_v)
    order = valid_idx[np.argsort(entity_of_valid, kind="stable")]
    ent_sorted = np.repeat(np.arange(num_v), counts)
    group_starts = np.zeros(num_v + 1, dtype=np.int64)
    np.cumsum(counts, out=group_starts[1:])

    # the projection draw precedes the reservoir draw on the same generator
    rnd_proj = None
    if config.projector_type == ProjectorType.RANDOM:
        k = config.random_projection_dim or 64
        rnd_proj = rng.normal(size=(shard.num_cols, k)) / np.sqrt(k)

    # --- active selection: reservoir cap via random keys -------------------
    ub = config.active_data_upper_bound
    if ub is not None and len(order):
        rand_keys = rng.random(len(order))
        sel = np.lexsort((rand_keys, ent_sorted))
        rank = np.arange(len(order)) - group_starts[ent_sorted]
        active_sorted = np.empty(len(order), dtype=bool)
        active_sorted[sel] = rank < ub
    else:
        active_sorted = np.ones(len(order), dtype=bool)
    active_counts = np.minimum(counts, ub) if ub is not None else counts

    # --- passive filtering + entity lower bound ----------------------------
    num_passive = counts - active_counts
    drop_passive = (num_passive > 0) & (num_passive <= config.passive_data_lower_bound)
    entity_kept = counts >= config.active_data_lower_bound
    if existing_model_keys is not None:
        has_prior = np.isin(vocab, np.asarray(list(existing_model_keys)))
        entity_kept = entity_kept | ~has_prior
    keep_sorted = entity_kept[ent_sorted] & (active_sorted | ~drop_passive[ent_sorted])

    kept_rows = order[keep_sorted]
    kept_ent = ent_sorted[keep_sorted]
    kept_active = active_sorted[keep_sorted].astype(np.float64)
    n_k = np.bincount(kept_ent, minlength=num_v)
    kept_starts = np.zeros(num_v + 1, dtype=np.int64)
    np.cumsum(n_k, out=kept_starts[1:])
    row_rank = np.arange(len(kept_rows)) - kept_starts[kept_ent]

    # --- nonzeros of kept rows: dense fast path or per-nonzero arrays -------
    fast_dense = (
        rnd_proj is None
        and config.features_to_samples_ratio is None
        and _is_dense_shard(shard)
    )
    if fast_dense:
        x2d = np.ascontiguousarray(
            shard.values.reshape(shard.num_rows, shard.num_cols), dtype=np.float32
        )
        d_proj = np.full(num_v, shard.num_cols)
    else:
        nnz_per_row = (shard.indptr[kept_rows + 1] - shard.indptr[kept_rows]).astype(
            np.int64
        )
        nnz_src = _concat_ranges(shard.indptr[kept_rows], nnz_per_row)
        nnz_col = shard.indices[nnz_src].astype(np.int64)
        nnz_val = shard.values[nnz_src].astype(np.float64)
        nnz_ent = np.repeat(kept_ent, nnz_per_row)
        nnz_rowpos = np.repeat(np.arange(len(kept_rows)), nnz_per_row)
        d_proj = np.full(num_v, rnd_proj.shape[1] if rnd_proj is not None else 0)
    if not fast_dense and rnd_proj is None:
        # --- index compaction: per-entity column unions, Pearson cap ------
        combined = nnz_ent * np.int64(shard.num_cols) + nnz_col
        pairs, pair_inv = np.unique(combined, return_inverse=True)
        pair_ent = (pairs // shard.num_cols).astype(np.int64)
        pair_col = (pairs % shard.num_cols).astype(np.int64)
        d_all = np.bincount(pair_ent, minlength=num_v)
        pair_starts = np.searchsorted(pair_ent, np.arange(num_v))

        keep_pair = np.ones(len(pairs), dtype=bool)
        if config.features_to_samples_ratio is not None:
            cap = np.maximum(
                1, (config.features_to_samples_ratio * active_counts).astype(np.int64)
            )
            needs_cap = d_all > cap
            if needs_cap.any():
                # Pearson |corr(feature, label)| per (entity, column) pair
                # over ACTIVE rows, by segment sums over the nonzeros
                w_act = kept_active[nnz_rowpos]
                y_nnz = data.labels[kept_rows][nnz_rowpos]
                m = len(pairs)
                sum_x = np.bincount(pair_inv, weights=nnz_val * w_act, minlength=m)
                sum_x2 = np.bincount(pair_inv, weights=nnz_val**2 * w_act, minlength=m)
                sum_xy = np.bincount(pair_inv, weights=nnz_val * y_nnz * w_act, minlength=m)
                y_kept = data.labels[kept_rows]
                n_act_f = np.bincount(kept_ent, weights=kept_active, minlength=num_v)
                sum_y = np.bincount(kept_ent, weights=y_kept * kept_active, minlength=num_v)
                sum_y2 = np.bincount(
                    kept_ent, weights=y_kept**2 * kept_active, minlength=num_v
                )
                na = n_act_f[pair_ent]
                var_x = sum_x2 - sum_x**2 / np.maximum(na, 1)
                var_y = (sum_y2 - sum_y**2 / np.maximum(n_act_f, 1))[pair_ent]
                denom = np.sqrt(np.maximum(var_x * var_y, 0.0))
                num = np.abs(sum_xy - sum_x * sum_y[pair_ent] / np.maximum(na, 1))
                corr = np.where(denom > 0, num / np.where(denom > 0, denom, 1), 0.0)
                if intercept_col is not None:
                    corr = np.where(pair_col == intercept_col, np.inf, corr)
                # rank within entity by descending corr, ties by ascending column
                by_corr = np.lexsort((pair_col, -corr, pair_ent))
                corr_rank = np.empty(m, dtype=np.int64)
                corr_rank[by_corr] = np.arange(m) - pair_starts[pair_ent[by_corr]]
                cap_eff = np.where(needs_cap, cap, np.iinfo(np.int64).max)
                keep_pair = corr_rank < cap_eff[pair_ent]

        # local column = rank among the entity's kept pairs, ascending column
        csum = np.cumsum(keep_pair)
        base = np.concatenate(([0], csum))[pair_starts]
        local_of_pair = np.where(keep_pair, csum - 1 - base[pair_ent], -1).astype(np.int64)
        d_proj = np.bincount(pair_ent[keep_pair], minlength=num_v)

    # --- bucket assignment -------------------------------------------------
    n_act = np.bincount(kept_ent, weights=kept_active, minlength=num_v).astype(np.int64)
    act = kept_active > 0
    act_prefix = np.concatenate(([0], np.cumsum(act)))
    act_rank = (act_prefix[1:] - 1) - act_prefix[kept_starts[kept_ent]]

    ent_list = np.flatnonzero(entity_kept & (n_k > 0))
    n_trn = np.maximum(n_act[ent_list], 1)
    d_pad = _ceil_pow2_vec(np.maximum(d_proj[ent_list], 1), floor=8)
    n_lvl = np.empty_like(n_trn)
    budget = re_shape_budget(config.shape_budget)
    d_groups = np.unique(d_pad)
    group_budget = _split_shape_budget(budget, len(d_groups))
    for dv in d_groups:
        grp = d_pad == dv
        if budget is not None and shape_pool is not None and shape_pool.covers(int(dv)):
            levels = shape_pool.levels_for(int(dv), n_trn[grp])
        else:
            levels = _optimal_row_levels(n_trn[grp], shape_budget=group_budget)
        n_lvl[grp] = levels[np.searchsorted(levels, n_trn[grp])]
    combined = _pack_shape_keys(n_lvl, d_pad)
    shape_keys, shape_inv = np.unique(combined, return_inverse=True)
    # greedy consolidation within the remaining waste allowance; under an
    # active shape budget only a hard cap (config or env) forces it
    used_cells = int((n_trn * d_pad).sum())
    padded_cells = int((n_lvl * d_pad).sum())
    allowance = max(0, int(0.18 * used_cells) - (padded_cells - used_cells))
    env_cap = os.environ.get("PHOTON_RE_MAX_BUCKETS", "").strip()
    hard_cap = config.max_buckets is not None or (env_cap != "" and int(env_cap) > 0)
    merged = (
        _consolidate_shapes(
            shape_keys,
            np.bincount(shape_inv, minlength=len(shape_keys)),
            config.max_buckets,
            cell_allowance=allowance,
        )
        if len(shape_keys) > 1 and (budget is None or hard_cap)
        else None
    )
    if merged is not None:
        combined = merged[shape_inv]
        shape_keys, shape_inv = np.unique(combined, return_inverse=True)
    inv_order = np.argsort(shape_inv, kind="stable")
    shape_counts = np.bincount(shape_inv, minlength=len(shape_keys))
    shape_bounds = np.concatenate(([0], np.cumsum(shape_counts)))
    ent_cap = re_bucket_entity_cap()
    bucket_specs: list[tuple[int, int, np.ndarray]] = []
    for bi, key in enumerate(shape_keys):
        ents = ent_list[inv_order[shape_bounds[bi] : shape_bounds[bi + 1]]]
        shape = (int(key >> 32), int(key & 0xFFFFFFFF))
        for s0 in range(0, len(ents), ent_cap):
            bucket_specs.append((shape[0], shape[1], ents[s0 : s0 + ent_cap]))

    slot_of_entity = np.full(num_v, -1, dtype=np.int64)
    bucket_of_entity = np.full(num_v, -1, dtype=np.int64)
    flat_start_of_entity = np.zeros(num_v, dtype=np.int64)
    for bi, (_, _, ents) in enumerate(bucket_specs):
        ents = np.asarray(ents, dtype=np.int64)
        slot_of_entity[ents] = np.arange(len(ents))
        bucket_of_entity[ents] = bi
        flat_start_of_entity[ents] = np.concatenate(([0], np.cumsum(n_k[ents])[:-1]))

    # --- fill buckets -------------------------------------------------------
    row_bucket = bucket_of_entity[kept_ent]
    row_slot = slot_of_entity[kept_ent]
    flat_row = flat_start_of_entity[kept_ent] + row_rank
    order_rb = np.argsort(row_bucket, kind="stable")
    rb_bounds = np.searchsorted(row_bucket[order_rb], np.arange(len(bucket_specs) + 1))
    if not fast_dense:
        nnz_bucket = row_bucket[nnz_rowpos]
        order_nz = np.argsort(nnz_bucket, kind="stable")
        nz_bounds = np.searchsorted(nnz_bucket[order_nz], np.arange(len(bucket_specs) + 1))
        if rnd_proj is None:
            pair_bucket = bucket_of_entity[pair_ent]
            order_pair = np.argsort(pair_bucket, kind="stable")
            pair_bounds = np.searchsorted(
                pair_bucket[order_pair], np.arange(len(bucket_specs) + 1)
            )

    buckets = []
    for bi, (n_max, d_max, ents) in enumerate(bucket_specs):
        ents = np.asarray(ents, dtype=np.int64)
        e = len(ents)
        feats = np.zeros((e, n_max, d_max), dtype=np.float32)
        labels = np.zeros((e, n_max), dtype=np.float32)
        offsets = np.zeros((e, n_max), dtype=np.float32)
        weights = np.zeros((e, n_max), dtype=np.float32)
        active_mask = np.zeros((e, n_max), dtype=np.float32)
        col_index = np.full((e, d_max), -1, dtype=np.int32)
        sample_pos = np.full((e, n_max), n, dtype=np.int32)

        rows_in_b = order_rb[rb_bounds[bi] : rb_bounds[bi + 1]]
        m_b = int(n_k[ents].sum())
        score_feats = np.zeros((m_b, d_max), dtype=np.float32)
        score_slot = np.zeros(m_b, dtype=np.int32)
        score_pos = np.zeros(m_b, dtype=np.int32)
        fr_b = flat_row[rows_in_b]
        score_slot[fr_b] = row_slot[rows_in_b]
        score_pos[fr_b] = kept_rows[rows_in_b]

        act_rows = rows_in_b[act[rows_in_b]]
        s, r = row_slot[act_rows], act_rank[act_rows]
        rows_act = kept_rows[act_rows]
        labels[s, r] = data.labels[rows_act]
        offsets[s, r] = data.offsets[rows_act]
        weights[s, r] = data.weights[rows_act]
        active_mask[s, r] = 1.0
        sample_pos[s, r] = rows_act

        if fast_dense:
            d_col = shard.num_cols
            score_feats[fr_b, :d_col] = x2d[kept_rows[rows_in_b]]
            col_index[:, :d_col] = np.arange(d_col, dtype=np.int32)
        elif rnd_proj is None:
            nz_sel = order_nz[nz_bounds[bi] : nz_bounds[bi + 1]]
            lc = local_of_pair[pair_inv[nz_sel]]
            ok = lc >= 0  # Pearson-dropped columns vanish
            score_feats[flat_row[nnz_rowpos[nz_sel][ok]], lc[ok]] = nnz_val[nz_sel][ok]
            pb = order_pair[pair_bounds[bi] : pair_bounds[bi + 1]]
            ent_pairs = pb[local_of_pair[pb] >= 0]
            col_index[slot_of_entity[pair_ent[ent_pairs]], local_of_pair[ent_pairs]] = (
                pair_col[ent_pairs].astype(np.int32)
            )
        else:
            nz_sel = order_nz[nz_bounds[bi] : nz_bounds[bi + 1]]
            k = rnd_proj.shape[1]
            dense = np.zeros((m_b, k), dtype=np.float64)
            np.add.at(
                dense,
                flat_row[nnz_rowpos[nz_sel]],
                nnz_val[nz_sel, None] * rnd_proj[nnz_col[nz_sel]],
            )
            score_feats[:, :k] = dense.astype(np.float32)

        feats[s, r, :] = score_feats[flat_row[act_rows]]
        w_b = np.asarray(data.weights)[kept_rows[rows_in_b]]
        zero_rows = fr_b[w_b <= 0]
        if len(zero_rows):
            score_feats[zero_rows] = 0.0

        buckets.append(
            REBucket(
                features=feats, labels=labels, offsets=offsets, weights=weights,
                active_mask=active_mask, col_index=col_index, sample_pos=sample_pos,
                entity_ids=ents.astype(np.int32), score_feats=score_feats,
                score_slot=score_slot, score_pos=score_pos,
            )
        )

    return RandomEffectDataset(
        random_effect_type=config.random_effect_type,
        feature_shard=config.feature_shard,
        vocab=vocab,
        entity_index={k: i for i, k in enumerate(vocab)},
        buckets=buckets,
        num_samples=n,
        num_features=shard.num_cols,
        projection_matrix=rnd_proj,
    )


def labels_are_binary(labels: np.ndarray) -> bool:
    u = set(np.unique(labels))
    return u <= {0.0, 1.0} or u <= {-1.0, 1.0}


def positive_rate(labels: np.ndarray) -> float:
    return float((labels > POSITIVE_RESPONSE_THRESHOLD).mean())
