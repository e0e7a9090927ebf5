"""GAME / GLM model persistence in the reference's on-disk format.

Counterpart of photon_tpu/io/model_io.py (reference photon-client
data/avro/ModelProcessingUtils.scala): ``<dir>/model-metadata.json``,
``<dir>/fixed-effect/<coordinate>/{id-info, coefficients/part-00000.avro}``,
``<dir>/random-effect/<coordinate>/{id-info, coefficients/part-*.avro}``
(plus ``projection-matrix.npy`` under a random projection) and
``<dir>/matrix-factorization/<coordinate>/{id-info, row-latent-factors,
col-latent-factors}``; coefficients are ``BayesianLinearModelAvro``
records of (name, term, value) means and variances, with means at or
below the sparsity threshold dropped (reference
VectorUtils.DEFAULT_SPARSITY_THRESHOLD = 1e-4). A model saved by either
package loads in the other. Scores go out as ``ScoringResultAvro``
(reference ScoreProcessingUtils) through the C++ block writer, or the
Python encoder when the native library is unavailable (logged).
"""
from __future__ import annotations

import ctypes
import json
import logging
import os
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Mapping, Sequence

import numpy as np
import torch

from photon_tpu_torch.data import native_index
from photon_tpu_torch.data.index_map import INTERSECT, DefaultIndexMap, IndexMap, feature_key
from photon_tpu_torch.game.model import (
    BucketCoefficients,
    Coefficients,
    FixedEffectModel,
    GameModel,
    MatrixFactorizationModel,
    RandomEffectModel,
)
from photon_tpu_torch.io import schemas
from photon_tpu_torch.io.avro import read_avro_dir, read_avro_file, write_avro_file
from photon_tpu_torch.models.coefficients import Coefficients as GLMCoefficients
from photon_tpu_torch.models.glm import GeneralizedLinearModel, model_for_task
from photon_tpu_torch.types import TaskType
from photon_tpu_torch.util import faults
from photon_tpu_torch.util.retry import IO_RETRY_POLICY, is_transient_io, retry_call

logger = logging.getLogger("photon_tpu_torch")

SPARSITY_THRESHOLD = 1e-4
FIXED_EFFECT = "fixed-effect"
RANDOM_EFFECT = "random-effect"
MATRIX_FACTORIZATION = "matrix-factorization"
ROW_FACTORS = "row-latent-factors"
COL_FACTORS = "col-latent-factors"
ID_INFO = "id-info"
COEFFICIENTS = "coefficients"
DEFAULT_AVRO_FILE = "part-00000.avro"
METADATA_FILE = "model-metadata.json"

# BayesianLinearModelAvro.modelClass strings of the reference's classes
_MODEL_CLASS = {
    TaskType.LOGISTIC_REGRESSION:
        "com.linkedin.photon.ml.supervised.classification.LogisticRegressionModel",
    TaskType.LINEAR_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.LinearRegressionModel",
    TaskType.POISSON_REGRESSION:
        "com.linkedin.photon.ml.supervised.regression.PoissonRegressionModel",
    TaskType.SMOOTHED_HINGE_LOSS_LINEAR_SVM:
        "com.linkedin.photon.ml.supervised.classification.SmoothedHingeLossLinearSVMModel",
}
_CLASS_TO_TASK = {v: k for k, v in _MODEL_CLASS.items()}


def _host(a) -> np.ndarray | None:
    """A coefficient array as host float64 numpy (from numpy or torch)."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().to("cpu", torch.float64).numpy()
    return np.asarray(a, dtype=np.float64)


def _split_key(key: str) -> tuple[str, str]:
    name, _, term = key.partition(INTERSECT)
    return name, term


def _ntv(name_of, cols, values) -> list[dict]:
    """(name, term, value) records of the given columns; columns without a
    name in the index map are skipped."""
    out = []
    for j, v in zip(cols, values):
        key = name_of(int(j))
        if key is None:
            continue
        name, term = _split_key(key)
        out.append({"name": name, "term": term, "value": float(v)})
    return out


def _vector_to_ntv(vec: np.ndarray, index_map: IndexMap, threshold: float) -> list[dict]:
    cols = np.flatnonzero(np.abs(vec) > threshold)
    return _ntv(index_map.get_feature_name, cols, vec[cols])


def _ntv_index(item: dict, index_map: IndexMap) -> int:
    return index_map.get_index(f"{item['name']}{INTERSECT}{item.get('term') or ''}")


def _ntv_to_vector(items: Sequence[dict], index_map: IndexMap) -> np.ndarray:
    vec = np.zeros(len(index_map))
    for item in items:
        idx = _ntv_index(item, index_map)
        if idx >= 0:
            vec[idx] = float(item["value"])
    return vec


def _glm_record(model_id, means, variances, task, index_map, threshold) -> dict:
    return {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS.get(task),
        "means": _vector_to_ntv(means, index_map, threshold),
        "variances": None if variances is None else _vector_to_ntv(variances, index_map, -np.inf),
        "lossFunction": None,
    }


# ---------------------------------------------------------------------------
# single GLM (legacy driver path)
# ---------------------------------------------------------------------------


def save_glm(
    path: str | os.PathLike,
    model: GeneralizedLinearModel,
    task: TaskType,
    index_map: IndexMap,
    *,
    model_id: str = "",
    sparsity_threshold: float = SPARSITY_THRESHOLD,
) -> None:
    """One BayesianLinearModelAvro record to one container file."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    coefs = model.coefficients
    rec = _glm_record(
        model_id, _host(coefs.means), _host(coefs.variances), task, index_map, sparsity_threshold
    )
    write_avro_file(path, schemas.BAYESIAN_LINEAR_MODEL_AVRO, [rec])


def _read_glm_arrays(path, index_map):
    records = read_avro_file(path)
    if len(records) != 1:
        raise ValueError(f"{path}: expected 1 model record, got {len(records)}")
    rec = records[0]
    means = _ntv_to_vector(rec["means"], index_map)
    variances = _ntv_to_vector(rec["variances"], index_map) if rec.get("variances") else None
    return means, variances, _CLASS_TO_TASK.get(rec.get("modelClass"))


def load_glm(
    path: str | os.PathLike, index_map: IndexMap
) -> tuple[GeneralizedLinearModel, TaskType | None]:
    """The saved GLM (float64 tensors on the host) and its task, None when
    the record names no known model class."""
    means, variances, task = _read_glm_arrays(path, index_map)
    coefs = GLMCoefficients(
        means=torch.as_tensor(means),
        variances=None if variances is None else torch.as_tensor(variances),
    )
    return model_for_task(task or TaskType.LINEAR_REGRESSION, coefs), task


# ---------------------------------------------------------------------------
# GAME model save/load
# ---------------------------------------------------------------------------


def save_game_model(
    out_dir: str | os.PathLike,
    model: GameModel,
    index_maps: Mapping[str, IndexMap],
    *,
    optimization_configurations: Mapping | None = None,
    sparsity_threshold: float = SPARSITY_THRESHOLD,
    random_effect_records_per_file: int = 10000,
) -> None:
    """Write the reference per-coordinate directory tree."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    (out / METADATA_FILE).write_text(
        json.dumps(
            {
                "modelType": model.task.name,
                "optimizationConfigurations": dict(optimization_configurations or {}),
            },
            indent=2,
        )
    )
    for cid, cm in model.coordinates.items():
        if isinstance(cm, FixedEffectModel):
            d = out / FIXED_EFFECT / cid
            (d / COEFFICIENTS).mkdir(parents=True, exist_ok=True)
            (d / ID_INFO).write_text(cm.feature_shard + "\n")
            rec = _glm_record(
                cid, _host(cm.coefficients.means), _host(cm.coefficients.variances),
                model.task, index_maps[cm.feature_shard], sparsity_threshold,
            )
            write_avro_file(
                d / COEFFICIENTS / DEFAULT_AVRO_FILE, schemas.BAYESIAN_LINEAR_MODEL_AVRO, [rec]
            )
        elif isinstance(cm, RandomEffectModel):
            d = out / RANDOM_EFFECT / cid
            (d / COEFFICIENTS).mkdir(parents=True, exist_ok=True)
            (d / ID_INFO).write_text(cm.random_effect_type + "\n" + cm.feature_shard + "\n")
            if cm.projection_matrix is not None:
                np.save(d / "projection-matrix.npy", cm.projection_matrix)
            records = _random_effect_records(
                cm, index_maps[cm.feature_shard], sparsity_threshold
            )
            step = random_effect_records_per_file
            for part, start in enumerate(range(0, max(len(records), 1), step)):
                write_avro_file(
                    d / COEFFICIENTS / f"part-{part:05d}.avro",
                    schemas.BAYESIAN_LINEAR_MODEL_AVRO,
                    records[start : start + step],
                )
        elif isinstance(cm, MatrixFactorizationModel):
            d = out / MATRIX_FACTORIZATION / cid
            d.mkdir(parents=True, exist_ok=True)
            (d / ID_INFO).write_text(cm.row_entity_type + "\n" + cm.col_entity_type + "\n")
            for sub, vocab, factors in (
                (ROW_FACTORS, cm.row_vocab, cm.row_factors),
                (COL_FACTORS, cm.col_vocab, cm.col_factors),
            ):
                (d / sub).mkdir(parents=True, exist_ok=True)
                write_avro_file(
                    d / sub / DEFAULT_AVRO_FILE,
                    schemas.LATENT_FACTOR_AVRO,
                    [
                        {"effectId": str(key), "latentFactor": [float(x) for x in factors[i]]}
                        for i, key in enumerate(vocab)
                    ],
                )
        else:
            raise TypeError(f"unknown coordinate model for {cid}")


def _random_effect_records(model: RandomEffectModel, index_map: IndexMap, threshold: float):
    records = []
    for b in model.buckets:
        for i, e in enumerate(b.entity_ids):
            w = np.asarray(b.coefficients[i])
            rec = {
                "modelId": str(model.vocab[e]),
                "modelClass": _MODEL_CLASS.get(model.task),
                "means": [],
                "variances": None,
                "lossFunction": None,
            }
            if model.projection_matrix is not None:
                # projected-space coefficients, stored positionally
                rec["means"] = [
                    {"name": str(j), "term": "", "value": float(w[j])}
                    for j in np.flatnonzero(np.abs(w) > threshold)
                ]
            else:
                cols = np.asarray(b.col_index[i])
                keep = np.flatnonzero((cols >= 0) & (np.abs(w) > threshold))
                rec["means"] = _ntv(index_map.get_feature_name, cols[keep], w[keep])
                if b.variances is not None:
                    v = np.asarray(b.variances[i])
                    rec["variances"] = _ntv(index_map.get_feature_name, cols[keep], v[keep])
            records.append(rec)
    return records


def load_game_model(
    model_dir: str | os.PathLike, index_maps: Mapping[str, IndexMap]
) -> GameModel:
    """Load the per-coordinate directory tree back into a GameModel."""
    out = Path(model_dir)
    meta = json.loads((out / METADATA_FILE).read_text())
    task = TaskType[meta["modelType"]]
    coordinates: dict = {}

    fixed_dir = out / FIXED_EFFECT
    if fixed_dir.is_dir():
        for cdir in sorted(fixed_dir.iterdir()):
            if not cdir.is_dir():
                continue
            shard = (cdir / ID_INFO).read_text().strip().splitlines()[0]
            means, variances, _ = _read_glm_arrays(
                cdir / COEFFICIENTS / DEFAULT_AVRO_FILE, index_maps[shard]
            )
            coordinates[cdir.name] = FixedEffectModel(
                coefficients=Coefficients(means=means, variances=variances),
                feature_shard=shard,
                task=task,
            )

    re_dir = out / RANDOM_EFFECT
    if re_dir.is_dir():
        for cdir in sorted(re_dir.iterdir()):
            if not cdir.is_dir() or not (cdir / COEFFICIENTS).is_dir():
                # reference artifacts may hold id-info-only coordinate dirs
                continue
            re_type, shard = (cdir / ID_INFO).read_text().strip().splitlines()[:2]
            proj_path = cdir / "projection-matrix.npy"
            proj = np.load(proj_path) if proj_path.exists() else None
            coordinates[cdir.name] = _records_to_random_effect_model(
                list(read_avro_dir(cdir / COEFFICIENTS)), re_type, shard, task,
                index_maps[shard], proj,
            )

    mf_dir = out / MATRIX_FACTORIZATION
    if mf_dir.is_dir():
        for cdir in sorted(mf_dir.iterdir()):
            if not cdir.is_dir():
                continue
            row_type, col_type = (cdir / ID_INFO).read_text().strip().splitlines()[:2]
            tables = {}
            for sub in (ROW_FACTORS, COL_FACTORS):
                records = sorted(read_avro_dir(cdir / sub), key=lambda r: str(r["effectId"]))
                tables[sub] = (
                    np.array([str(r["effectId"]) for r in records]),
                    np.array([list(map(float, r["latentFactor"])) for r in records]),
                )
            coordinates[cdir.name] = MatrixFactorizationModel(
                row_entity_type=row_type,
                col_entity_type=col_type,
                row_vocab=tables[ROW_FACTORS][0],
                col_vocab=tables[COL_FACTORS][0],
                row_factors=tables[ROW_FACTORS][1],
                col_factors=tables[COL_FACTORS][1],
            )
    return GameModel(coordinates=coordinates, task=task)


def _ceil_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _records_to_random_effect_model(
    records, re_type, shard, task, index_map, projection_matrix
) -> RandomEffectModel:
    """Rebuild the bucketed layout from per-entity records: entities are
    grouped into buckets by the power-of-two width of their support."""
    vocab = np.array(sorted(str(r["modelId"]) for r in records))
    entity_index = {k: i for i, k in enumerate(vocab)}
    per_entity = []
    for r in records:
        e = entity_index[str(r["modelId"])]
        if projection_matrix is not None:
            d_proj = projection_matrix.shape[1]
            w = np.zeros(d_proj)
            for item in r["means"]:
                w[int(item["name"])] = float(item["value"])
            per_entity.append((e, np.arange(d_proj), w, None))
            continue
        cols, vals = [], []
        for item in r["means"]:
            idx = _ntv_index(item, index_map)
            if idx >= 0:
                cols.append(idx)
                vals.append(float(item["value"]))
        var = None
        if r.get("variances"):
            vmap = {}
            for item in r["variances"]:
                idx = _ntv_index(item, index_map)
                if idx >= 0:
                    vmap[idx] = float(item["value"])
            var = np.array([vmap.get(c, 0.0) for c in cols])
        per_entity.append((e, np.asarray(cols, dtype=np.int64), np.asarray(vals), var))

    groups: dict[int, list] = {}
    for ent in per_entity:
        groups.setdefault(_ceil_pow2(max(len(ent[1]), 1)), []).append(ent)
    buckets = []
    for d_max, ents in sorted(groups.items()):
        n_ent = len(ents)
        entity_ids = np.zeros(n_ent, dtype=np.int32)
        col_index = np.full((n_ent, d_max), -1, dtype=np.int32)
        coefficients = np.zeros((n_ent, d_max))
        variances = np.zeros((n_ent, d_max)) if any(v is not None for *_, v in ents) else None
        for i, (e, cols, vals, var) in enumerate(ents):
            entity_ids[i] = e
            col_index[i, : len(cols)] = cols
            coefficients[i, : len(vals)] = vals
            if var is not None and variances is not None:
                variances[i, : len(var)] = var
        buckets.append(
            BucketCoefficients(
                entity_ids=entity_ids, col_index=col_index,
                coefficients=coefficients, variances=variances,
            )
        )
    return RandomEffectModel(
        random_effect_type=re_type,
        feature_shard=shard,
        task=task,
        vocab=vocab,
        buckets=tuple(buckets),
        num_features=len(index_map),
        projection_matrix=projection_matrix,
    )


# ---------------------------------------------------------------------------
# scoring output (reference ScoreProcessingUtils)
# ---------------------------------------------------------------------------


def _write_scores(path, scores, model_id, labels, weights, uids) -> tuple[int, str]:
    """ScoringResultAvro records to ``path``; returns (count, encoder),
    encoder "native" (the C++ block writer) or "python"."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if os.environ.get("PHOTON_NO_NATIVE_AVRO") == "1":
        reason = "PHOTON_NO_NATIVE_AVRO=1"
    else:
        written, reason = _save_scoring_results_native(
            path, scores, model_id, labels, weights, uids
        )
        if written is not None:
            return written, "native"
    logger.warning("score writer: %s; writing %s with the Python encoder", reason, path)
    n = len(scores)
    records = (
        {
            "uid": None if uids is None else uids[i],
            "label": None if labels is None else float(labels[i]),
            "modelId": model_id,
            "predictionScore": float(scores[i]),
            "weight": None if weights is None else float(weights[i]),
            "metadataMap": None,
        }
        for i in range(n)
    )
    return write_avro_file(path, schemas.SCORING_RESULT_AVRO, records), "python"


def save_scoring_results(
    path: str | os.PathLike,
    scores: np.ndarray,
    *,
    model_id: str = "",
    labels: np.ndarray | None = None,
    weights: np.ndarray | None = None,
    uids: Sequence[str | None] | None = None,
) -> int:
    """Write ScoringResultAvro records (ScoreProcessingUtils.scala:88);
    returns the count. The C++ block writer (native/avro_writer.cpp)
    writes them unless the native library is unavailable, then the Python
    encoder does, and a warning says why."""
    return _write_scores(path, scores, model_id, labels, weights, uids)[0]


class ShardedScoringWriter:
    """Sharded ScoringResultAvro output across ``part-NNNNN.avro`` files.

    ``write_chunk`` assigns each finished score batch to the next
    partition round-robin and buffers only its score/label/weight/uid
    columns; ``close`` writes every partition (zero-record ones too) in
    one shot through the block writer, shards in parallel, and returns
    the total record count. ``encoders`` names the writer each part took.
    """

    def __init__(self, out_dir: str | os.PathLike, *, num_partitions: int = 1, model_id: str = ""):
        if num_partitions < 1:
            raise ValueError(f"num_partitions must be >= 1, got {num_partitions}")
        self.out_dir = Path(out_dir)
        self.out_dir.mkdir(parents=True, exist_ok=True)
        self.model_id = model_id
        self.num_partitions = num_partitions
        #: part → (scores, labels, weights, uids) column-chunk lists
        self._parts: dict[int, tuple[list, list, list, list]] = {}
        self._next = 0
        self._paths: list[str] = []
        self._closed = False
        self._columns: tuple[bool, bool, bool] | None = None
        self.total = 0
        self.encoders: set[str] = set()

    def write_chunk(self, scores, *, labels=None, weights=None, uids=None) -> int:
        if self._closed:
            raise ValueError(
                "write_chunk on a closed ShardedScoringWriter: the part files are "
                "already written; this chunk would be dropped"
            )
        # close() concatenates per column, so a chunk without a column
        # mixed with chunks that have it would misalign rows
        sig = (labels is not None, weights is not None, uids is not None)
        if self._columns is None:
            self._columns = sig
        elif sig != self._columns:
            raise ValueError(
                "write_chunk column presence changed mid-stream: first chunk had "
                f"(labels, weights, uids)={self._columns}, this chunk has {sig}; "
                "pass the same columns for every chunk"
            )
        part = self._next % self.num_partitions
        self._next += 1
        buf = self._parts.setdefault(part, ([], [], [], []))
        buf[0].append(np.asarray(scores))
        buf[1].append(None if labels is None else np.asarray(labels))
        buf[2].append(None if weights is None else np.asarray(weights))
        buf[3].append(None if uids is None else list(uids))
        return len(scores)

    def paths(self) -> list[str]:
        return list(self._paths)

    def close(self) -> int:
        if self._closed:  # a with-block exit after close() rewrites nothing
            return self.total

        def col(chunks, concat):
            present = [c for c in chunks if c is not None]
            return concat(present) if present else None

        def flush_part(part: int):
            s, lab, w, u = self._parts.get(part, ([], [], [], []))
            path = self.out_dir / f"part-{part:05d}.avro"

            def write():
                # a flush rewrites the whole part file, so a transient
                # failure (or an injected one) is retried safely
                faults.fault_point("io.shard_flush")
                return _write_scores(
                    path,
                    np.concatenate(s) if s else np.zeros(0),
                    self.model_id,
                    col(lab, np.concatenate),
                    col(w, np.concatenate),
                    col(u, lambda us: [x for c in us for x in c]),
                )

            n, encoder = retry_call(
                write, policy=IO_RETRY_POLICY, classify=is_transient_io, label="shard_flush"
            )
            return str(path), n, encoder

        parts = range(self.num_partitions)
        # distinct files, and the C++ writer runs without the interpreter
        # lock, so the shards are written side by side
        workers = min(len(parts), os.cpu_count() or 2, 4)
        with ThreadPoolExecutor(max_workers=workers) as ex:
            flushed = list(ex.map(flush_part, parts))
        for path, n, encoder in flushed:
            self._paths.append(path)
            self.total += n
            self.encoders.add(encoder)
        self._parts = {}
        self._closed = True
        return self.total

    def __enter__(self) -> "ShardedScoringWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def _save_scoring_results_native(path, scores, model_id, labels, weights, uids):
    """The C++ writer; returns (count, None), or (None, reason) when the
    caller must use the Python encoder."""
    lib = native_index.load_native_lib()
    if lib is None:
        return None, native_index.native_unavailable_reason
    dptr_t = ctypes.POINTER(ctypes.c_double)
    lib.pml_write_scores.restype = ctypes.c_int
    lib.pml_write_scores.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
        dptr_t, dptr_t, dptr_t,
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
    ]
    n = len(scores)
    uid_pool, uid_offs, uid_valid = b"", None, None
    if uids is not None:
        offs = np.zeros(n + 1, dtype=np.int64)
        valid = np.zeros(n, dtype=np.uint8)
        parts = []
        total = 0
        for i, u in enumerate(uids):
            if u is not None:
                b = str(u).encode("utf-8")
                parts.append(b)
                total += len(b)
                valid[i] = 1  # an explicit mask: "" stays distinct from None
            offs[i + 1] = total
        uid_pool = b"".join(parts)
        uid_offs, uid_valid = offs, valid

    def f64(a):
        return None if a is None else np.ascontiguousarray(a, dtype=np.float64)

    def ptr(a, t):
        return None if a is None else a.ctypes.data_as(ctypes.POINTER(t))

    # the arrays stay referenced by these names until the call returns
    scores64, labels64, weights64 = f64(scores), f64(labels), f64(weights)
    schema_json = json.dumps(schemas.SCORING_RESULT_AVRO).encode("utf-8")
    mid = model_id.encode("utf-8")
    rc = lib.pml_write_scores(
        os.fsencode(str(path)), schema_json, len(schema_json), ctypes.c_int64(n),
        ptr(scores64, ctypes.c_double), ptr(labels64, ctypes.c_double),
        ptr(weights64, ctypes.c_double),
        uid_pool, ptr(uid_offs, ctypes.c_int64), ptr(uid_valid, ctypes.c_uint8),
        mid, len(mid), ctypes.c_int64(4096),
    )
    if rc != 0:
        return None, f"native score writer returned {rc}"
    return n, None


def read_model_feature_keys(model_dir: str | os.PathLike, shard_configs: Mapping) -> dict[str, IndexMap]:
    """Per-shard index maps rebuilt from a saved model's own vocabulary,
    so scoring without an off-heap store places coefficients the same way
    whatever features the scoring data has (features the model lacks
    score zero anyway)."""
    keys: dict[str, set] = {}
    root = Path(model_dir)
    for section in (FIXED_EFFECT, RANDOM_EFFECT):
        d = root / section
        if not d.is_dir():
            continue
        for cdir in sorted(d.iterdir()):
            if not cdir.is_dir():
                continue
            if (cdir / "projection-matrix.npy").exists():
                # projected coefficients carry positional names; the shard's
                # vocabulary cannot be recovered from them
                raise ValueError(
                    f"model coordinate {cdir.name!r} uses a random projection; "
                    "scoring it requires the training-time feature index "
                    "(--off-heap-index-map-dir)"
                )
            if not (cdir / COEFFICIENTS).is_dir():
                continue  # id-info-only coordinate (see load_game_model)
            lines = (cdir / ID_INFO).read_text().strip().splitlines()
            shard = lines[0] if section == FIXED_EFFECT else lines[1]
            bucket = keys.setdefault(shard, set())
            for rec in read_avro_dir(cdir / COEFFICIENTS):
                for ntv in (rec.get("means") or []) + (rec.get("variances") or []):
                    bucket.add(feature_key(ntv["name"], ntv.get("term") or ""))
    out: dict[str, IndexMap] = {}
    for shard, ks in keys.items():
        cfg = shard_configs.get(shard)
        has_intercept = True if cfg is None else cfg.has_intercept
        out[shard] = DefaultIndexMap.from_keys(ks, add_intercept=has_intercept)
    return out
