"""Compound CLI-argument parsing (reference io/scopt/ScoptParserHelpers.scala).

The reference passes structured configs as repeated ``key=value`` lists:

- feature shard:   ``name=global, feature.bags=bag1|bag2, intercept=true``
- coordinate:      ``name=per-user, random.effect.type=userId,
                     feature.shard=user, optimizer=LBFGS, max.iter=20,
                     tolerance=1e-6, regularization=L2, reg.weights=1|10|100,
                     active.data.lower.bound=2, ...``

Keys match the reference constants (ScoptParserHelpers.scala:39-101);
secondary lists use ``|``. Copy of photon_tpu/cli/parsing.py over the
port's config classes.
"""
from __future__ import annotations

import dataclasses

from photon_tpu_torch.evaluation.evaluators import EvaluatorType
from photon_tpu_torch.game.config import (
    CoordinateConfig,
    FeatureRepresentation,
    FixedEffectCoordinateConfig,
    MatrixFactorizationCoordinateConfig,
    ProjectorType,
    RandomEffectCoordinateConfig,
)
from photon_tpu_torch.io.data_reader import FeatureShardConfig
from photon_tpu_torch.optimize.common import OptimizerConfig
from photon_tpu_torch.optimize.problem import (
    GLMProblemConfig,
    RegularizationContext,
    RegularizationType,
)
from photon_tpu_torch.types import OptimizerType, TaskType

KV_DELIMITER = "="
LIST_DELIMITER = ","
SECONDARY_LIST_DELIMITER = "|"


def parse_kv(s: str) -> dict[str, str]:
    """``k1=v1, k2=v2`` → dict (reference ScoptParserHelpers.parseArgs)."""
    out: dict[str, str] = {}
    for part in s.split(LIST_DELIMITER):
        part = part.strip()
        if not part:
            continue
        if KV_DELIMITER not in part:
            raise ValueError(f"expected key{KV_DELIMITER}value, got {part!r}")
        k, v = part.split(KV_DELIMITER, 1)
        k, v = k.strip(), v.strip()
        if k in out:
            raise ValueError(f"duplicate key {k!r} in {s!r}")
        out[k] = v
    return out


def _pop_bool(kv: dict[str, str], key: str, default: bool) -> bool:
    v = kv.pop(key, None)
    if v is None:
        return default
    if v.lower() in ("true", "1", "yes"):
        return True
    if v.lower() in ("false", "0", "no"):
        return False
    raise ValueError(f"bad boolean for {key}: {v!r}")


def parse_feature_shard_config(s: str) -> tuple[str, FeatureShardConfig]:
    """One ``--feature-shard-configurations`` instance
    (reference parseFeatureShardConfiguration :161-164)."""
    kv = parse_kv(s)
    try:
        name = kv.pop("name")
        bags = tuple(
            b.strip()
            for b in kv.pop("feature.bags").split(SECONDARY_LIST_DELIMITER)
            if b.strip()
        )
    except KeyError as e:
        raise ValueError(f"feature shard config missing {e}") from None
    intercept = _pop_bool(kv, "intercept", True)
    if kv:
        raise ValueError(f"unknown feature shard config keys: {sorted(kv)}")
    return name, FeatureShardConfig(feature_bags=bags, has_intercept=intercept)


def _parse_weights(s: str) -> tuple[float, ...]:
    ws = tuple(float(w) for w in s.split(SECONDARY_LIST_DELIMITER) if w.strip())
    if not ws:
        raise ValueError("empty reg.weights list")
    return ws


def parse_coordinate_config(
    s: str, task: TaskType
) -> tuple[str, CoordinateConfig]:
    """One ``--coordinate-configurations`` instance
    (reference parseCoordinateConfiguration :190-280)."""
    kv = parse_kv(s)
    try:
        name = kv.pop("name")
    except KeyError as e:
        raise ValueError(f"coordinate config missing {e}") from None
    is_mf = "row.entity.type" in kv
    shard = kv.pop("feature.shard", None)
    if shard is None and not is_mf:
        raise ValueError("coordinate config missing 'feature.shard'")
    if shard is not None and is_mf:
        raise ValueError(
            "matrix-factorization coordinates take no feature.shard"
        )

    opt_cfg = OptimizerConfig()
    if "max.iter" in kv:
        opt_cfg = dataclasses.replace(
            opt_cfg, max_iterations=int(kv.pop("max.iter"))
        )
    if "tolerance" in kv:
        opt_cfg = dataclasses.replace(
            opt_cfg, tolerance=float(kv.pop("tolerance"))
        )
    optimizer = OptimizerType[kv.pop("optimizer", "LBFGS").upper()]

    reg_type = RegularizationType[kv.pop("regularization", "NONE").upper()]
    alpha = float(kv.pop("reg.alpha")) if "reg.alpha" in kv else None
    reg_weights = _parse_weights(kv.pop("reg.weights", "0"))

    problem = GLMProblemConfig(
        task=task,
        optimizer=optimizer,
        optimizer_config=opt_cfg,
        regularization=RegularizationContext(
            regularization_type=reg_type, elastic_net_alpha=alpha
        ),
        down_sampling_rate=float(kv.pop("down.sampling.rate", "1.0")),
    )

    if is_mf:
        row_type = kv.pop("row.entity.type")
        try:
            col_type = kv.pop("col.entity.type")
        except KeyError:
            raise ValueError(
                "matrix-factorization coordinate needs 'col.entity.type'"
            ) from None
        num_factors = int(kv.pop("num.factors", "16"))
        init_scale = float(kv.pop("init.scale", "0.1"))
        if kv:
            raise ValueError(f"unknown coordinate config keys: {sorted(kv)}")
        return name, MatrixFactorizationCoordinateConfig(
            row_entity_type=row_type,
            col_entity_type=col_type,
            optimization=problem,
            num_factors=num_factors,
            regularization_weights=reg_weights,
            init_scale=init_scale,
        )

    re_type = kv.pop("random.effect.type", None)
    if re_type is None:
        representation = FeatureRepresentation[
            kv.pop("representation", "AUTO").upper()
        ]
        bf16 = _pop_bool(kv, "bf16.features", False)
        if bf16 and representation == FeatureRepresentation.SPARSE:
            raise ValueError(
                "bf16.features applies to dense feature blocks only "
                "(sparse-ELL values stay f32)"
            )
        if any(k.startswith(("active.data", "passive")) for k in kv):
            raise ValueError(
                "active/passive data bounds only apply to random effects"
            )
        if kv:
            raise ValueError(f"unknown coordinate config keys: {sorted(kv)}")
        return name, FixedEffectCoordinateConfig(
            feature_shard=shard,
            optimization=problem,
            regularization_weights=reg_weights,
            representation=representation,
            bf16_features=bf16,
        )

    upper = kv.pop("active.data.upper.bound", None)
    config = RandomEffectCoordinateConfig(
        random_effect_type=re_type,
        feature_shard=shard,
        optimization=problem,
        regularization_weights=reg_weights,
        active_data_lower_bound=int(kv.pop("active.data.lower.bound", "1")),
        active_data_upper_bound=None if upper is None else int(upper),
        passive_data_lower_bound=int(kv.pop("passive.data.bound", "0")),
        features_to_samples_ratio=(
            float(kv.pop("features.to.samples.ratio"))
            if "features.to.samples.ratio" in kv
            else None
        ),
        projector_type=ProjectorType[kv.pop("projector.type", "INDEX_MAP").upper()],
        random_projection_dim=(
            int(kv.pop("random.projection.dim"))
            if "random.projection.dim" in kv
            else None
        ),
        # compile-bill governor: total distinct bucket shapes cap
        # (0 disables; absent → the library default shape budget)
        shape_budget=(
            int(kv.pop("shape.budget")) if "shape.budget" in kv else None
        ),
    )
    kv.pop("min.partitions", None)  # Spark partition counts: accepted, unused
    if kv:
        raise ValueError(f"unknown coordinate config keys: {sorted(kv)}")
    return name, config


def parse_evaluators(s: str):
    """Comma-separated evaluator list (reference EvaluatorType.withName);
    ``BASE:idTag`` tokens parse as grouped per-entity evaluators
    (reference MultiEvaluatorType, e.g. ``AUC:queryId``,
    ``PRECISION@5:documentId``)."""
    from photon_tpu_torch.evaluation.multi import parse_grouped_evaluator

    out = []
    for tok in s.split(LIST_DELIMITER):
        tok = tok.strip()
        if not tok:
            continue
        grouped = parse_grouped_evaluator(tok)
        if grouped is not None:
            out.append(grouped)
            continue
        tok = tok.upper().replace("-", "_")
        try:
            out.append(EvaluatorType[tok])
        except KeyError:
            valid = ", ".join(e.name for e in EvaluatorType)
            raise ValueError(
                f"unknown evaluator {tok!r}; expected one of {valid} or "
                "BASE:idTag for grouped evaluation"
            ) from None
    return out
