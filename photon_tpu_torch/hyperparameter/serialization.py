"""Prior-observation serialization + search-range shrinking.

Reference parity: photon-client hyperparameter/HyperparameterSerialization
.scala (``priorFromJson`` — a JSON map with a ``records`` array of
string→string maps, each carrying one ``evaluationValue`` plus hyperparameter
values, missing ones filled from defaults) and ShrinkSearchRange.scala
(``getBounds`` — fit a Matern52 GP to the rescaled priors, score a Sobol
candidate pool, and return a ±radius box around the best predicted point).
"""
from __future__ import annotations

import json
from typing import Mapping, Sequence

import numpy as np

from photon_tpu_torch.hyperparameter.gp import GaussianProcessEstimator
from photon_tpu_torch.hyperparameter.kernels import Matern52

EVALUATION_KEY = "evaluationValue"


def priors_from_json(
    prior_json: str,
    names: Sequence[str],
    defaults: Mapping[str, float] | None = None,
) -> list[tuple[dict[str, float], float]]:
    """Parse prior observations: → [(name→value map, evaluation value)].

    Values are in ORIGINAL hyperparameter units (e.g. regularization
    weights), exactly as the reference serializes them; missing names fall
    back to ``defaults`` (an error if absent there too, like the
    reference's ``priorDefault(paramName)`` lookup).
    """
    data = json.loads(prior_json)
    records = data.get("records")
    if not isinstance(records, list):
        raise ValueError("prior JSON must carry a 'records' array")
    defaults = dict(defaults or {})
    out = []
    for rec in records:
        if EVALUATION_KEY not in rec:
            raise ValueError(f"prior record missing {EVALUATION_KEY}: {rec}")
        value = float(rec[EVALUATION_KEY])
        params: dict[str, float] = {}
        for name in names:
            if name in rec:
                params[name] = float(rec[name])
            elif name in defaults:
                params[name] = float(defaults[name])
            else:
                raise ValueError(
                    f"prior record missing hyperparameter {name!r} and no "
                    f"default was provided: {rec}"
                )
        out.append((params, value))
    return out


def priors_to_json(
    observations: Sequence[tuple[Mapping[str, float], float]],
) -> str:
    """Inverse of ``priors_from_json`` (values stringified like the JVM
    writer, so files round-trip between the stacks)."""
    records = []
    for params, value in observations:
        rec = {k: repr(float(v)) for k, v in params.items()}
        rec[EVALUATION_KEY] = repr(float(value))
        records.append(rec)
    return json.dumps({"records": records}, indent=2)


def shrink_search_range(
    prior_points01: np.ndarray,
    prior_values: np.ndarray,
    *,
    radius: float,
    maximize: bool = True,
    candidate_pool_size: int = 1024,  # power of two keeps Sobol balanced
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Reference ShrinkSearchRange.getBounds in [0, 1]^d space: GP-fit the
    priors, score a Sobol pool, box ±radius around the best prediction.

    ``prior_points01``: [n, d] rescaled hyperparameter settings;
    returns (lower [d], upper [d]) clipped to [0, 1].
    """
    from photon_tpu_torch.hyperparameter.qmc_compat import sobol_engine

    pts = np.atleast_2d(np.asarray(prior_points01, dtype=float))
    vals = np.asarray(prior_values, dtype=float)
    y = vals if maximize else -vals
    model = GaussianProcessEstimator(kernel=Matern52()).fit(pts, y)
    d = pts.shape[1]
    pool = sobol_engine(d, scramble=True, seed=seed).random(
        candidate_pool_size
    )
    mean, _ = model.predict(pool)
    best = pool[int(np.argmax(mean))]
    lower = np.clip(best - radius, 0.0, 1.0)
    upper = np.clip(best + radius, 0.0, 1.0)
    return lower, upper
