"""Coefficient box constraints: a JSON constraint string → bounds.

Host copy of photon_tpu/optimize/constraints.py (the legacy CLI flag
``coefficient-box-constraints``, GLMSuite.scala:190-290): a JSON array of
maps {"name", "term", "lowerBound", "upperBound"} becomes
{feature index: (lower, upper)} and then dense ``lower/upper`` arrays for
``OptimizerConfig``, which the optimizers project into after every step.

Semantics, as the reference's:
- every entry names both ``name`` and ``term``; a missing bound is ∓∞,
  and at least one of the two is finite;
- ``lowerBound < upperBound``;
- ``name == "*"`` needs ``term == "*"``, applies to every feature but the
  intercept, and must be the only constraint;
- ``term == "*"`` applies to every term of ``name``;
- two constraints on one feature are an error.
"""
from __future__ import annotations

import json
import math
from typing import Mapping

import numpy as np

from photon_tpu_torch.data.index_map import INTERCEPT_KEY, INTERSECT, feature_key

WILDCARD = "*"


def parse_constraint_string(
    constraint_string: str,
    key_to_index: Mapping[str, int],
) -> dict[int, tuple[float, float]]:
    """JSON constraint array → {feature index: (lower, upper)}.

    ``key_to_index`` maps feature keys (``name + DELIMITER + term``) to
    column indices — an ``IndexMap`` iterated into a dict, or any mapping.
    Raises ``ValueError`` on every malformed input the reference rejects.
    """
    try:
        entries = json.loads(constraint_string)
    except json.JSONDecodeError as e:
        raise ValueError(f"constraint string is not valid JSON: {e}") from e
    if not isinstance(entries, list):
        raise ValueError("constraint string must be a JSON array of maps")

    # An all-feature wildcard must be the ONLY constraint — checked upfront
    # so ordering cannot smuggle extra entries past it.
    if any(
        isinstance(e, dict) and e.get("name") == WILDCARD for e in entries
    ) and len(entries) > 1:
        raise ValueError(
            "an all-feature wildcard constraint cannot be combined with any "
            "other constraint"
        )

    constraint_map: dict[int, tuple[float, float]] = {}

    def put(idx: int, name: str, term: str, lo: float, hi: float) -> None:
        if idx in constraint_map:
            raise ValueError(
                f"conflicting bounds: feature name [{name}] term [{term}] "
                f"already constrained to {constraint_map[idx]}, attempted "
                f"to add {(lo, hi)}"
            )
        constraint_map[idx] = (lo, hi)

    for entry in entries:
        if not isinstance(entry, dict) or "name" not in entry or "term" not in entry:
            raise ValueError(
                "each constraint map must specify both 'name' and 'term'; "
                f"malformed entry: {entry!r}"
            )
        name, term = str(entry["name"]), str(entry["term"])
        lo_raw = entry.get("lowerBound")
        hi_raw = entry.get("upperBound")
        try:
            lo = -math.inf if lo_raw is None else float(lo_raw)
            hi = math.inf if hi_raw is None else float(hi_raw)
        except (TypeError, ValueError) as e:
            raise ValueError(
                f"feature name [{name}] term [{term}]: bounds must be "
                f"numbers or null, got {lo_raw!r}/{hi_raw!r}"
            ) from e
        if lo == -math.inf and hi == math.inf:
            raise ValueError(
                f"feature name [{name}] term [{term}]: at least one of "
                "lowerBound/upperBound must be finite"
            )
        if not lo < hi:
            raise ValueError(
                f"feature name [{name}] term [{term}]: lower bound {lo} "
                f"must be less than upper bound {hi}"
            )

        if name == WILDCARD:
            if term != WILDCARD:
                raise ValueError(
                    "wildcard in feature name alone is not supported; a "
                    "wildcard name requires a wildcard term"
                )
            for key, idx in key_to_index.items():
                if key != INTERCEPT_KEY:
                    constraint_map[idx] = (lo, hi)
        elif term == WILDCARD:
            prefix = name + INTERSECT
            for key, idx in key_to_index.items():
                if key.startswith(prefix):
                    put(idx, name, key[len(prefix):], lo, hi)
        else:
            idx = key_to_index.get(feature_key(name, term))
            if idx is not None:
                put(idx, name, term, lo, hi)
    return constraint_map


def bounds_arrays(
    constraint_map: Mapping[int, tuple[float, float]],
    num_features: int,
    dtype=np.float64,
) -> tuple[np.ndarray, np.ndarray] | tuple[None, None]:
    """Constraint map → dense (lower, upper) arrays for ``OptimizerConfig``
    (∓∞ where unconstrained); (None, None) when the map is empty."""
    if not constraint_map:
        return None, None
    lower = np.full(num_features, -np.inf, dtype=dtype)
    upper = np.full(num_features, np.inf, dtype=dtype)
    for idx, (lo, hi) in constraint_map.items():
        if not 0 <= idx < num_features:
            raise ValueError(f"constrained feature index {idx} out of range")
        lower[idx] = lo
        upper[idx] = hi
    return lower, upper
