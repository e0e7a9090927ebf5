"""Model coefficients: means and optional variances.

Counterpart of photon_tpu/models/coefficients.py (reference
Coefficients.scala:31).
"""
from __future__ import annotations

from typing import NamedTuple

import torch


class Coefficients(NamedTuple):
    """Dense coefficient vector [D] with optional per-coefficient
    variances [D], tensors on one device."""

    means: torch.Tensor
    variances: torch.Tensor | None = None

    def compute_score(self, features: torch.Tensor) -> torch.Tensor:
        """x·w (reference Coefficients.computeScore)."""
        return torch.matmul(features, self.means)
