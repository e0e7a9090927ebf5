"""Feature normalization as an affine transform kept out of the data path.

Counterpart of photon_tpu/ops/normalization.py: margins on raw features
use effective coefficients ``w .* factor`` plus a scalar shift
``-(w .* factor)·shift``, so the feature block is never transformed.
The intercept column has factor 1 and shift 0; shifts need an intercept.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class NormalizationContext:
    """``x' = (x - shift) .* factor``; factors/shifts are [D] tensors or
    None (identity)."""

    factors: torch.Tensor | None = None
    shifts: torch.Tensor | None = None
    intercept_index: int | None = None

    def __post_init__(self):
        if self.shifts is not None and self.intercept_index is None:
            raise ValueError("Shift without intercept is illegal.")
        if (
            self.factors is not None
            and self.shifts is not None
            and self.factors.shape != self.shifts.shape
        ):
            raise ValueError("Factors and shifts must have the same size.")

    def effective_coefficients(self, coef: torch.Tensor) -> torch.Tensor:
        if self.factors is None:
            return coef
        return coef * self.factors

    def margin_shift(self, coef: torch.Tensor) -> torch.Tensor:
        """Per-lane scalar ``-(w .* factor)·shift`` (shape coef.shape[:-1])."""
        if self.shifts is None:
            return torch.zeros(coef.shape[:-1], dtype=coef.dtype, device=coef.device)
        return -(self.effective_coefficients(coef) * self.shifts).sum(-1)
