"""Feature normalization as an affine transform kept out of the data path.

Counterpart of photon_tpu/ops/normalization.py: margins on raw features
use effective coefficients ``w .* factor`` plus a scalar shift
``-(w .* factor)·shift``, so the feature block is never transformed.
The intercept column has factor 1 and shift 0; shifts need an intercept.
Model ↔ transformed-space conversions keep the margin invariant:
``w = w' .* factor``, ``b = b' − (w' .* factor)·shift``.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from photon_tpu_torch.types import NormalizationType


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

    @property
    def is_identity(self) -> bool:
        return self.factors is None and self.shifts is None

    def to(self, device=None, dtype=None) -> "NormalizationContext":
        """The same transform with its vectors on ``device`` in ``dtype``."""

        def move(t):
            return None if t is None else t.to(device=device, dtype=dtype)

        return dataclasses.replace(self, factors=move(self.factors), shifts=move(self.shifts))

    def effective_coefficients(self, coef: torch.Tensor) -> torch.Tensor:
        if self.factors is None:
            return coef
        return coef * self.factors

    def margin_shift(self, coef: torch.Tensor) -> torch.Tensor:
        """Per-lane scalar ``-(w .* factor)·shift`` (shape coef.shape[:-1])."""
        if self.shifts is None:
            return torch.zeros(coef.shape[:-1], dtype=coef.dtype, device=coef.device)
        return -(self.effective_coefficients(coef) * self.shifts).sum(-1)

    def model_to_original_space(self, coef: torch.Tensor) -> torch.Tensor:
        """Transformed-space coefficients → original space: ``w = w' .*
        factor``, and every shift folds into the intercept (reference
        NormalizationContext.modelToOriginalSpace)."""
        out = self.effective_coefficients(coef).clone()
        if self.shifts is not None:
            out[..., self.intercept_index] -= (out * self.shifts).sum(-1)
        return out

    def model_to_transformed_space(self, coef: torch.Tensor) -> torch.Tensor:
        """Original-space coefficients → transformed space (the inverse)."""
        out = coef.clone()
        if self.shifts is not None:
            out[..., self.intercept_index] += (out * self.shifts).sum(-1)
        if self.factors is not None:
            out = out / self.factors
        return out

    @staticmethod
    def identity() -> "NormalizationContext":
        return NormalizationContext()

    @staticmethod
    def build(
        normalization_type: NormalizationType,
        *,
        mean: np.ndarray | None = None,
        variance: np.ndarray | None = None,
        max_magnitude: np.ndarray | None = None,
        intercept_index: int | None = None,
        dtype: torch.dtype = torch.float32,
    ) -> "NormalizationContext":
        """From feature statistics (host tensors; ``to`` places them):
        SCALE_WITH_STANDARD_DEVIATION factor 1/std; SCALE_WITH_MAX_MAGNITUDE
        factor 1/max|x|; STANDARDIZATION factor 1/std and shift mean (needs
        an intercept). A zero std or magnitude keeps factor 1; the
        intercept keeps factor 1 and shift 0."""
        if normalization_type == NormalizationType.NONE:
            return NormalizationContext.identity()

        def safe_inv(v: np.ndarray) -> np.ndarray:
            return np.where(v > 0.0, 1.0 / np.maximum(v, 1e-300), 1.0)

        shifts = None
        if normalization_type == NormalizationType.SCALE_WITH_STANDARD_DEVIATION:
            factors = safe_inv(np.sqrt(np.asarray(variance, dtype=np.float64)))
        elif normalization_type == NormalizationType.SCALE_WITH_MAX_MAGNITUDE:
            factors = safe_inv(np.abs(np.asarray(max_magnitude, dtype=np.float64)))
        elif normalization_type == NormalizationType.STANDARDIZATION:
            if intercept_index is None:
                raise ValueError("STANDARDIZATION requires an intercept.")
            factors = safe_inv(np.sqrt(np.asarray(variance, dtype=np.float64)))
            shifts = np.asarray(mean, dtype=np.float64).copy()
        else:
            raise ValueError(f"Unknown normalization type {normalization_type}")
        if intercept_index is not None:
            factors[intercept_index] = 1.0
            if shifts is not None:
                shifts[intercept_index] = 0.0
        return NormalizationContext(
            factors=torch.as_tensor(factors).to(dtype),
            shifts=None if shifts is None else torch.as_tensor(shifts).to(dtype),
            intercept_index=intercept_index,
        )
