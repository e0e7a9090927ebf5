"""GLM objective: value, gradient, margin-space line-search oracle, diag(H).

Counterpart of photon_tpu/ops/objective.py. Every function works over a
leading lane shape: a dense batch [E, N, D] with coefficients [E, D] is E
independent objectives (the random-effect solves), a batch without lanes
takes coefficients [D]. Reductions are weighted sums:

    value = Σᵢ wᵢ·l(zᵢ, yᵢ) + λ/2·‖w‖²        grad = Xᵀ(wᵢ·l′) + λw

with margins zᵢ = x·(w .* factor) + margin_shift + offsetᵢ under a
NormalizationContext. The sparse backward pass runs through the windowed
Xᵀr (ops/sparse_windows.py) when the batch carries a window layout.
"""
from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.ops.gather import take_1d
from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.ops.sparse_windows import windowed_rmatvec
from photon_tpu_torch.optimize.common import DirectionalOracle
from photon_tpu_torch.types import SparseBatch

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane dot product over the last axis."""
    return (a * b).sum(-1)


def matvec(batch, v: Tensor) -> Tensor:
    """X·v. Sparse ELL: gather the K coefficient slots per row and row-sum
    (padding slots hold value 0). Dense: a batched matrix-vector product."""
    if isinstance(batch, SparseBatch):
        return (take_1d(v, batch.indices) * batch.values).sum(-1)
    return torch.matmul(batch.features, v.unsqueeze(-1)).squeeze(-1)


def _use_windows(batch, per_row: Tensor) -> bool:
    return getattr(batch, "windows", None) is not None and per_row.dim() == 1


def rmatvec(batch, per_row: Tensor, dim: int) -> Tensor:
    """Xᵀ·per_row. Sparse with windows: the windowed kernel; sparse
    without: a flat scatter-add; dense: a batched matrix-vector product."""
    if isinstance(batch, SparseBatch):
        if _use_windows(batch, per_row):
            return windowed_rmatvec(batch.windows, per_row, dim)
        flat = (batch.values * per_row[:, None]).reshape(-1)
        out = torch.zeros(dim, dtype=flat.dtype, device=flat.device)
        return out.index_add_(0, batch.indices.reshape(-1).long(), flat)
    x = batch.features
    return torch.matmul(x.transpose(-1, -2), per_row.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    loss: PointwiseLoss
    l2_weight: float = 0.0
    normalization: NormalizationContext = NormalizationContext()

    def margins(self, coef: Tensor, batch) -> Tensor:
        eff = self.normalization.effective_coefficients(coef)
        z = matvec(batch, eff) + batch.offsets
        if self.normalization.shifts is not None:
            z = z + self.normalization.margin_shift(coef).unsqueeze(-1)
        return z

    def _back(self, per_row: Tensor, batch, dim: int) -> Tensor:
        """Xᵀ·per_row mapped back through the normalization transform."""
        g = rmatvec(batch, per_row, dim)
        if self.normalization.shifts is not None:
            g = g - per_row.sum(-1, keepdim=True) * self.normalization.shifts
        if self.normalization.factors is not None:
            g = g * self.normalization.factors
        return g

    def value(self, coef: Tensor, batch) -> Tensor:
        z = self.margins(coef, batch)
        raw = (batch.weights * self.loss.loss(z, batch.labels)).sum(-1)
        return raw + 0.5 * self.l2_weight * _dot(coef, coef)

    def value_and_gradient(self, coef: Tensor, batch) -> tuple[Tensor, Tensor]:
        return self._value_grad_margins(coef, batch)[:2]

    def _value_grad_margins(self, coef: Tensor, batch):
        """(f, g, z): one implementation for the black-box path and the
        directional oracle."""
        z = self.margins(coef, batch)
        losses, d1 = self.loss.loss_and_d1(z, batch.labels)
        value = (batch.weights * losses).sum(-1) + 0.5 * self.l2_weight * _dot(
            coef, coef
        )
        grad = (
            self._back(batch.weights * d1, batch, coef.shape[-1])
            + self.l2_weight * coef
        )
        return value, grad, z

    def directional_oracle(self, batch) -> DirectionalOracle:
        """Margin-space line-search oracle (see optimize/lbfgs.py): margins
        are affine in the step, z(x+αd) = z(x) + α·z_d, so each trial is
        O(N) elementwise and an iteration costs one forward pass (z_d) and
        one backward pass (the accepted gradient)."""

        def full(x: Tensor):
            return self._value_grad_margins(x, batch)

        def dir_setup(carry_z: Tensor, x: Tensor, d: Tensor):
            z_d = matvec(batch, self.normalization.effective_coefficients(d))
            if self.normalization.shifts is not None:
                z_d = z_d + self.normalization.margin_shift(d).unsqueeze(-1)
            xx, xd, dd = _dot(x, x), _dot(x, d), _dot(d, d)

            def phi(alpha: Tensor):
                z = carry_z + alpha.unsqueeze(-1) * z_d
                losses, d1 = self.loss.loss_and_d1(z, batch.labels)
                reg = 0.5 * self.l2_weight * (
                    xx + 2.0 * alpha * xd + alpha * alpha * dd
                )
                f = (batch.weights * losses).sum(-1) + reg
                dphi = (batch.weights * d1 * z_d).sum(-1) + self.l2_weight * (
                    xd + alpha * dd
                )
                return f, dphi, ()

            def accept(alpha: Tensor):
                z = carry_z + alpha.unsqueeze(-1) * z_d
                _, d1 = self.loss.loss_and_d1(z, batch.labels)
                g = self._back(batch.weights * d1, batch, x.shape[-1]) + (
                    self.l2_weight * (x + alpha.unsqueeze(-1) * d)
                )
                return g, z

            return phi, accept

        return DirectionalOracle(full=full, dir_setup=dir_setup)

    def hessian_diagonal(self, coef: Tensor, batch) -> Tensor:
        """diag(H) without materializing H. Sparse: Σᵢ sᵢ(xᵢⱼ−shiftⱼ)² by
        the binomial expansion; with windows, Σᵢ sᵢxᵢⱼ² is the windowed
        Xᵀs over squared stored values (the same kernel)."""
        z = self.margins(coef, batch)
        d2 = batch.weights * self.loss.d2(z, batch.labels)
        dim = coef.shape[-1]
        norm = self.normalization
        if isinstance(batch, SparseBatch):
            if _use_windows(batch, d2):
                sq_windows = batch.windows._replace(
                    vals=torch.square(batch.windows.vals)
                )
                sq = windowed_rmatvec(sq_windows, d2, dim)
                lin = (
                    windowed_rmatvec(batch.windows, d2, dim)
                    if norm.shifts is not None
                    else None
                )
            else:
                flat_idx = batch.indices.reshape(-1).long()

                def seg(v):
                    out = torch.zeros(dim, dtype=v.dtype, device=v.device)
                    return out.index_add_(0, flat_idx, (v * d2[:, None]).reshape(-1))

                sq = seg(torch.square(batch.values))
                lin = seg(batch.values) if norm.shifts is not None else None
            if norm.shifts is not None:
                sq = sq - 2.0 * norm.shifts * lin + torch.square(norm.shifts) * d2.sum()
            if norm.factors is not None:
                sq = sq * torch.square(norm.factors)
            return sq + self.l2_weight
        x = batch.features
        if norm.shifts is not None:
            x = x - norm.shifts
        if norm.factors is not None:
            x = x * norm.factors
        return (d2.unsqueeze(-1) * torch.square(x)).sum(-2) + self.l2_weight
