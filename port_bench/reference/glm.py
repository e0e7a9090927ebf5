"""GLM objectives in plain PyTorch: Photon-ML's weighted losses with an L2
term, value Σᵢ wᵢ·l(zᵢ, yᵢ) + λ/2·‖β‖² and gradient Xᵀ(wᵢ·l′(zᵢ)) + λβ,
with margins zᵢ = xᵢ·β + offsetᵢ. ``SparseRows`` holds a sparse block as
it comes from the generator, each row padded to the longest with zeros; a
random effect's rows are a dense block with the lane (entity) of every
row."""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

Tensor = torch.Tensor


def logistic(z: Tensor, y: Tensor) -> tuple[Tensor, Tensor]:
    """log(1 + e^z) − y·z and its derivative, for labels y in {0, 1}."""
    return F.softplus(z) - y * z, torch.sigmoid(z) - y


LOSSES = {"logistic": logistic}


@dataclasses.dataclass
class SparseRows:
    """A sparse block as [N, K] column ids and values, K the most entries
    of a row (the others padded with column 0 and value 0), and [N]
    labels, weights, offsets."""

    cols: Tensor
    vals: Tensor
    labels: Tensor
    weights: Tensor
    offsets: Tensor
    dim: int

    @staticmethod
    def from_csr(indptr, indices, values, labels, dim, *, dtype, device, weights=None):
        n = len(labels)
        per_row = np.diff(indptr)
        k = int(per_row.max()) if n else 0
        row = np.repeat(np.arange(n), per_row)
        slot = np.arange(len(row)) - np.repeat(indptr[:-1], per_row)
        cols = np.zeros((n, k), dtype=np.int64)
        # the inputs are float32 for both sides, whatever the reference computes in
        vals = np.zeros((n, k), dtype=np.float32)
        cols[row, slot], vals[row, slot] = indices, values

        def put(a, dt=dtype):
            return torch.as_tensor(np.asarray(a)).to(device=device, dtype=dt)

        return SparseRows(
            cols=put(cols, torch.int64), vals=put(vals),
            labels=put(labels), offsets=torch.zeros(n, dtype=dtype, device=device),
            weights=put(np.ones(n) if weights is None else weights), dim=dim,
        )

    def product(self, beta: Tensor) -> Tensor:
        """X·β: [B, N] for coefficients [B, D]."""
        return (self.vals * beta[:, self.cols]).sum(-1)

    def margins(self, beta: Tensor) -> Tensor:
        return self.product(beta) + self.offsets

    def back(self, r: Tensor) -> Tensor:
        """Xᵀr for per-row [B, N] → [B, D]."""
        out = torch.zeros((r.shape[0], self.dim), dtype=r.dtype, device=r.device)
        contrib = (self.vals * r.unsqueeze(-1)).reshape(r.shape[0], -1)
        return out.index_add_(1, self.cols.reshape(-1), contrib)

    def objective(self, loss, l2: float):
        """(value_and_gradient, value) over [B, D] coefficients."""

        def value(beta):
            lo, _ = loss(self.margins(beta), self.labels)
            return (self.weights * lo).sum(-1) + 0.5 * l2 * (beta * beta).sum(-1)

        def value_and_gradient(beta):
            lo, d1 = loss(self.margins(beta), self.labels)
            f = (self.weights * lo).sum(-1) + 0.5 * l2 * (beta * beta).sum(-1)
            return f, self.back(self.weights * d1) + l2 * beta

        return value_and_gradient, value


@dataclasses.dataclass
class LaneRows:
    """Dense rows grouped into lanes: [M, d] features, [M] lane of each row,
    labels, weights, offsets; ``lanes`` problems in all."""

    feats: Tensor
    lane: Tensor
    labels: Tensor
    weights: Tensor
    offsets: Tensor
    lanes: int

    def margins(self, beta: Tensor) -> Tensor:
        return (self.feats * beta[self.lane]).sum(-1) + self.offsets

    def objective(self, loss, l2: float):
        def value_and_gradient(beta):
            lo, d1 = loss(self.margins(beta), self.labels)
            f = torch.zeros(self.lanes, dtype=beta.dtype, device=beta.device)
            f.index_add_(0, self.lane, self.weights * lo)
            g = torch.zeros_like(beta).index_add_(
                0, self.lane, (self.weights * d1).unsqueeze(-1) * self.feats)
            return f + 0.5 * l2 * (beta * beta).sum(-1), g + l2 * beta

        return value_and_gradient
