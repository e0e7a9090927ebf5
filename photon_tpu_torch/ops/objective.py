"""GLM objective: value, gradient, line-search oracles, Hessian products.

Counterpart of photon_tpu/ops/objective.py. Every function works over a
leading lane shape: a dense batch [E, N, D] with coefficients [E, D] is E
independent objectives (the random-effect solves), a batch without lanes
takes coefficients [D]. Reductions are weighted sums:

    value = Σᵢ wᵢ·l(zᵢ, yᵢ) + λ/2·‖w‖²        grad = Xᵀ(wᵢ·l′) + λw
    Hv    = Xᵀ(wᵢ·l″·(X v)) + λv              H    = Xᵀ diag(wᵢ·l″) X + λI

with margins zᵢ = x·(w .* factor) + margin_shift + offsetᵢ under a
NormalizationContext. The sparse backward pass runs through the windowed
Xᵀr (ops/sparse_windows.py) when the batch carries a window layout.

Every sum over rows goes through the objective's ``mesh``
(parallel/mesh.py): off a mesh (``LOCAL``) it is the sum itself; on one
the batch holds this rank's rows and the sum is an ``all_reduce`` over
the ranks: the loss sums,
the line-search derivative and Xᵀr (a windowed Xᵀr gathers the [N]
row vector and runs on this rank's instance shard,
parallel/sparse.sharded_windowed_rmatvec). Each reduced value is the
same bits on every rank, so every rank's solver takes the same steps.
"""
from __future__ import annotations

import dataclasses

import torch

from photon_tpu_torch.ops.ell_matvec import ell_matvec
from photon_tpu_torch.ops.losses import PointwiseLoss
from photon_tpu_torch.ops.normalization import NormalizationContext
from photon_tpu_torch.optimize.common import DirectionalOracle, SmoothMarginOracle
from photon_tpu_torch.parallel.mesh import LOCAL, ROW_GATHER_SITE, all_reduce_sum, gather_rows
from photon_tpu_torch.parallel.sparse import sharded_windowed_rmatvec
from photon_tpu_torch.types import SparseBatch

Tensor = torch.Tensor


def _dot(a: Tensor, b: Tensor) -> Tensor:
    """Per-lane dot product over the last axis."""
    return (a * b).sum(-1)


def bf16_product(x: Tensor, v: Tensor) -> Tensor:
    """x @ v for a bfloat16 matrix ``x`` [M, K] (a transposed view is
    fine) and a vector ``v`` [K] as JAX's ``dot_general(...,
    preferred_element_type=float32)`` computes it: ``v`` rounded to
    bfloat16, products accumulated in float32, a float32 result. On the
    card one cuBLAS GEMV with a float32 output, no widened copy of ``x``;
    on the CPU the plain version (a bf16×bf16 product is exact in
    float32, so it differs from XLA only in summation order)."""
    if x.dim() != 2:
        raise ValueError(f"a bfloat16 feature block must be [N, D], got {tuple(x.shape)}")
    vb = v.to(torch.bfloat16).unsqueeze(-1)
    if x.device.type == "cpu":
        return (x.float() @ vb.float()).squeeze(-1)
    return torch.mm(x, vb, out_dtype=torch.float32).squeeze(-1)


def matvec(batch, v: Tensor) -> Tensor:
    """X·v. Sparse ELL: the K coefficient slots of each row gathered,
    multiplied and summed (padding slots hold value 0; bfloat16 values are
    widened, as JAX's promotion does) by :func:`ops.ell_matvec.ell_matvec`,
    the CUDA kernel on the card where its rule takes the pass, else the
    plain gather and row sum. Dense: a batched matrix-vector product; a
    bfloat16 block goes through :func:`bf16_product` (float32 result)."""
    if isinstance(batch, SparseBatch):
        return ell_matvec(batch.indices, batch.values, v)
    if batch.features.dtype == torch.bfloat16:
        return bf16_product(batch.features, v)
    return torch.matmul(batch.features.to(v.dtype), v.unsqueeze(-1)).squeeze(-1)


def _use_windows(batch, per_row: Tensor) -> bool:
    return getattr(batch, "windows", None) is not None and per_row.dim() == 1


def rmatvec(batch, per_row: Tensor, dim: int, mesh=LOCAL) -> Tensor:
    """Xᵀ·per_row. Sparse with windows: the windowed kernel over this
    rank's instance shard (the whole layout off a mesh) on the whole [N]
    row vector; sparse without: a flat scatter-add; dense: a batched
    matrix-vector product (:func:`bf16_product` for a bfloat16 block).
    Under a ``mesh`` the batch is this rank's rows and the result is
    summed over the ranks."""
    if _use_windows(batch, per_row):
        return sharded_windowed_rmatvec(batch.windows, gather_rows(per_row, mesh, ROW_GATHER_SITE),
                                        dim, mesh)
    return all_reduce_sum(_rmatvec_local(batch, per_row, dim), mesh)


def _rmatvec_local(batch, per_row: Tensor, dim: int) -> Tensor:
    if isinstance(batch, SparseBatch):
        flat = (batch.values.to(per_row.dtype) * per_row[:, None]).reshape(-1)
        out = torch.zeros(dim, dtype=flat.dtype, device=flat.device)
        return out.index_add_(0, batch.indices.reshape(-1).long(), flat)
    if batch.features.dtype == torch.bfloat16:
        return bf16_product(batch.features.t(), per_row)
    x = batch.features.to(per_row.dtype)
    return torch.matmul(x.transpose(-1, -2), per_row.unsqueeze(-1)).squeeze(-1)


@dataclasses.dataclass(frozen=True)
class GLMObjective:
    """``l1_weight`` is carried for OWL-QN, which applies it through the
    pseudo-gradient; the smooth value and gradient here never include it."""

    loss: PointwiseLoss
    l2_weight: float = 0.0
    l1_weight: float = 0.0
    normalization: NormalizationContext = NormalizationContext()
    #: a mesh for a fixed-effect solve over row-sharded batches: every sum
    #: over rows is then an all_reduce over the mesh's ranks
    mesh: object = LOCAL

    def _rows(self, x: Tensor, keepdim: bool = False) -> Tensor:
        """Σ over the rows (the last axis), over every rank under a mesh."""
        return all_reduce_sum(x.sum(-1, keepdim=keepdim), self.mesh)

    def margins(self, coef: Tensor, batch) -> Tensor:
        eff = self.normalization.effective_coefficients(coef)
        z = matvec(batch, eff) + batch.offsets
        if self.normalization.shifts is not None:
            z = z + self.normalization.margin_shift(coef).unsqueeze(-1)
        return z

    def _back(self, per_row: Tensor, batch, dim: int) -> Tensor:
        """Xᵀ·per_row mapped back through the normalization transform."""
        g = rmatvec(batch, per_row, dim, mesh=self.mesh)
        if self.normalization.shifts is not None:
            g = g - self._rows(per_row, keepdim=True) * self.normalization.shifts
        if self.normalization.factors is not None:
            g = g * self.normalization.factors
        return g

    def value(self, coef: Tensor, batch) -> Tensor:
        z = self.margins(coef, batch)
        raw = self._rows(batch.weights * self.loss.loss(z, batch.labels))
        return raw + 0.5 * self.l2_weight * _dot(coef, coef)

    def gradient(self, coef: Tensor, batch) -> Tensor:
        return self.value_and_gradient(coef, batch)[1]

    def value_and_gradient(self, coef: Tensor, batch) -> tuple[Tensor, Tensor]:
        return self._value_grad_margins(coef, batch)[:2]

    def _value_grad_margins(self, coef: Tensor, batch):
        """(f, g, z): one implementation for the black-box path and the
        directional oracle."""
        z = self.margins(coef, batch)
        losses, d1 = self.loss.loss_and_d1(z, batch.labels)
        value = self._rows(batch.weights * losses) + 0.5 * self.l2_weight * _dot(
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
                f = self._rows(batch.weights * losses) + reg
                dphi = self._rows(batch.weights * d1 * z_d) + self.l2_weight * (
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

    def smooth_margin_oracle(self, batch) -> SmoothMarginOracle:
        """Value-only trial oracle for OWL-QN (optimize/owlqn.py): a trial
        is one forward pass; the backward pass runs once, on the accepted
        point's margins."""

        def value_margins(x: Tensor):
            z = self.margins(x, batch)
            f = self._rows(batch.weights * self.loss.loss(z, batch.labels))
            return f + 0.5 * self.l2_weight * _dot(x, x), z

        def grad_from_margins(x: Tensor, z: Tensor):
            _, d1 = self.loss.loss_and_d1(z, batch.labels)
            return self._back(batch.weights * d1, batch, x.shape[-1]) + self.l2_weight * x

        return SmoothMarginOracle(
            full=lambda x: self._value_grad_margins(x, batch),
            value_margins=value_margins,
            grad_from_margins=grad_from_margins,
        )

    def hessian_vector(self, coef: Tensor, v: Tensor, batch) -> Tensor:
        """H·v: one forward and one backward pass, no [D, D] memory."""
        return self.hessian_operator(coef, batch)(v)

    def hessian_operator(self, coef: Tensor, batch):
        """H(coef)·v closure with the loss curvature computed once: the
        margin pass depends on the center only, so TRON's CG steps at one
        center each cost a forward and a backward pass."""
        z = self.margins(coef, batch)
        d2w = batch.weights * self.loss.d2(z, batch.labels)
        dim = coef.shape[-1]

        def hv(v: Tensor) -> Tensor:
            xv = matvec(batch, self.normalization.effective_coefficients(v))
            if self.normalization.shifts is not None:
                xv = xv + self.normalization.margin_shift(v).unsqueeze(-1)
            return self._back(d2w * xv, batch, dim) + self.l2_weight * v

        return hv

    def hessian_matrix(self, coef: Tensor, batch) -> Tensor:
        """Dense [..., D, D] Hessian, for FULL variances at small D (a
        sparse batch is densified)."""
        z = self.margins(coef, batch)
        d2 = batch.weights * self.loss.d2(z, batch.labels)
        x = self._transformed_features(batch, coef.shape[-1]).to(coef.dtype)
        h = all_reduce_sum(torch.matmul(x.transpose(-1, -2), d2.unsqueeze(-1) * x), self.mesh)
        eye = torch.eye(coef.shape[-1], dtype=h.dtype, device=h.device)
        return h + self.l2_weight * eye

    def _transformed_features(self, batch, dim: int) -> Tensor:
        """Materialized x' = (x − shift) .* factor (dense-Hessian paths
        only, where D is small)."""
        if isinstance(batch, SparseBatch):
            n = batch.indices.shape[0]
            rows = torch.arange(n, device=batch.indices.device)[:, None].expand_as(
                batch.indices
            )
            x = torch.zeros((n, dim), dtype=batch.labels.dtype, device=batch.values.device)
            x.index_put_(
                (rows, batch.indices.long()), batch.values.to(x.dtype), accumulate=True
            )
        else:
            x = batch.features.to(batch.labels.dtype)
        if self.normalization.shifts is not None:
            x = x - self.normalization.shifts
        if self.normalization.factors is not None:
            x = x * self.normalization.factors
        return x

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
                r = gather_rows(d2, self.mesh)
                sq = sharded_windowed_rmatvec(sq_windows, r, dim, self.mesh)
                lin = (
                    sharded_windowed_rmatvec(batch.windows, r, dim, self.mesh)
                    if norm.shifts is not None
                    else None
                )
            else:
                flat_idx = batch.indices.reshape(-1).long()

                def seg(v):
                    out = torch.zeros(dim, dtype=v.dtype, device=v.device)
                    return out.index_add_(0, flat_idx, (v * d2[:, None]).reshape(-1))

                vals = batch.values.to(d2.dtype)
                sq = all_reduce_sum(seg(torch.square(vals)), self.mesh)
                lin = (all_reduce_sum(seg(vals), self.mesh)
                       if norm.shifts is not None else None)
            if norm.shifts is not None:
                sq = sq - 2.0 * norm.shifts * lin + torch.square(norm.shifts) * self._rows(d2)
            if norm.factors is not None:
                sq = sq * torch.square(norm.factors)
            return sq + self.l2_weight
        x = self._transformed_features(batch, dim)
        diag = all_reduce_sum((d2.unsqueeze(-1) * torch.square(x)).sum(-2), self.mesh)
        return diag + self.l2_weight

    def with_l2(self, l2_weight: float) -> "GLMObjective":
        return dataclasses.replace(self, l2_weight=l2_weight)

    def with_l1(self, l1_weight: float) -> "GLMObjective":
        return dataclasses.replace(self, l1_weight=l1_weight)
