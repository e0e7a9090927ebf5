"""The lane-batched L-BFGS solve of a random-effect bucket in one CUDA launch.

``csrc/lane_lbfgs.cu`` runs the whole solve of every lane of a dense
bucket [B, rows, d] (one CTA a lane) and writes every field of the
:class:`OptimizeResult` the plain loop returns. The plain version is that
loop: ``GLMProblem.solve`` on the same batch, i.e. ``minimize_lbfgs`` with
the margin-space oracle (optimize/lbfgs.py, optimize/linesearch.py,
ops/objective.py), which the CPU runs and the card tests hold the kernel
to, decision for decision. :func:`plain_loop_reason` is the dispatch rule
that ``game.coordinate.solve_lanes`` applies: the kernel takes a solve
exactly when it returns None. On that path :func:`minimize_lanes`
launches the kernel or raises.
It also loads the library for ``solo_lbfgs``. Both dispatch sites,
``solve_lanes`` and ``GLMProblem.solve``, record every L-BFGS solve they
route with ``ops.cuda_build.record_route``; :data:`routes` and
:func:`record_route` here are that record, re-exported for its readers.
"""
from __future__ import annotations

import torch

from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.cuda_build import ROUTE_TALLIES, record_route, routes  # noqa: F401
from photon_tpu_torch.optimize.common import OptimizeResult

#: the kernel's caps (kMaxDim, kMaxCorrections, kMaxRows in csrc/lane_lbfgs.cu)
MAX_DIM, MAX_CORRECTIONS, MAX_ROWS = 64, 32, 4096
#: value types the kernel takes (it sums in float64 for both)
KERNEL_DTYPES = (torch.float32, torch.float64)
#: loss codes of the kernel, by ``PointwiseLoss.name``
LOSS_CODES = {"logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}

def plain_loop_reason(problem, features: torch.Tensor) -> str | None:
    """Why a lane solve of ``problem`` (a ``GLMProblem``) over ``features``
    [B, rows, d] keeps the plain loop, or None when the kernel takes it:
    what ``problem.solver_reason()`` allows, a dense float32 or float64
    block within the caps, on a CUDA device."""
    reason = problem.solver_reason()
    if reason is not None:
        return reason
    opt = problem.config.optimizer_config
    if features.layout != torch.strided or features.dim() != 3:
        return "features not a dense [lanes, rows, d] block"
    if features.dtype not in KERNEL_DTYPES:
        return f"features {features.dtype}"
    _, rows, d = features.shape
    if not 1 <= d <= MAX_DIM:
        return f"d {d} outside 1..{MAX_DIM}"
    if not 1 <= opt.num_corrections <= MAX_CORRECTIONS:
        return f"num_corrections {opt.num_corrections} outside 1..{MAX_CORRECTIONS}"
    if rows > MAX_ROWS:
        return f"rows {rows} > {MAX_ROWS}"
    if features.device.type != "cuda":
        return f"on {features.device.type}"
    return None


def kernel_library():
    """The loaded ``csrc/lane_lbfgs.cu`` (its entries declared), built on
    first use."""
    return cuda_build.load("lane_lbfgs")


def minimize_lanes(problem, batch, w0: torch.Tensor) -> OptimizeResult:
    """Every lane of ``batch`` (features [B, rows, d], labels, offsets and
    weights [B, rows]) of ``problem`` (a ``GLMProblem``) solved from ``w0``
    [B, d] by the kernel, one launch on the current stream, no sync. Raises on a solve the kernel does not
    take (:func:`plain_loop_reason`) and on a row vector or ``w0`` of
    another type, shape or device than the features, or not contiguous."""
    reason = plain_loop_reason(problem, batch.features)
    if reason is not None:
        raise ValueError(f"lane_lbfgs does not take this solve: {reason}")
    f = batch.features
    dev, dtype = f.device, f.dtype
    b, rows, d = f.shape
    cuda_build.check_tensor("lane_lbfgs", "features", f, dtype, (b, rows, d), dev)
    for name in ("labels", "offsets", "weights"):
        cuda_build.check_tensor("lane_lbfgs", name, getattr(batch, name), dtype, (b, rows), dev)
    cuda_build.check_tensor("lane_lbfgs", "w0", w0, dtype, (b, d), dev)
    cfg = problem.config.optimizer_config
    m, t = cfg.num_corrections, cfg.max_iterations
    loss = LOSS_CODES[problem.objective.loss.name]

    def empty(*shape, dt=dtype):
        return torch.empty(shape, dtype=dt, device=dev)

    i32 = torch.int32
    res = OptimizeResult(
        x=empty(b, d), value=empty(b), gradient=empty(b, d),
        iterations=empty(b, dt=i32), reason=empty(b, dt=i32),
        loss_history=empty(b, t + 1), grad_norm_history=empty(b, t + 1),
        n_evals=empty(b, dt=i32), n_hvp=empty(b, dt=i32), n_feature_passes=empty(b, dt=i32),
    )
    if b == 0:
        return res
    lib = kernel_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lane_lbfgs(
            1 if dtype == torch.float64 else 0,
            f.data_ptr(), batch.labels.data_ptr(), batch.offsets.data_ptr(),
            batch.weights.data_ptr(), w0.data_ptr(),
            *(v.data_ptr() for v in res),
            b, rows, d, m, t, cfg.ls_max_iterations, loss,
            cfg.tolerance, cfg.ls_c1, cfg.ls_c2, problem.objective.l2_weight, stream,
        )
    if rc != 0:
        raise RuntimeError(f"lane_lbfgs kernel launch failed: cudaError {rc}")
    cuda_build.count_launch("lane_lbfgs")
    return res
