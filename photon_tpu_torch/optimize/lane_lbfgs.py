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
"""
from __future__ import annotations

import ctypes
import os

import torch

from photon_tpu_torch.optimize.common import OptimizeResult
from photon_tpu_torch.optimize.problem import GLMProblem, RegularizationType
from photon_tpu_torch.types import OptimizerType

#: the kernel's caps (kMaxDim, kMaxCorrections, kMaxRows in csrc/lane_lbfgs.cu)
MAX_DIM, MAX_CORRECTIONS, MAX_ROWS = 64, 32, 4096
#: value types the kernel takes (it sums in float64 for both)
KERNEL_DTYPES = (torch.float32, torch.float64)
#: loss codes of the kernel, by ``PointwiseLoss.name``
LOSS_CODES = {"logistic": 0, "squared": 1, "poisson": 2, "smoothed_hinge": 3}


def solver_reason(problem: GLMProblem) -> str | None:
    """What in ``problem`` itself keeps its solves on the plain loop,
    whatever their data, or None: the kernels of ``csrc/lane_lbfgs.cu``
    compute L-BFGS (or L-BFGS-B without bounds) with L2 or no
    regularization, no box, no normalization, on the margin line search.
    Both dispatch rules, this module's and ``solo_lbfgs``'s, ask it first."""
    cfg = problem.config
    norm = problem.objective.normalization
    if os.environ.get("PHOTON_GLM_LINESEARCH", "margin").strip().lower() == "full":
        return "full line search"
    if cfg.optimizer not in (OptimizerType.LBFGS, OptimizerType.LBFGSB):
        return f"optimizer {cfg.optimizer.value}"
    if cfg.regularization.regularization_type not in (RegularizationType.NONE,
                                                      RegularizationType.L2):
        return f"regularization {cfg.regularization.regularization_type.value}"
    if cfg.optimizer_config.has_box:
        return "box bounds"
    if norm.shifts is not None or norm.factors is not None:
        return "normalization"
    return None


def plain_loop_reason(problem: GLMProblem, features: torch.Tensor) -> str | None:
    """Why a lane solve of ``problem`` over ``features`` [B, rows, d] keeps
    the plain loop, or None when the kernel takes it: what
    :func:`solver_reason` allows, a dense float32 or float64 block within
    the caps, on a CUDA device."""
    reason = solver_reason(problem)
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


def _kernel_lib():
    from photon_tpu_torch.ops import cuda_build

    lib = cuda_build.load("lane_lbfgs")
    if lib.lane_lbfgs.argtypes is None:
        # without argtypes ctypes would pass each pointer as a 32-bit int
        i, ptr, dbl = ctypes.c_int, ctypes.c_void_p, ctypes.c_double
        lib.lane_lbfgs.restype = i
        lib.lane_lbfgs.argtypes = (
            [i] + [ptr] * 15 + [ctypes.c_longlong] + [i] * 6 + [dbl] * 4 + [ptr]
        )
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"lane_lbfgs: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lane_lbfgs: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if t.device != device:
        raise ValueError(f"lane_lbfgs: {name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"lane_lbfgs: {name} must be contiguous")


def minimize_lanes(problem: GLMProblem, batch, w0: torch.Tensor) -> OptimizeResult:
    """Every lane of ``batch`` (features [B, rows, d], labels, offsets and
    weights [B, rows]) solved from ``w0`` [B, d] by the kernel, one launch
    on the current stream, no sync. Raises on a solve the kernel does not
    take (:func:`plain_loop_reason`) and on a row vector or ``w0`` of
    another type, shape or device than the features, or not contiguous."""
    reason = plain_loop_reason(problem, batch.features)
    if reason is not None:
        raise ValueError(f"lane_lbfgs does not take this solve: {reason}")
    f = batch.features
    dev, dtype = f.device, f.dtype
    b, rows, d = f.shape
    _check("features", f, dtype, (b, rows, d), dev)
    for name in ("labels", "offsets", "weights"):
        _check(name, getattr(batch, name), dtype, (b, rows), dev)
    _check("w0", w0, dtype, (b, d), dev)
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
    lib = _kernel_lib()
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
    minimize_lanes.launches += 1
    return res


#: kernel launches through the wrapper (one per solve)
minimize_lanes.launches = 0
