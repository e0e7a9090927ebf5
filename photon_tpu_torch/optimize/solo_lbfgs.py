"""The fixed effect's L-BFGS iteration on the card: a one-lane solve over
many rows in two CUDA launches an iteration.

``GLMProblem.solve`` of one lane (``w0`` of shape [D], the fixed effect
and the single GLM) with L-BFGS runs the plain loop of optimize/lbfgs.py on
the margin-space oracle, which on the card issues ~800 small kernels an
iteration: the two-loop recursion, the line search's scalar state machine
(and a host sync a trial), the pair update. ``csrc/lane_lbfgs.cu`` holds
that bookkeeping in two kernels, ``solo_head`` (pair update, convergence
test, two-loop direction: one CTA) and ``solo_search`` (the strong-Wolfe
search on the carried margins: one cooperative launch of every
co-resident CTA). The two passes over the features keep their own
kernels: z_d = X·d (``ops.objective.matvec``) and Xᵀr
(``ops.objective.rmatvec``, the windowed kernel on a windowed batch). An
iteration is then the head, one host read of "still active", the forward
pass, the search and the backward pass; the start-up evaluations and the
final exact re-evaluation are the plain loop's own.

The plain version is that loop, ``minimize_lbfgs(None, w0, cfg,
oracle=objective.directional_oracle(batch))``, which the CPU runs and the
card tests hold the kernels to, decision for decision.
:func:`plain_loop_reason` is the dispatch rule that ``GLMProblem.solve``
applies; on its path :func:`minimize_solo` launches the kernels or raises.
"""
from __future__ import annotations

import torch

from photon_tpu_torch import obs
from photon_tpu_torch.ops import cuda_build
from photon_tpu_torch.ops.objective import matvec, rmatvec
from photon_tpu_torch.optimize import lane_lbfgs
from photon_tpu_torch.optimize.common import OptimizeResult, OptimizerConfig

#: the state's scalars (enum Slot / ISlot in csrc/lane_lbfgs.cu): SLOTS
#: float64 values and ISLOTS int32 ones, some of them by name
SLOTS, ISLOTS = 16, 8
F, DPHI0, INIT = 0, 3, 4
IT, REASON, POS, PAIRS, EVALS, PASSES, TRIALS = 0, 1, 2, 3, 4, 5, 6


def plain_loop_reason(problem, batch, w0: torch.Tensor) -> str | None:
    """Why the solve of ``problem`` (a ``GLMProblem``) from ``w0`` keeps
    the plain loop, or None when the kernels take it: what
    ``problem.solver_reason()`` allows, on no mesh of more than one rank
    (a trial's sums would need an all-reduce inside the search; a world of
    one's collectives hand back their input), one lane ([D]) of float32 or
    float64 with row vectors [N], a loss of the kernels, at most
    MAX_CORRECTIONS pairs, on a CUDA device."""
    reason = problem.solver_reason()
    if reason is not None:
        return reason
    objective = problem.objective
    if objective.mesh.distributed and objective.mesh.size > 1:
        return f"a mesh of {objective.mesh.size} ranks"
    if w0.dim() != 1 or batch.labels.dim() != 1:
        return "not one lane: w0 [D] over row vectors [N]"
    if w0.dtype not in lane_lbfgs.KERNEL_DTYPES:
        return f"w0 {w0.dtype}"
    if objective.loss.name not in lane_lbfgs.LOSS_CODES:
        return f"loss {objective.loss.name}"
    m = problem.config.optimizer_config.num_corrections
    if not 1 <= m <= lane_lbfgs.MAX_CORRECTIONS:
        return f"num_corrections {m} outside 1..{lane_lbfgs.MAX_CORRECTIONS}"
    if w0.device.type != "cuda":
        return f"on {w0.device.type}"
    return None


class SoloSolve:
    """One fused solve: the start-up evaluations at construction, the
    state the kernels share on the card (x, g, d, the histories, the
    scalars ``sc``/``si``, the carried margins ``z``), which each launch
    updates in place, and the launches. :meth:`run` is the whole solve."""

    def __init__(self, objective, batch, w0: torch.Tensor, config: OptimizerConfig):
        self.objective, self.batch, self.config = objective, batch, config
        dev, dtype = w0.device, w0.dtype
        self.dtype = dtype
        d, n = w0.shape[0], batch.labels.shape[0]
        self.dim, self.rows = d, n
        m, t = config.num_corrections, config.max_iterations
        self.labels = batch.labels.to(dtype).contiguous()
        self.weights = batch.weights.to(dtype).contiguous()
        for name in ("labels", "weights"):
            cuda_build.check_tensor("solo_lbfgs", name, getattr(self, name), dtype, (n,), dev)
        self.loss = lane_lbfgs.LOSS_CODES[objective.loss.name]
        self.lib = lane_lbfgs.kernel_library()
        grid = self.lib.solo_search_grid(self._f64, n)
        if grid < 1:
            raise RuntimeError(f"solo_lbfgs: no cooperative grid on {dev}: cudaError {-grid}")
        self.grid = grid

        def empty(*shape, dt=dtype):
            return torch.empty(shape, dtype=dt, device=dev)

        self.x, self.g, self.d, self.q = empty(d), empty(d), empty(d), empty(d)
        self.s_hist, self.y_hist, self.rho = empty(m, d), empty(m, d), empty(m)
        self.loss_hist, self.gnorm_hist = empty(t + 1), empty(t + 1)
        self.sc = torch.zeros(SLOTS, dtype=torch.float64, device=dev)
        self.si = torch.zeros(ISLOTS, dtype=torch.int32, device=dev)
        self.z, self.u = empty(n), empty(n)
        self.partials = empty(4 * grid, dt=torch.float64)
        self.zd = self.xtr = None

        # the plain loop's start: the tolerances from the zero state, then x0
        self.full = objective.directional_oracle(batch).full
        f_zero, g_zero, _ = self.eval_at(torch.zeros_like(w0))
        self.loss_tol = torch.abs(f_zero) * config.tolerance
        self.grad_tol = torch.linalg.vector_norm(g_zero) * config.tolerance
        self.f0, g0, z0 = self.eval_at(w0)
        self.x.copy_(w0)
        self.g.copy_(g0)
        self.z.copy_(z0)

    @property
    def _f64(self) -> int:
        return 1 if self.dtype == torch.float64 else 0

    def eval_at(self, x: torch.Tensor):
        f, g, z = self.full(x)
        return f.to(self.dtype), g.to(self.dtype), z

    def _stream(self) -> int:
        return torch.cuda.current_stream(self.x.device).cuda_stream

    def head(self, first: bool = False) -> None:
        """The iteration's head (``first``: the solve's, from w0 and the
        start-up evaluation)."""
        xtr = self.g if first else self.xtr  # read only past the first
        cfg = self.config
        with torch.cuda.device(self.x.device):
            rc = self.lib.solo_head(
                self._f64, xtr.data_ptr(), self.x.data_ptr(), self.g.data_ptr(),
                self.d.data_ptr(), self.s_hist.data_ptr(), self.y_hist.data_ptr(),
                self.rho.data_ptr(), self.loss_hist.data_ptr(), self.gnorm_hist.data_ptr(),
                self.f0.data_ptr(), self.loss_tol.data_ptr(), self.grad_tol.data_ptr(),
                self.q.data_ptr(), self.sc.data_ptr(), self.si.data_ptr(), self.dim,
                cfg.num_corrections, cfg.max_iterations, 1 if first else 0,
                self.objective.l2_weight, self._stream(),
            )
        if rc != 0:
            raise RuntimeError(f"solo_head kernel launch failed: cudaError {rc}")
        cuda_build.count_launch("solo_head")

    def search(self) -> None:
        """The margin search along ``self.zd``: the margins move to the
        accepted step, ``self.u`` is w·loss′ there."""
        cfg = self.config
        with torch.cuda.device(self.x.device):
            rc = self.lib.solo_search(
                self._f64, self.z.data_ptr(), self.zd.data_ptr(), self.labels.data_ptr(),
                self.weights.data_ptr(), self.u.data_ptr(), self.partials.data_ptr(), self.grid,
                self.sc.data_ptr(), self.si.data_ptr(), self.rows, cfg.ls_max_iterations,
                self.loss, cfg.ls_c1, cfg.ls_c2, self.objective.l2_weight, self._stream(),
            )
        if rc != 0:
            raise RuntimeError(f"solo_search kernel launch failed: cudaError {rc}")
        cuda_build.count_launch("solo_search")

    def forward(self) -> None:
        """z_d = X·d of the head's direction."""
        self.zd = matvec(self.batch, self.d).to(self.dtype).contiguous()

    def backward(self) -> None:
        """Xᵀ(w·loss′) at the accepted margins, for the next head."""
        xtr = rmatvec(self.batch, self.u, self.dim, mesh=self.objective.mesh)
        self.xtr = xtr.to(self.dtype).contiguous()

    def run(self) -> OptimizeResult:
        t = self.config.max_iterations
        self.head(first=True)
        for k in range(t):
            if k > 0:
                self.head()
            with obs.host_sync("lbfgs.iteration"):
                # phl-ok: PHL002 one sync per iteration on 'still active': the loop's trip count is the data's
                running = int(self.si[REASON]) == 0
            if not running:
                break
            self.forward()
            with obs.span("lbfgs.linesearch", cat="solver"):
                self.search()
            self.backward()
        else:
            if t > 0:  # the last step's pair, histories and stopping reason
                self.head()

        # the carried margins drift with iteration count; one exact
        # re-evaluation at the final point bounds what callers see
        x = self.x.clone()
        f, g, _ = self.eval_at(x)
        counts = self.si
        it = counts[IT].clone()
        idx = torch.arange(t + 1, device=x.device)
        before = idx < it
        n_evals = counts[EVALS] + 1
        return OptimizeResult(
            x=x, value=f, gradient=g, iterations=it, reason=counts[REASON].clone(),
            loss_history=torch.where(before, self.loss_hist, f),
            grad_norm_history=torch.where(before, self.gnorm_hist,
                                          torch.linalg.vector_norm(g)),
            n_evals=n_evals, n_hvp=torch.zeros_like(n_evals),
            n_feature_passes=counts[PASSES] + 2,
        )


def minimize_solo(problem, batch, w0: torch.Tensor, objective=None) -> OptimizeResult:
    """The L-BFGS solve of ``problem`` (a ``GLMProblem``) over ``batch``
    from ``w0`` [D] on the kernels: every field of the plain loop's
    :class:`OptimizeResult`, with its counts (4 feature passes at the
    start, 2 an iteration, 2 at the end). ``objective``: the problem's
    objective at another λ (``GLMProblem.objective_for_weight``). The span
    ``lbfgs.solve``, each search ``lbfgs.linesearch`` and each
    iteration's read the sync site ``lbfgs.iteration``, as in the plain
    loop. Raises on a solve the kernels do not take
    (:func:`plain_loop_reason`) and on row vectors of another length or
    device than the labels'."""
    reason = plain_loop_reason(problem, batch, w0)
    if reason is not None:
        raise ValueError(f"solo_lbfgs does not take this solve: {reason}")
    objective = problem.objective if objective is None else objective
    with obs.span("lbfgs.solve", cat="solver", lanes=1, d=w0.shape[-1]):
        return SoloSolve(objective, batch, w0, problem.config.optimizer_config).run()
