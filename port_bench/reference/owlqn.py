"""OWL-QN for an elastic-net logistic GLM in plain PyTorch: the plain
reference of the single-GLM cells.

The objective is Photon-ML's: F(x) = Σᵢ wᵢ·l(zᵢ, yᵢ) + l2/2·‖x‖² +
l1·‖x‖₁ with margins zᵢ = xᵢ·x + offsetᵢ, and its elastic net gives
l1 = α·λ and l2 = (1 − α)·λ. The solver is OWL-QN (Andrew and Gao,
"Scalable training of L1-regularized log-linear models", ICML 2007), as
Breeze's ``OWLQN`` runs it for Photon-ML:

- the pseudo-gradient ◇F: ∇f + l1·sign(x) off zero; at zero the one-sided
  derivative that descends, else 0;
- the L-BFGS two-loop direction over the last ``m`` pairs applied to ◇F,
  scaled by s·y / y·y of the newest pair, its components that do not
  descend along ◇F set to 0 (orthant alignment);
- the orthant ξ: sign(x), or sign(−◇F) where x is 0;
- a backtracking line search: each trial projects x + a·d onto ξ (a
  component that leaves it is 0) and is accepted when F falls by at least
  c1·◇F·(x' − x); a is halved after each failed trial;
- the pairs (s, y) from the smooth part's gradients, a pair kept when
  s·y > 1e-10.

Departures from the published algorithm, each the rule that Photon-ML's
optimizer (and the port) runs:

- the first trial step is min(1, 1/‖◇F‖) while no pair is held, then 1
  (Breeze starts the first iteration at 0.5/‖◇F‖ and shrinks it by 0.1);
- a line search fails after ``max_trials`` halvings, which stops the
  solve, where the paper's search has no cap;
- the stopping rules are Photon-ML's, in this order: the iteration cap, a
  failed line search, |ΔF| at most ``tolerance``·|F(0)|, ‖◇F‖ at most
  ``tolerance``·‖◇F(0)‖; the paper stops on the mean relative change of F
  over the last five iterations.

It runs one problem, in the type it is given (float64 for the reference,
bfloat16 for the control), with no kernel and no batching over lanes.
Nothing here imports the port.
"""
from __future__ import annotations

import torch

from port_bench.reference.glm import LOSSES, SparseRows

Tensor = torch.Tensor
PAIR_EPS = 1e-10

# stop reasons (Photon-ML's ConvergenceReason)
RUNNING, MAX_ITERATIONS, VALUE_CONVERGED, GRADIENT_CONVERGED, NOT_IMPROVING = 0, 1, 2, 3, 4


def sparse_rows(indptr, indices, values, labels, dim: int, *, dtype, device,
                weights=None) -> SparseRows:
    """CSR host arrays as ``SparseRows`` ([N, K] column ids and values,
    each row padded to the longest with column 0 and value 0), laid out on
    ``device`` from the CSR alone."""

    def put(a, dt):
        return torch.as_tensor(a).to(device=device, dtype=dt)

    ptr = put(indptr, torch.int64)
    n = ptr.shape[0] - 1
    per_row = ptr[1:] - ptr[:-1]
    k = int(per_row.max()) if n else 0
    row = torch.repeat_interleave(torch.arange(n, device=device), per_row)
    slot = torch.arange(row.shape[0], device=device) - torch.repeat_interleave(ptr[:-1], per_row)
    cols = torch.zeros((n, k), dtype=torch.int64, device=device)
    vals = torch.zeros((n, k), dtype=dtype, device=device)
    cols[row, slot] = put(indices, torch.int64)
    # the inputs are float32 for both sides, whatever the reference computes in
    vals[row, slot] = put(values, torch.float32).to(dtype)
    w = torch.ones(n, dtype=dtype, device=device) if weights is None else put(weights, dtype)
    return SparseRows(cols=cols, vals=vals, labels=put(labels, dtype), weights=w,
                      offsets=torch.zeros(n, dtype=dtype, device=device), dim=dim)


def pseudo_gradient(x: Tensor, g: Tensor, l1: float) -> Tensor:
    """◇F at x from the smooth part's gradient g."""
    at_zero = torch.where(g + l1 < 0, g + l1, torch.where(g - l1 > 0, g - l1, 0.0))
    return torch.where(x != 0, g + l1 * torch.sign(x), at_zero)


def two_loop(q: Tensor, pairs: list[tuple[Tensor, Tensor, Tensor]]) -> Tensor:
    """H·q from the pairs (s, y, 1/s·y), oldest first."""
    alphas = []
    for s, y, rho in reversed(pairs):
        a = rho * torch.dot(s, q)
        q = q - a * y
        alphas.append(a)
    if pairs:
        s, y, _ = pairs[-1]
        q = (torch.dot(s, y) / torch.dot(y, y)) * q
    for (s, y, rho), a in zip(pairs, reversed(alphas)):
        q = q + (a - rho * torch.dot(y, q)) * s
    return q


def owlqn(value_and_gradient, value, x0: Tensor, l1: float, *, max_iterations: int,
          tolerance: float, m: int = 10, max_trials: int = 25, c1: float = 1e-4) -> dict:
    """Minimize f + l1·‖x‖₁ from ``x0`` [D], with ``value_and_gradient(x)
    -> (f, ∇f)`` and ``value(x) -> f`` of the smooth part f. Returns ``x``,
    ``value`` (F), ``iterations``, ``reason``, ``trials`` and ``path``
    ([max_iterations + 1]: F from the start and after each iteration, the
    last value repeated once the solve stops)."""

    def full(f_smooth, x):
        return f_smooth + l1 * x.abs().sum()

    zero = torch.zeros_like(x0)
    f0, g0 = value_and_gradient(zero)
    value_tol = f0.abs() * tolerance
    grad_tol = torch.linalg.vector_norm(pseudo_gradient(zero, g0, l1)) * tolerance
    x = x0
    f_s, g = value_and_gradient(x)
    f = full(f_s, x)
    pairs: list[tuple[Tensor, Tensor, Tensor]] = []
    path, reason, it, trials = [f], RUNNING, 0, 0
    while reason == RUNNING:
        pg = pseudo_gradient(x, g, l1)
        d = -two_loop(pg, pairs)
        d = torch.where(d * pg < 0, d, 0.0)
        if not bool((d * d).sum() > 0):
            d = -pg
        orthant = torch.where(x != 0, torch.sign(x), torch.sign(-pg))
        step = min(1.0, 1.0 / max(float(torch.linalg.vector_norm(pg)), 1e-12)) if not pairs \
            else 1.0
        accepted = None
        for _ in range(max_trials):
            trials += 1
            cand = x + step * d
            cand = torch.where(torch.sign(cand) == orthant, cand, 0.0)
            f_cand = full(value(cand), cand)
            dx = cand - x
            if bool(f_cand <= f + c1 * torch.dot(pg, dx)) and bool(torch.dot(dx, dx) > 0):
                accepted = cand, f_cand
                break
            step *= 0.5
        it += 1
        if accepted is None:
            reason = MAX_ITERATIONS if it >= max_iterations else NOT_IMPROVING
            path.append(f)
            continue
        x_new, f_new = accepted
        _, g_new = value_and_gradient(x_new)
        s, y = x_new - x, g_new - g
        sy = torch.dot(s, y)
        if bool(sy > PAIR_EPS):
            pairs = (pairs + [(s, y, 1.0 / sy)])[-m:]
        pg_new = pseudo_gradient(x_new, g_new, l1)
        if it >= max_iterations:
            reason = MAX_ITERATIONS
        elif bool((f_new - f).abs() <= value_tol):
            reason = VALUE_CONVERGED
        elif bool(torch.linalg.vector_norm(pg_new) <= grad_tol):
            reason = GRADIENT_CONVERGED
        x, f, g = x_new, f_new, g_new
        path.append(f)
    path += [f] * (max_iterations + 1 - len(path))
    return {"x": x, "value": f, "iterations": it, "reason": reason, "trials": trials,
            "path": torch.stack(path)}


def fit(arrays: dict, spec: dict, *, device, dtype=torch.float64, fault=None) -> dict:
    """The cold elastic-net fit of ``spec`` (the configuration's ``fit``
    section) on the generator's ``arrays``. Returns host float64 arrays and
    numbers: ``path``, ``value`` (F at the end), ``x``, ``margins`` (its own
    margins at ``x``, in its type), ``iterations``, ``trials``, and the
    functions ``objective_fn(x)`` (F of any coefficients) and
    ``margins_fn(x)`` (their margins), computed in this type on the full
    data (they keep the data on the device until they are dropped).

    ``fault="half_batch"`` leaves out every odd row and doubles the weight
    of the others (a step that averages half of its batch); the functions
    still see every row."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n = len(arrays["labels"])
    weights = None
    if fault == "half_batch":
        weights = torch.ones(n, dtype=torch.float64)
        weights[1::2], weights[0::2] = 0.0, 2.0
    elif fault is not None:
        raise ValueError(f"unknown fault {fault!r}")
    rows = sparse_rows(arrays["indptr"], arrays["indices"], arrays["values"], arrays["labels"],
                       arrays["columns"], dtype=dtype, device=device, weights=weights)
    lam, alpha = spec["lambda"], spec["elastic_net_alpha"]
    l1, l2 = alpha * lam, (1.0 - alpha) * lam
    vg_b, value_b = rows.objective(LOSSES[spec["loss"]], l2)

    def value_and_gradient(x):
        f, g = vg_b(x.unsqueeze(0))
        return f[0], g[0]

    def value(x):
        return value_b(x.unsqueeze(0))[0]

    out = owlqn(value_and_gradient, value, torch.zeros(rows.dim, dtype=dtype, device=device), l1,
                max_iterations=spec["max_iterations"], tolerance=spec["tolerance"],
                m=spec["history"], max_trials=spec["line_search_trials"])
    if weights is not None:
        rows.weights = torch.ones_like(rows.weights)

    def host(t):
        return t.to("cpu", torch.float64).numpy()

    def objective_fn(x) -> float:
        x = torch.as_tensor(x).to(device, dtype)
        return float(value(x) + l1 * x.abs().sum())

    def margins_fn(x):
        return host(rows.margins(torch.as_tensor(x).to(device, dtype).unsqueeze(0))[0])

    return {"path": host(out["path"]), "value": float(out["value"]), "x": host(out["x"]),
            "margins": host(rows.margins(out["x"].unsqueeze(0))[0]),
            "iterations": out["iterations"], "trials": out["trials"],
            "objective_fn": objective_fn, "margins_fn": margins_fn}
