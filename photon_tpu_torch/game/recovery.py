"""Supervised auto-resume: classify a failed fit, restart it from its
checkpoint.

Counterpart of photon_tpu/game/recovery.py. The restart loop composes
the recovery pieces: sweep checkpoints with retention and integrity
fallback (game/checkpoint.py), the transient classifier
(util/retry.py) and the divergence signal of the health check
(obs/health.py).

Failure taxonomy (``classify_failure``):

``transient``
    The message carries a transient transport marker
    (``UNAVAILABLE``/``DEADLINE_EXCEEDED``), or the error is a
    non-permanent ``OSError``. A restart is expected to succeed.
``divergent``
    :class:`~photon_tpu_torch.obs.health.DivergenceError`: a coordinate
    went non-finite at a sweep boundary. Restartable: the
    checkpoint predates the poisoned sweep (descent raises before its
    sweep callback), and descent is deterministic from states, so a
    transient corruption recovers on replay while a deterministic one
    recurs until ``max_restarts`` runs out.
``load_shed``
    A serving-side shed: :class:`~photon_tpu_torch.serve.admission.
    ServeSheddingError` (``AdmissionRejected`` / ``DeadlineExceeded``).
    The engine did what its admission policy promised under overload; a
    restart would offer the same load to the same card. Never retried.
``rollback``
    A hot-swap validation failure: :class:`~photon_tpu_torch.serve.
    registry.SwapValidationError`. The swap rolled back and the previous
    model never stopped serving. Never retried.
``fatal``
    Everything else — shape and config errors, out-of-memory, a
    checkpoint corrupt beyond fallback. Never retried.

``run_with_recovery`` restarts the supervised callable up to
``max_restarts`` times with capped jittered-exponential backoff. The
callable picks up its own durable progress on re-entry:
``GameEstimator.fit(checkpoint_dir=...)`` resumes from the newest valid
snapshot. Each decision is counted, with the JAX package's names:
``recovery.failures.<kind>`` and a ``recovery.failure`` event per
classified failure, ``recovery.restarts`` and ``recovery.restart`` per
restart granted, ``recovery.giveup`` when the budget runs out and
``recovery.recovered`` when a restarted fit succeeds.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable

from photon_tpu_torch import obs
from photon_tpu_torch.obs.health import DivergenceError
from photon_tpu_torch.util.retry import (
    RetryPolicy,
    is_transient,
    is_transient_io,
    jitter_rng,
)

__all__ = [
    "classify_failure",
    "max_restarts_from_env",
    "run_with_recovery",
]

logger = logging.getLogger(__name__)

#: default restart backoff: a quick first retry, doubling to a 5-minute cap
DEFAULT_RESTART_POLICY = RetryPolicy(
    attempts=1, base_s=2.0, multiplier=2.0, cap_s=300.0, jitter=0.1
)


def classify_failure(exc: BaseException) -> str:
    """``"transient"`` | ``"divergent"`` | ``"load_shed"`` | ``"rollback"``
    | ``"fatal"`` — see the module docstring. Only ``transient`` and
    ``divergent`` earn restart fuel."""
    # deferred: the serve package pulls in the scorer, which a bare
    # training-side import of this module does not need
    from photon_tpu_torch.serve.admission import ServeSheddingError
    from photon_tpu_torch.serve.registry import SwapValidationError

    if isinstance(exc, ServeSheddingError):
        return "load_shed"
    if isinstance(exc, SwapValidationError):
        return "rollback"
    if isinstance(exc, DivergenceError):
        return "divergent"
    if is_transient(exc) or is_transient_io(exc):
        return "transient"
    return "fatal"


def max_restarts_from_env(value: int | None = None) -> int:
    """Supervised restart budget: ``PHOTON_MAX_RESTARTS`` > ``value`` >
    0 (supervision off)."""
    env = os.environ.get("PHOTON_MAX_RESTARTS", "").strip()
    if env:
        v = int(env)
    elif value is not None:
        v = int(value)
    else:
        return 0
    if v < 0:
        raise ValueError(f"max restarts must be >= 0, got {v}")
    return v


def run_with_recovery(
    fn: Callable,
    *,
    max_restarts: int,
    sleep: Callable[[float], None] = time.sleep,
    on_restart: Callable[[int, BaseException], None] | None = None,
):
    """Run ``fn()`` under restart supervision.

    Up to ``max_restarts`` restarts are spent on failures classified
    ``transient`` or ``divergent``, each after a wait of
    ``DEFAULT_RESTART_POLICY``; ``fatal`` failures and an exhausted
    budget re-raise the original error. ``on_restart(restart_index,
    exc)`` fires before each restart's backoff."""
    if max_restarts < 0:
        raise ValueError(f"max_restarts={max_restarts} < 0")
    restarts = 0
    while True:
        try:
            result = fn()
        except Exception as e:
            kind = classify_failure(e)
            obs.counter(f"recovery.failures.{kind}")
            obs.instant("recovery.failure", cat="lifecycle", label="fit", kind=kind,
                        error=f"{type(e).__name__}: {e}", restarts_used=restarts)
            if kind not in ("transient", "divergent"):
                logger.error("fit failed with a %s error; not restarting: %s", kind, e)
                raise
            if restarts >= max_restarts:
                obs.counter("recovery.giveup")
                obs.instant("recovery.giveup", cat="lifecycle", label="fit", kind=kind,
                            restarts_used=restarts)
                logger.error(
                    "fit failed (%s) after exhausting %d restart(s): %s",
                    kind, max_restarts, e,
                )
                raise
            wait = DEFAULT_RESTART_POLICY.wait_s(restarts, jitter_rng())
            restarts += 1
            obs.counter("recovery.restarts")
            obs.instant("recovery.restart", cat="lifecycle", label="fit", kind=kind,
                        restart=restarts, wait_s=round(wait, 3),
                        error=f"{type(e).__name__}: {e}")
            logger.warning(
                "fit failed with a %s error; restart %d/%d in %.1fs: %s",
                kind, restarts, max_restarts, wait, e,
            )
            if on_restart is not None:
                on_restart(restarts, e)
            sleep(wait)
            continue
        if restarts:
            obs.counter("recovery.recovered")
            obs.instant("recovery.recovered", cat="lifecycle", label="fit",
                        restarts_used=restarts)
            logger.info("fit recovered after %d restart(s)", restarts)
        return result
