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
``fatal``
    Everything else — shape and config errors, out-of-memory, a
    checkpoint corrupt beyond fallback. Never retried.

The JAX package also knows the serving kinds ``load_shed`` and
``rollback``; they belong to its serving engine, which the port does not
have yet.

``run_with_recovery`` restarts the supervised callable up to
``max_restarts`` times with capped jittered-exponential backoff. The
callable picks up its own durable progress on re-entry:
``GameEstimator.fit(checkpoint_dir=...)`` resumes from the newest valid
snapshot. The JAX package counts each decision in its metrics registry;
here each is a log line.
"""
from __future__ import annotations

import logging
import os
import time
from typing import Callable

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
    """``"transient"`` | ``"divergent"`` | ``"fatal"`` — see the module
    docstring."""
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
            if kind == "fatal":
                logger.error("fit failed with a fatal error; not restarting: %s", e)
                raise
            if restarts >= max_restarts:
                logger.error(
                    "fit failed (%s) after exhausting %d restart(s): %s",
                    kind, max_restarts, e,
                )
                raise
            wait = DEFAULT_RESTART_POLICY.wait_s(restarts, jitter_rng())
            restarts += 1
            logger.warning(
                "fit failed with a %s error; restart %d/%d in %.1fs: %s",
                kind, restarts, max_restarts, wait, e,
            )
            if on_restart is not None:
                on_restart(restarts, e)
            sleep(wait)
            continue
        if restarts:
            logger.info("fit recovered after %d restart(s)", restarts)
        return result
