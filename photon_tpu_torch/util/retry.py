"""Transient-failure retry: capped jittered-exponential backoff.

Counterpart of photon_tpu/util/retry.py, and the classifier contract the
recovery loop (game/recovery.py) uses:

* every retry loop has an ATTEMPT CAP — an uncapped loop turns a
  permanent failure into a silent hang;
* non-transient errors re-raise IMMEDIATELY — retrying a shape error or
  an out-of-memory error only delays the real traceback.

Backoff is jittered exponential with a cap: ``wait = min(cap,
base·mult^k)`` scaled by ``1 ± jitter``. Jitter randomizes wall time
only and cannot touch numerics.

``retry_call`` runs one call under a policy; the Avro reader (per part
file, ``io.decode``), the score shard flush (``io.shard_flush``) and the
streaming scorer's per-batch requeue (``scoring.batch``) use it. The JAX
package's ``retry.*`` counters are log lines here (ROADMAP A5).
"""
from __future__ import annotations

import dataclasses
import errno
import logging
import random
import time
from typing import Callable

__all__ = [
    "IO_RETRY_POLICY",
    "RetryPolicy",
    "TRANSIENT_MARKERS",
    "is_transient",
    "is_transient_io",
    "jitter_rng",
    "retry_call",
]

logger = logging.getLogger(__name__)

#: error-message markers of transient device or transport failures
TRANSIENT_MARKERS = ("UNAVAILABLE", "DEADLINE_EXCEEDED", "Unavailable")

#: OSError subclasses that are NEVER transient: retrying a missing file
#: or a permission error three times just triples the time to the real
#: traceback
_PERMANENT_OS_ERRORS = (
    FileNotFoundError,
    IsADirectoryError,
    NotADirectoryError,
    PermissionError,
)

#: errno values that are structurally permanent even though their
#: OSError has no dedicated subclass: a full disk, a read-only or
#: over-quota filesystem does not heal inside a retry window — burning
#: attempts (and supervised restarts) on them is the anti-pattern this
#: module exists to prevent
_PERMANENT_ERRNOS = frozenset(
    {errno.ENOSPC, errno.EROFS, errno.EDQUOT, errno.EFBIG, errno.ENAMETOOLONG}
)


def is_transient(exc: BaseException) -> bool:
    """Transient DEVICE/TRANSPORT failure: the error message carries one
    of the transient status markers. Everything else (shape errors,
    out-of-memory, ...) is permanent."""
    msg = str(exc)
    return any(m in msg for m in TRANSIENT_MARKERS)


def is_transient_io(exc: BaseException) -> bool:
    """Transient I/O failure: an OSError that is not structurally
    permanent (missing file, permission, full/read-only disk), or a
    transport-transient error."""
    if isinstance(exc, _PERMANENT_OS_ERRORS):
        return False
    if isinstance(exc, OSError) and exc.errno in _PERMANENT_ERRNOS:
        return False
    return isinstance(exc, OSError) or is_transient(exc)


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Capped jittered-exponential backoff schedule.

    ``wait(k)`` for the k-th retry (0-based) is
    ``min(cap_s, base_s · multiplier^k)`` scaled by a uniform factor in
    ``[1 - jitter, 1 + jitter]``.
    """

    attempts: int = 3
    base_s: float = 1.0
    multiplier: float = 2.0
    cap_s: float = 60.0
    jitter: float = 0.1

    def __post_init__(self):
        if self.attempts < 1:
            raise ValueError(f"attempts={self.attempts} < 1")
        if not 0.0 <= self.jitter < 1.0:
            raise ValueError(f"jitter={self.jitter} not in [0, 1)")

    def wait_s(self, retry_index: int, rng: random.Random) -> float:
        base = min(self.cap_s, self.base_s * self.multiplier**retry_index)
        if self.jitter == 0.0 or base == 0.0:
            return base
        return base * rng.uniform(1.0 - self.jitter, 1.0 + self.jitter)


#: module RNG for jitter — wall-time randomization only, never numerics
_jitter_rng = random.Random()


def jitter_rng() -> random.Random:
    """The shared backoff-jitter RNG — the public handle other retry
    consumers (game/recovery.py) pass to :meth:`RetryPolicy.wait_s`."""
    return _jitter_rng


#: I/O retries: reads are idempotent, and a score shard flush rewrites
#: its whole file
IO_RETRY_POLICY = RetryPolicy(attempts=3, base_s=0.5, cap_s=15.0)


def retry_call(
    fn: Callable,
    *,
    policy: RetryPolicy = RetryPolicy(),
    classify: Callable[[BaseException], bool] = is_transient,
    label: str = "",
    sleep: Callable[[float], None] = time.sleep,
):
    """``fn()``, retrying the failures ``classify`` calls transient, at most
    ``policy.attempts`` attempts in all with the policy's waits between
    them. A failure that is not transient propagates at once; the last
    transient one propagates when the attempts run out."""
    last: BaseException | None = None
    where = f" in {label}" if label else ""
    for attempt in range(policy.attempts):
        try:
            return fn()
        except Exception as e:
            if not classify(e):
                raise
            last = e
            if attempt + 1 < policy.attempts:
                wait = policy.wait_s(attempt, _jitter_rng)
                logger.warning(
                    "transient failure%s (attempt %d/%d), retrying in %.1fs: %s",
                    where, attempt + 1, policy.attempts, wait,
                    str(e).splitlines()[0][:200] if str(e) else type(e).__name__,
                )
                sleep(wait)
    logger.warning("transient failure%s: %d attempts exhausted", where, policy.attempts)
    raise last
