"""Block timing (reference photon-lib util/Timed.scala, used around every
pipeline phase, e.g. GameTrainingDriver.scala:346-466).

Copy of photon_tpu/util/timed.py without the telemetry span (the port
has no tracer yet)."""
from __future__ import annotations

import functools
import logging
import time
from typing import Callable, TypeVar

logger = logging.getLogger("photon_tpu_torch")

T = TypeVar("T")


class Timed:
    """Context manager that logs wall-clock for a named phase.

    >>> with Timed("train"):
    ...     ...

    The elapsed seconds are available as ``.elapsed_s`` after exit.
    """

    def __init__(self, name: str, log: logging.Logger | None = None):
        self.name = name
        self.log = log or logger
        self.elapsed_s: float | None = None

    def __enter__(self) -> "Timed":
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.elapsed_s = time.perf_counter() - self._t0
        status = "failed after" if exc_type else "took"
        self.log.info("%s %s %.3f s", self.name, status, self.elapsed_s)


def timed(name: str | None = None) -> Callable[[Callable[..., T]], Callable[..., T]]:
    """Decorator form of :class:`Timed`."""

    def deco(fn: Callable[..., T]) -> Callable[..., T]:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args, **kwargs) -> T:
            with Timed(label):
                return fn(*args, **kwargs)

        return wrapper

    return deco
