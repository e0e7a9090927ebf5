"""Training lifecycle event bus (reference photon-client
event/EventEmitter.scala:24-73 — pluggable listeners notified of driver
lifecycle events such as setup, training start/finish, failure).

Copy of photon_tpu/util/events.py without the telemetry mirror (the
port has no tracer yet)."""
from __future__ import annotations

import dataclasses
import logging
from typing import Any, Callable

logger = logging.getLogger("photon_tpu_torch")


@dataclasses.dataclass(frozen=True)
class Event:
    """A lifecycle event. ``name`` examples mirror the reference's
    PhotonSetupEvent / TrainingStartEvent / TrainingFinishEvent."""

    name: str
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)


class EventListener:
    """Base listener; subclass and override :meth:`on_event`."""

    def on_event(self, event: Event) -> None:  # pragma: no cover - interface
        raise NotImplementedError

    def close(self) -> None:
        pass


class _FnListener(EventListener):
    def __init__(self, fn: Callable[[Event], None]):
        self._fn = fn

    def on_event(self, event: Event) -> None:
        self._fn(event)


class EventEmitter:
    """Registers listeners and dispatches events to all of them; a failing
    listener is logged and skipped so it can't break the training job."""

    def __init__(self):
        self._listeners: list[EventListener] = []

    def register(
        self, listener: EventListener | Callable[[Event], None]
    ) -> EventListener:
        if not isinstance(listener, EventListener):
            listener = _FnListener(listener)
        self._listeners.append(listener)
        return listener

    def emit(self, name: str, **payload: Any) -> None:
        event = Event(name=name, payload=payload)
        for listener in self._listeners:
            try:
                listener.on_event(event)
            except Exception:  # noqa: BLE001 - listener errors must not kill the job
                logger.exception("event listener failed on %s", name)

    def close(self) -> None:
        for listener in self._listeners:
            try:
                listener.close()
            except Exception:  # noqa: BLE001
                logger.exception("event listener close failed")
        self._listeners.clear()
