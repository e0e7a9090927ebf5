"""Synchronization sanitizer: make an unsanctioned host sync fail loudly.

Counterpart of photon_tpu/util/sanitize.py. JAX guards its hot loops
with ``jax.transfer_guard("disallow")``; the port's counterpart is
``torch.cuda.set_sync_debug_mode("error")``, under which a call that
synchronizes the host with the card (a blocking device-to-host copy, an
``.item()``, a ``nonzero``, a stream synchronize) raises instead of
stalling the pipeline silently. ``PHOTON_SANITIZE=transfers`` (or ``1``)
turns it on around ``GameScorer.stream``'s and the serving engine's
loops; the sanctioned crossings (the staging slot's reuse wait and the
score read-back) are annotated with :func:`sanctioned_transfers`.

The sync-debug mode is process-global. The sanitizer restores the mode it
found on exit, and only guards a region whose device is a CUDA device (a
CPU run has nothing to synchronize with). The streaming scorer's
producer thread does host work only, so the mode never trips there.
"""
from __future__ import annotations

import os
import threading
from contextlib import contextmanager
from typing import Iterator

import torch

__all__ = ["sanctioned_transfers", "transfer_sanitizer", "transfers_mode"]

_MODE_ENV = "PHOTON_SANITIZE"
#: the guarded regions and sanctioned escapes open now, and the mode found
#: when the first region opened: the mode is "error" while a region is
#: open and no escape is, else the mode found (threads may nest both)
_lock = threading.Lock()
_state = {"guards": 0, "escapes": 0, "found": 0}


def transfers_mode() -> bool:
    """True when ``PHOTON_SANITIZE`` asks for the sanitizer (``transfers``
    or ``1``); read per guarded region."""
    return os.environ.get(_MODE_ENV, "").strip() in ("transfers", "1")


def _apply() -> None:
    guarded = _state["guards"] > 0 and _state["escapes"] == 0
    torch.cuda.set_sync_debug_mode("error" if guarded else _state["found"])


@contextmanager
def transfer_sanitizer(region: str, device=None) -> Iterator[None]:
    """Run ``region`` with host syncs raising when the sanitizer is on and
    ``device`` is a CUDA device; a no-op otherwise."""
    if not transfers_mode() or device is None or torch.device(device).type != "cuda":
        yield
        return
    with _lock:
        if _state["guards"] == 0 and _state["escapes"] == 0:
            _state["found"] = torch.cuda.get_sync_debug_mode()
        _state["guards"] += 1
        _apply()
    try:
        yield
    finally:
        with _lock:
            _state["guards"] -= 1
            _apply()


@contextmanager
def sanctioned_transfers(reason: str) -> Iterator[None]:
    """An annotated escape inside a sanitized region: syncs are allowed for
    exactly the ``with`` body (in every thread: the mode is global). The
    reason is mandatory."""
    if not reason or not reason.strip():
        raise ValueError(
            "sanctioned_transfers requires a reason: an unexplained escape "
            "defeats the sanitizer"
        )
    with _lock:
        active = _state["guards"] > 0
        if active:
            _state["escapes"] += 1
            _apply()
    try:
        yield
    finally:
        if active:
            with _lock:
                _state["escapes"] -= 1
                _apply()
