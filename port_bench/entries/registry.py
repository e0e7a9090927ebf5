"""The port's registry counters that it counts whether or not telemetry
is on (``obs.tally``), read by name. Like ``game_fit``, this file imports
the port."""
from __future__ import annotations


def counters(*names: str) -> dict | None:
    """``{name: count}`` of every name, or None where the port counts one
    of them not at all (a port without the counter, or a run that never
    passed it)."""
    from photon_tpu_torch import obs

    have = obs.get_registry().snapshot()["counters"]
    if any(n not in have for n in names):
        return None
    return {n: have[n] for n in names}
