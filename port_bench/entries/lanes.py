"""The port's count of random-effect lanes by solve path: how many lanes
``game.coordinate.solve_lanes`` gave the fused lane kernel
(``re.lanes_fused``) and how many the plain lane loop (``re.lanes_plain``)
since the process started, read from the port's metrics registry, where
they are counted whether or not telemetry is on. Like ``game_fit``, this
file imports the port."""
from __future__ import annotations


def lane_counts() -> dict | None:
    """``{"fused": n, "plain": n}``, or None where the port counts neither
    (a port without the fused kernel, or a run with no lane solve)."""
    from photon_tpu_torch import obs

    counters = obs.get_registry().snapshot()["counters"]
    if "re.lanes_fused" not in counters and "re.lanes_plain" not in counters:
        return None
    return {"fused": counters.get("re.lanes_fused", 0),
            "plain": counters.get("re.lanes_plain", 0)}
