"""The host's wait in its blocking reads of the card as a share of a fit's
wall, in %: over the sites of ``host_syncs_per_fit``, the waits the port
times while its telemetry is on (``obs.host_sync``) over the step's host
wall, median over the untraced fits of ``port_bench/telemetry.py``."""

import statistics

from port_bench import telemetry


def read(name, ctx):
    m = telemetry.measured(ctx)
    if m is None:
        return None
    pcts = [100.0 * f["wait_s"] / f["wall_s"] for f in m["fits"]
            if f["wall_s"] and f["wait_s"] is not None]
    return statistics.median(pcts) if pcts else None
