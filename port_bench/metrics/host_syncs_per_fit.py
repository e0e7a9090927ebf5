"""The host's blocking reads of the card in one whole fit: the median over
the run's measured fits (the harness's traced step and the port-telemetry
fits of ``port_bench/telemetry.py``) of the port's sync counter
(``obs.host_sync``) summed over the sites an untraced fit passes (all but
``descent.coordinate_barrier`` and ``optimize.counters``), from the
descent's sweep rows. A count: it repeats exactly from fit to fit."""

from port_bench import telemetry


def read(name, ctx):
    return telemetry.median_fit(ctx, "syncs")
