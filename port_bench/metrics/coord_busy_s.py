"""``coord_busy_s.<coordinate>``: the card's busy seconds of one traced fit
in that coordinate: the union of the intervals of the kernels that
``coord_launches.<coordinate>`` counts. The fit runs at sweep granularity,
so no sync per coordinate shapes it."""

from port_bench import telemetry


def read(name, ctx):
    m = telemetry.measured(ctx)
    if m is None or "coordinates" not in m:
        return None
    return m["coordinates"].get(name.split(".", 1)[1], {}).get("busy_s", 0.0)
