"""``coord_launches.<coordinate>``: the kernels that one traced fit
launched inside that coordinate's ``descent.coordinate`` spans (both
sweeps), each kernel joined to its launch by correlation id and the
launch to the port's span by time and thread (``port_bench/spans.py``),
in the profiled fit of ``port_bench/telemetry.py``. The initial score's
and the barriers' kernels fall outside every coordinate."""

from port_bench import telemetry


def read(name, ctx):
    m = telemetry.measured(ctx)
    if m is None or "coordinates" not in m:
        return None
    return m["coordinates"].get(name.split(".", 1)[1], {}).get("launches", 0)
