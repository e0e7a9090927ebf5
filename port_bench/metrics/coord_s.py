"""``coord_s.<coordinate>``: the median over the traced run's window of a
fit's seconds in that coordinate, from the descent tracker with
``tracker_granularity="coordinate"`` (each coordinate step closed by a
device sync: the program's own profiling mode)."""

import statistics


def read(name, ctx):
    cid = name.split(".", 1)[1]
    rows = [r[cid] for r in getattr(ctx.cell, "coordinate_seconds", ()) if cid in r]
    return statistics.median(rows) if rows else None
