"""The host data build of the set-up: GAME's ``last_fit_stats["build_s"]``
(data padding, the coordinates' build and placement)."""


def read(name, ctx):
    return getattr(ctx.cell, "host_build_s", None)
