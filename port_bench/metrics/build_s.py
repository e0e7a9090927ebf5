"""``build_s.<stage>``: the set-up's host build by stage, in seconds: the
walls of the port's stage spans summed over coordinates, from
``last_fit_stats["build_stages"]`` of the set-up's fit (measured whether or
not telemetry is on): ``shape_profile`` is ``fit.shape_profile``, the
others ``build.<stage>`` (``re_dataset``, ``fe_windows``, ``placement``)."""

SPANS = {"shape_profile": "fit.shape_profile"}


def read(name, ctx):
    est = getattr(ctx.cell, "est", None)
    stats = getattr(est, "last_fit_stats", None) or {}
    stages = stats.get("build_stages")
    if stages is None:
        return None
    part = name.split(".", 1)[1]
    return stages.get(SPANS.get(part, f"build.{part}"), 0.0)
