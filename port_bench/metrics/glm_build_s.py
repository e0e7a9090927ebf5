"""``glm_build_s.<stage>``: the set-up's single-GLM placement by stage, in
seconds: the wall of the port's ``obs.stage`` span ``glm.<stage>``
(``ell``, ``fe_windows``, ``placement``; ``data/dataset.py``), which the
entry collects with ``obs.stage_walls`` around the placement (measured
whether or not telemetry is on). None where the port has no such stage."""


def read(name, ctx):
    stages = getattr(ctx.cell, "build_stages", None) or {}
    return stages.get(f"glm.{name.split('.', 1)[1]}")
