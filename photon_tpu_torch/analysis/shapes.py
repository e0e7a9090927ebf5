"""The solve-shape census of a built fit, against the RE shape budget.

The part of the JAX package's program checks that does not read XLA
(photon_tpu/analysis/hlo.py:218-257): every distinct (active rows, d)
shape a random-effect solve runs at is one lane-solve the card must warm
and keep, so the fit's total is bounded by the shape budget
(``game.data.re_shape_budget``). The census reads the coordinates'
buckets: ``device_buckets`` of a resident random effect, ``host_buckets``
of a streaming one (each streams chunks of its buckets' [rows, d]).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Mapping


@dataclasses.dataclass(frozen=True)
class ProgramFinding:
    """One violated program contract."""

    check: str  # "shape-budget"
    program: str  # human label, e.g. "<fit>"
    message: str

    def render(self) -> str:
        return f"[{self.check}] {self.program}: {self.message}"

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)


def solve_shape_census(coordinates: Mapping[str, Any]) -> set[tuple[int, int]]:
    """Distinct (active_rows, d) solve shapes a built fit runs, read off
    the buckets of every random-effect coordinate."""
    shapes: set[tuple[int, int]] = set()
    for coord in coordinates.values():
        buckets = (getattr(coord, "device_buckets", None) or []) + (
            getattr(coord, "host_buckets", None) or [])
        for b in buckets:
            f = b.features
            if getattr(f, "ndim", 0) == 3:  # [E, n_act, d]
                shapes.add((int(f.shape[1]), int(f.shape[2])))
    return shapes


def check_shape_budget(coordinates: Mapping[str, Any], budget: int | None) -> list[ProgramFinding]:
    """The census against the budget: the fit's distinct solve shapes must
    not exceed it (None or 0: no budget, census only)."""
    census = solve_shape_census(coordinates)
    if not budget or len(census) <= budget:
        return []
    return [ProgramFinding(
        check="shape-budget",
        program="<fit>",
        message=(
            f"{len(census)} distinct solve shapes exceed the shape budget of {budget}: "
            f"{sorted(census)}; the bucket levels (game/data.py) are bypassed or the "
            f"budget is not threaded through"
        ),
    )]
