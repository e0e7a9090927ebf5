"""``python -m photon_tpu_torch.analysis``: the port's lint gate.

Walks every module of the port, runs the PHL rules, applies the inline
annotations and the reviewed baseline, and exits non-zero on anything
NEW (exit 1) or on STALE baseline entries (exit 2): both mean the code
and the allowlist have drifted apart. ``--jsonl`` writes every finding
(the suppressed ones too, with their status) as one JSON object per line.
The flags are those of the JAX package's gate (photon_tpu/analysis/
cli.py).

``--programs`` adds the program checks: a small fixed effect + random
effect fit with the warm-up on (``GameEstimator(precompile=True)``) on
``--device`` (the card unless ``--device cpu``), on a mesh: the ranks of
an initialized ``torch.distributed`` group with every rank on the entity
axis, as JAX's gate puts its devices, else a world of one. Its warm-up
program table is printed (``--breakdown-jsonl`` writes its rows), its
solve-shape census is held to the shape budget (analysis/shapes.py), and
the mesh's communication census is printed, held to each coordinate's
``spmd_contract()`` and written into the ``--jsonl`` rows
(``"engine": "spmd"``, ``"kind": "comm-census"``), with the placement
check of the sharding contract (analysis/spmd.py).
"""
from __future__ import annotations

import argparse
import json
import sys
from collections import Counter
from pathlib import Path
from typing import Any, Sequence

from photon_tpu_torch.analysis.baseline import (
    BaselineEntry,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from photon_tpu_torch.analysis.core import all_rules, analyze_tree

#: default note stamped on --write-baseline entries; reviewers replace it
#: with the actual justification during sign-off
_TODO_NOTE = "reviewed: intentional site (replace with justification)"


def _find_root(start: Path) -> Path:
    """The scan root: the nearest ancestor holding photon_tpu_torch/."""
    cur = start.resolve()
    for cand in (cur, *cur.parents):
        if (cand / "photon_tpu_torch").is_dir():
            return cand
    return cur


def build_estimator_fixture(device="cuda", mesh=None):
    """A small fixed effect + random effect ``GameEstimator`` fit on
    ``device`` (or on ``mesh``) with the warm-up on and two sweeps; returns
    the estimator, which keeps the coordinates it built
    (``last_coordinates``) and the warm-up's report
    (``last_fit_stats["precompile"]``)."""
    import numpy as np
    import torch

    from photon_tpu_torch.game.config import (
        FixedEffectCoordinateConfig,
        RandomEffectCoordinateConfig,
    )
    from photon_tpu_torch.game.data import CSRMatrix, GameData
    from photon_tpu_torch.game.estimator import GameEstimator
    from photon_tpu_torch.optimize.common import OptimizerConfig
    from photon_tpu_torch.optimize.problem import (
        GLMProblemConfig,
        RegularizationContext,
        RegularizationType,
    )
    from photon_tpu_torch.types import TaskType

    rng = np.random.default_rng(7)
    n, fe_dim, users, d_re = 256, 16, 24, 6
    ids = rng.integers(0, users, size=n)
    data = GameData.build(
        labels=(rng.uniform(size=n) < 0.5).astype(np.float64),
        feature_shards={
            "global": CSRMatrix.from_dense(rng.normal(size=(n, fe_dim)).astype(np.float32)),
            "per_user": CSRMatrix.from_dense(rng.normal(size=(n, d_re)).astype(np.float32)),
        },
        id_tags={"userId": [f"u{i}" for i in ids]},
    )
    opt = GLMProblemConfig(
        task=TaskType.LOGISTIC_REGRESSION,
        optimizer_config=OptimizerConfig(max_iterations=3),
        regularization=RegularizationContext(RegularizationType.L2),
    )
    est = GameEstimator(
        task=TaskType.LOGISTIC_REGRESSION,
        coordinate_configs={
            "global": FixedEffectCoordinateConfig(
                feature_shard="global", optimization=opt, regularization_weights=(1.0,)),
            "per_user": RandomEffectCoordinateConfig(
                random_effect_type="userId", feature_shard="per_user",
                optimization=opt, regularization_weights=(1.0,)),
        },
        update_sequence=["global", "per_user"],
        descent_iterations=2,
        dtype=torch.float64,
        device=device,
        precompile=True,
        keep_coordinates=True,
    )
    est.fit(data, mesh=mesh)
    return est


def fixture_mesh(device):
    """The mesh of the fixture fit: every rank of an initialized group on
    the entity axis, else a world of one (``make_mesh`` starts it)."""
    import torch.distributed as dist

    from photon_tpu_torch.parallel.mesh import make_mesh

    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    return make_mesh(1, world, device=device)


def print_census_table(rows: list[dict[str, Any]]) -> None:
    header = ("program", "calls", "sites", "bytes", "comm_bytes", "ops")
    cells = [(r["program"], str(r["calls"]), str(len(r["collective_sites"])), str(r["bytes"]),
              str(r["comm_bytes"]),
              ",".join(sorted({s["op"] for s in r["collective_sites"]})) or "-") for r in rows]
    widths = [max(len(header[i]), *(len(c[i]) for c in cells)) if cells else len(header[i])
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print("[photon-lint] communication census of the fixture fit (per coordinate and program):")
    print("  " + fmt.format(*header))
    for c in cells:
        print("  " + fmt.format(*c))


def breakdown_rows(report: dict) -> list[dict[str, Any]]:
    """The warm-up's per-program rows, as data."""
    return [{"program": p["program"], "wall_s": p["wall_s"],
             "backend_compile_s": p["backend_compile_s"]} for p in report["programs"]]


def print_program_table(rows: list[dict[str, Any]]) -> None:
    header = ("program", "wall_s", "backend_compile_s")
    cells = [(r["program"], f"{r['wall_s']:.4f}", f"{r['backend_compile_s']:.4f}") for r in rows]
    widths = [max(len(header[i]), *(len(c[i]) for c in cells)) if cells else len(header[i])
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    print("[photon-lint] warm-up programs of the fixture fit:")
    print("  " + fmt.format(*header))
    for c in cells:
        print("  " + fmt.format(*c))


def run_program_checks(jsonl_rows: list[dict[str, Any]],
                       breakdown_out: list[dict[str, Any]] | None = None,
                       device="cuda") -> int:
    from photon_tpu_torch.analysis import spmd
    from photon_tpu_torch.analysis.shapes import check_shape_budget, solve_shape_census
    from photon_tpu_torch.game.data import re_shape_budget
    from photon_tpu_torch.parallel.mesh import destroy_mesh

    mesh = fixture_mesh(device)
    try:
        try:
            est = build_estimator_fixture(mesh.device, mesh)
        except Exception as e:  # the gate reports a broken fixture as a failure
            print(f"[photon-lint] ERROR: the estimator fixture failed to fit: "
                  f"{type(e).__name__}: {e}")
            return 1
        report = est.last_fit_stats["precompile"]
        coordinates = est.last_coordinates or {}
        comm = spmd.communication_census(mesh.census)
        placement = spmd.check_placement(coordinates, mesh)
        contract = spmd.check_contracts(coordinates, mesh.census)
        dims = "x".join(map(str, mesh.dims))
    finally:
        destroy_mesh(mesh)
    rows = breakdown_rows(report)
    census = solve_shape_census(coordinates)
    print(f"[photon-lint] program checks: {report['n_programs']} warmed programs, "
          f"{len(census)} distinct solve shapes, mesh={dims}, "
          f"{sum(r['calls'] for r in comm)} collectives at {sum(len(r['collective_sites']) for r in comm)} sites")
    print_program_table(rows)
    print_census_table(comm)
    if breakdown_out is not None:
        breakdown_out.extend(rows)
    for row in comm:
        # the row's program kind stays in its "program" (<cid>:<kind>)
        jsonl_rows.append({"engine": "spmd", **row, "kind": "comm-census"})
    findings = check_shape_budget(coordinates, re_shape_budget(None))
    for pf in findings:
        print(f"  {pf.render()}")
        jsonl_rows.append({"engine": "shapes", **pf.to_json()})
    for pf in contract + placement:
        print(f"  {pf.render()}")
        jsonl_rows.append({"engine": "spmd", **pf.to_json()})
    if report["n_programs"] == 0:
        print("[photon-lint] ERROR: the warm-up warmed no program")
        return 1
    if not census:
        print("[photon-lint] ERROR: the fixture's random effect contributed no solve shape")
        return 1
    if not comm:
        print("[photon-lint] ERROR: the meshed fixture fit made no counted collective: the "
              "census proved nothing")
        return 1
    return 1 if findings or contract or placement else 0


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m photon_tpu_torch.analysis",
        description="photon-lint for the PyTorch port: host/device discipline static analysis",
    )
    parser.add_argument(
        "paths", nargs="*",
        help="files/dirs to scan (default: photon_tpu_torch/ under --root)",
    )
    parser.add_argument(
        "--root", type=Path, default=None,
        help="scan root (default: nearest ancestor of cwd with photon_tpu_torch/)",
    )
    parser.add_argument(
        "--baseline", type=Path, default=None,
        help="allowlist file (default: <root>/photon_tpu_torch/analysis/baseline.toml)",
    )
    parser.add_argument("--jsonl", type=Path, default=None,
                        help="write every finding as JSONL to this path")
    parser.add_argument(
        "--breakdown-jsonl", type=Path, default=None,
        help="with --programs: also write the warm-up's per-program rows as JSONL",
    )
    parser.add_argument("--rules", default=None,
                        help="comma-separated rule ids to run (default: all)")
    parser.add_argument(
        "--write-baseline", action="store_true",
        help="rewrite the baseline from current unsuppressed findings (requires review: "
        "every entry is a sign-off)",
    )
    parser.add_argument("--list-rules", action="store_true", help="print the rule catalog")
    parser.add_argument(
        "--programs", action="store_true",
        help="also fit a small fixture with the warm-up on: print its program table and "
        "check its solve-shape census against the shape budget (imports torch)",
    )
    parser.add_argument("--device", default="cuda",
                        help="with --programs: the fixture fit's device (default: cuda)")
    parser.add_argument("--show-allowed", action="store_true",
                        help="also print baseline/annotated findings")
    args = parser.parse_args(argv)

    rules = all_rules()
    if args.list_rules:
        for r in rules:
            scope = "hot-path modules" if r.hot_path_only else "whole tree"
            print(f"{r.rule_id}  [{scope}]  {r.title}")
        return 0
    if args.rules:
        wanted = {r.strip().upper() for r in args.rules.split(",")}
        unknown = wanted - {r.rule_id for r in rules}
        if unknown:
            parser.error(f"unknown rule id(s): {sorted(unknown)}")
        rules = [r for r in rules if r.rule_id in wanted]

    root = (args.root if args.root is not None else _find_root(Path.cwd())).resolve()
    baseline_path = (args.baseline if args.baseline is not None
                     else root / "photon_tpu_torch" / "analysis" / "baseline.toml")
    files = None
    if args.paths:
        files = []
        for p in args.paths:
            p = Path(p).resolve()
            if p.is_dir():
                files.extend(f for f in sorted(p.rglob("*.py")) if "__pycache__" not in f.parts)
            else:
                files.append(p)

    findings = analyze_tree(root, files, rules=rules)

    if args.write_baseline:
        if args.paths or args.rules:
            # a partial scan sees a subset of findings: rewriting the whole
            # allowlist from it would drop every entry outside the subset
            parser.error("--write-baseline requires a full default scan; drop the explicit "
                         "paths / --rules filter")
        entries = {
            BaselineEntry(rule=f.rule, path=f.path, snippet=f.snippet, note=_TODO_NOTE)
            for f in findings
            # PHL000 (parse failure) is an analyzer error, never an
            # intentional site: baselining it would blind every rule to it
            if f.status != "annotated" and f.rule != "PHL000"
        }
        write_baseline(baseline_path, entries)
        print(f"[photon-lint] wrote {len(entries)} entries to {baseline_path}: review the "
              "diff before committing")
        return 0

    entries = load_baseline(baseline_path)
    if files is not None:
        # partial scan: staleness is only decidable for files analyzed
        scanned = {f.resolve().relative_to(root).as_posix()
                   for f in files if f.resolve().is_relative_to(root)}
        entries = [e for e in entries if e.path in scanned]
    gate = apply_baseline(findings, entries)

    jsonl_rows = [{"engine": "ast", **f.to_json()}
                  for f in [*gate.new, *gate.allowed, *gate.annotated]]
    for f in gate.new:
        print(f.render())
    if args.show_allowed:
        for f in [*gate.allowed, *gate.annotated]:
            print(f"[{f.status}] {f.render()}")
    for e in gate.stale:
        print(f"STALE baseline entry (no matching finding): {e.render()}")

    rc = 1 if gate.new else 2 if gate.stale else 0

    if args.programs:
        from photon_tpu_torch.types import resolve_device

        try:
            device = resolve_device(args.device)
        except (RuntimeError, ValueError) as e:
            parser.error(f"--programs: {e}")
        bd_rows: list[dict[str, Any]] = []
        rc = rc or run_program_checks(jsonl_rows, breakdown_out=bd_rows, device=device)
        if args.breakdown_jsonl:
            args.breakdown_jsonl.parent.mkdir(parents=True, exist_ok=True)
            with open(args.breakdown_jsonl, "w", encoding="utf-8") as fh:
                for row in bd_rows:
                    fh.write(json.dumps(row) + "\n")
            print(f"[photon-lint] wrote {len(bd_rows)} warm-up program rows to "
                  f"{args.breakdown_jsonl}")

    if args.jsonl:
        args.jsonl.parent.mkdir(parents=True, exist_ok=True)
        with open(args.jsonl, "w", encoding="utf-8") as fh:
            for row in jsonl_rows:
                fh.write(json.dumps(row) + "\n")

    counts = Counter(f.rule for f in gate.new)
    summary = ", ".join(f"{r}×{n}" for r, n in sorted(counts.items())) if counts else "none"
    print(
        f"[photon-lint] scanned under {root}: new findings: {summary}; "
        f"{len(gate.allowed)} baseline-allowed, {len(gate.annotated)} annotated, "
        f"{len(gate.stale)} stale baseline entries "
        f"-> {'PASS' if rc == 0 else f'FAIL (exit {rc})'}"
    )
    return rc


if __name__ == "__main__":  # pragma: no cover
    sys.exit(main())
