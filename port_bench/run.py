"""Run one cell of the port's benchmark and print its result line.

    python -m port_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, ``port_bench/``
and the port (``photon_tpu_torch/``). One process: set-up (imports, data
from the seed, the program's build and warm-up, its first step), then
whole steps until ``--seconds`` have passed, then the import guard, then
the judge (the plain reference on the same inputs, after the peak memory
has been read and the program's state freed). With ``--trace 0`` the line
carries the cell's end-to-end metrics; with ``--trace 1`` the window runs
in the program's profiling mode and a few more steps run under
``torch.profiler``, and the line carries the per-layer metrics, the device's
busy and window seconds and the trace's breakdown.

Exit codes: 0 with a result line (``correct`` may be false), 2 for an
unknown cell, 3 without enough CUDA devices, 4 when JAX or the JAX package
is loaded; no result line in those cases.
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from port_bench import importcheck, spec  # noqa: E402


@dataclasses.dataclass
class Context:
    """What the metric readers read."""

    cell: object
    setup_s: float
    window_s: float
    steps: int
    peak_bytes: int
    traced: dict | None = None
    traced_steps: int = 0


def _reader(name: str):
    return importlib.import_module(f"port_bench.metrics.{name.split('.', 1)[0]}")


def read_metrics(defs: list[dict], ctx: Context) -> dict:
    out = {}
    for m in defs:
        value = _reader(m["name"]).read(m["name"], ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def judge(cell, limits: dict) -> tuple[bool, list[dict]]:
    """The reference on the cell's inputs against the program's outputs:
    every number beside its limit (a number with no limit fails)."""
    numbers = cell.compare(cell.outputs, cell.reference())
    checks = [{"name": k, "value": v, "limit": limits.get(k)} for k, v in numbers.items()]
    ok = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks)
    return ok, checks


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t0: float | None = None) -> dict:
    """Set up, run the window, judge; the result line's object. Also the
    tests' way in (``device="cpu"``, no look for a card)."""
    import torch

    bench = spec.benchmark()
    cell_spec = spec.workload(bench, workload)
    config = spec.config(bench, cell_spec["config"])
    mix = spec.mix(cell_spec["traffic"])
    entry = importlib.import_module(f"port_bench.entries.{mix['entry']}")
    on_card = torch.device(device).type == "cuda"
    t0 = time.perf_counter() if t0 is None else t0

    cell = entry.Cell(config, mix, seed=seed, device=device)
    cell.setup()
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    w0 = time.perf_counter()
    ends = [w0]
    while True:
        cell.step(per_coordinate=trace)
        ends.append(time.perf_counter())
        if ends[-1] - w0 >= seconds:
            break
    window_s, steps = ends[-1] - w0, len(ends) - 1
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    ctx = Context(cell=cell, setup_s=setup_s, window_s=window_s, steps=steps, peak_bytes=peak)
    if trace:
        from port_bench import trace as tracing

        n = mix["traced_steps"]
        ctx.traced = tracing.capture(lambda: [cell.step() for _ in range(n)])
        ctx.traced_steps = n

    defs = spec.cell_metrics(bench, workload, "per_layer" if trace else "end_to_end")
    metrics = read_metrics(defs, ctx)
    cell.release()
    correct, checks = judge(cell, spec.limits(workload))
    name = torch.cuda.get_device_name(0) if on_card else "cpu"
    dev = {"platform": "gpu" if on_card else "cpu", "kind": name,
           "count": cell_spec["chips"], "memory_peak_bytes": int(peak)}
    line = {"correct": correct, "attempted": cell.attempted(),
            "failed": 0 if correct else cell.attempted(), "metrics": metrics, "device": dev}
    line["step_s"] = [b - a for a, b in zip(ends, ends[1:])]
    if trace and ctx.traced:
        dev["busy_s"], dev["window_s"] = ctx.traced["busy_s"], ctx.traced["window_s"]
        line["breakdown"] = {"device_ops": ctx.traced["device_ops"],
                             "idle_gaps": ctx.traced["idle_gaps"]}
    line["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]} for c in checks}
    found = importcheck.forbidden_modules()
    if found:
        raise ForbiddenModules(found)
    return line


class ForbiddenModules(RuntimeError):
    def __init__(self, found):
        super().__init__(f"loaded: {', '.join(found)}")
        self.found = found


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    try:
        cell_spec = spec.workload(spec.benchmark(), args.workload)
    except (KeyError, FileNotFoundError) as e:
        print(f"port_bench: {e}", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell_spec["chips"]:
        print(f"port_bench: {args.workload} needs {cell_spec['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        line = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=T0)
    except ForbiddenModules as e:
        print(f"port_bench: JAX or the JAX package is loaded: {', '.join(e.found)}",
              file=sys.stderr)
        return 4
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(f"correct: {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
