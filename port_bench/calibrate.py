"""The readings the limits of ``correct`` are set from, on the chip at the
cell's own size (the benchmark's runs never run this).

    python -m port_bench.calibrate --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--fault-seeds 1,2,3] [--out file.jsonl]

For each seed: the program's set-up and one step (the window's entry),
judged against the float64 reference: the lower readings. On the control
seeds, the control in the program's place (the entry's ``control()``:
the reference computed in bfloat16). On the fault seeds, the reference with half of its
batch left out and the rest weighted double. Each reading is one JSON
line on standard output and in ``--out``.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from port_bench import spec


def _ints(text: str) -> list[int]:
    return [int(s) for s in text.split(",") if s.strip()]


def _diagnostics(cell, got, want) -> dict:
    return {"diagnostics": cell.diagnostics(got, want)} if hasattr(cell, "diagnostics") else {}


def readings(workload: str, seeds, control_seeds, fault_seeds, device="cuda", emit=print,
             dtype=None):
    bench = spec.benchmark()
    cell_spec = spec.workload(bench, workload)
    config = spec.config(bench, cell_spec["config"])
    mix = spec.mix(cell_spec["traffic"])
    entry = importlib.import_module(f"port_bench.entries.{mix['entry']}")
    for seed in seeds:
        t0 = time.perf_counter()
        cell = entry.Cell(config, mix, seed=seed, device=device)
        if dtype is not None:
            cell.dtype = dtype
        cell.setup()
        cell.step()
        cell.release()
        t1 = time.perf_counter()
        ref = cell.reference()
        ref_s = time.perf_counter() - t1
        emit({"seed": seed, "kind": "program", "dtype": str(cell.dtype),
              "readings": cell.compare(cell.outputs, ref), **_diagnostics(cell, cell.outputs, ref),
              "program_s": t1 - t0, "reference_s": ref_s})
        if seed in control_seeds:
            got, how = cell.control()
            emit({"seed": seed, "kind": "control", "how": how,
                  "readings": cell.compare(got, ref), **_diagnostics(cell, got, ref)})
        if seed in fault_seeds:
            got = cell.reference(fault="half_batch")
            emit({"seed": seed, "kind": "fault", "how": "half_batch",
                  "readings": cell.compare(got, ref), **_diagnostics(cell, got, ref)})
        del cell, ref
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, required=True)
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--out")
    p.add_argument("--program-dtype", choices=("float32", "float64"),
                   help="run the program in this type instead of the configuration's "
                        "(a witness for where a gap comes from)")
    args = p.parse_args(argv)
    out = open(args.out, "a") if args.out else None

    def emit(row):
        row = {"workload": args.workload, **row}
        print(json.dumps(row), flush=True)
        if out:
            out.write(json.dumps(row) + "\n")
            out.flush()

    try:
        readings(args.workload, args.seeds, set(args.control_seeds), set(args.fault_seeds),
                 emit=emit, dtype=getattr(torch, args.program_dtype or "", None))
    finally:
        if out:
            out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
