"""The run's result line, its import guard and its refusals, on the CPU."""
from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from port_bench import importcheck, run, spec

ROOT = Path(__file__).resolve().parents[2]


def test_import_guard_compares_whole_top_level_names():
    loaded = ["jax", "jax.numpy", "jaxlib.xla_client", "flax", "photon_tpu",
              "photon_tpu.ops.objective", "photon_tpu_torch", "photon_tpu_torch.ops",
              "jaxtyping", "flaxen", "numpy"]
    assert importcheck.forbidden_modules(loaded) == [
        "flax", "jax", "jax.numpy", "jaxlib.xla_client", "photon_tpu",
        "photon_tpu.ops.objective"]
    assert importcheck.forbidden_modules(["photon_tpu_torch.game.descent"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import port_bench.run, port_bench.calibrate, port_bench.trace\n"
        "import port_bench.entries.game_fit\n"
        "import photon_tpu_torch.game, photon_tpu_torch.game.descent\n"
        "from port_bench import importcheck, run, spec\n"
        "for m in spec.benchmark()['end_to_end'] + spec.benchmark()['per_layer']:\n"
        "    run._reader(m['name'])\n"
        "assert importcheck.forbidden_modules() == [], importcheck.forbidden_modules()\n"
    )
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300)


LINE_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _names(kind, cell):
    return {m["name"] for m in spec.cell_metrics(spec.benchmark(), cell, kind)}


def test_the_line_of_an_untraced_run(small_cells):
    line = run.run_cell("game_ctr_scale.fit", 2**31 + 7, 0.2, False, device="cpu")
    assert list(line)[:5] == LINE_KEYS and list(line)[-1] == "checks"
    assert set(line["metrics"]) == _names("end_to_end", "game_ctr_scale.fit")
    assert all(set(m) == {"value", "unit"} for m in line["metrics"].values())
    assert line["attempted"] >= 1 and isinstance(line["correct"], bool)
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_the_line_of_a_traced_run(small_cells, monkeypatch):
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    line = run.run_cell("game_ctr_scale.fit", 5, 0.2, True, device="cpu")
    assert list(line)[-1] == "checks" and "breakdown" in line
    want = _names("per_layer", "game_ctr_scale.fit")
    # no device on the CPU: the kernel's roofline has nothing to read
    assert set(line["metrics"]) == want - {"windowed_rmatvec_roofline"}
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    assert all(len(v) <= 10 for v in line["breakdown"].values())


def test_main_refuses_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert run.main(["--workload", "game_ctr_scale.fit", "--seed", "1", "--seconds", "1"]) == 3
    assert capsys.readouterr().out == ""
    assert run.main(["--workload", "nope", "--seed", "1", "--seconds", "1"]) == 2
    assert capsys.readouterr().out == ""


def test_a_directory_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "port_bench", tmp_path / "port_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run(
        [sys.executable, "-m", "port_bench.run", "--workload", "game_ctr_scale.fit",
         "--seed", "1", "--seconds", "1"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300, env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout == ""


def test_every_cell_finds_its_files():
    bench = spec.benchmark()
    for w in bench["workloads"]:
        cfg = spec.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        mix = spec.mix(w["traffic"])
        assert (spec.HERE / "entries" / f"{mix['entry']}.py").is_file()
        assert spec.limits(w["name"]), w["name"]
