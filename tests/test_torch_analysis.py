"""photon-lint for the port (photon_tpu_torch/analysis): the rules, the
gate, the baseline, the site matcher and the solve-shape census.

- every ported rule fires on a planted bug and stays silent on the
  sanctioned pattern; for PHL003, PHL004, PHL006, PHL009 and PHL010 the
  JAX package's fixtures (tests/fixtures/phl) go through both engines and
  give the same (rule, line, col) findings;
- PHL001 and PHL002 in torch's forms: each escape route of a numpy view,
  each sync form, the annotation and the hot-path scope;
- the baseline's round trip, its stale entries, and its refusal of PHL000
  and of partial scans; the CLI's exit codes, ``--jsonl`` and ``--rules``;
- the committed port passes its own gate with no stale baseline entry,
  and fails it when an unannotated ``bool(t.any())`` lands in
  optimize/lbfgs.py;
- ``solve_shape_census`` equals JAX's ``hlo.solve_shape_census`` on the
  same built coordinates, and the warm-up's solves cover exactly it.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from photon_tpu.analysis import analyze_source as j_analyze_source
from photon_tpu.analysis import hlo as jhlo
from photon_tpu.game import data as jdata
from photon_tpu.game.estimator import GameEstimator as JEstimator
from photon_tpu.types import TaskType as JTask
from photon_tpu_torch.analysis import analyze_source, analyze_tree, match_sites, statement_span
from photon_tpu_torch.analysis.baseline import (
    BaselineEntry,
    apply_baseline,
    load_baseline,
    write_baseline,
)
from photon_tpu_torch.analysis.cli import main
from photon_tpu_torch.analysis.core import default_scan_files, is_hot_path
from photon_tpu_torch.analysis.shapes import check_shape_budget, solve_shape_census
from photon_tpu_torch.game import coordinate as tcoord
from photon_tpu_torch.game import data as tdata
from photon_tpu_torch.game.descent import precompile_coordinates
from photon_tpu_torch.game.estimator import GameEstimator
from photon_tpu_torch.types import TaskType as TTask
from test_torch_game import UPDATE, _arrays, _game_data, _jax_configs, _torch_configs

REPO = Path(__file__).resolve().parents[1]
JAX_FIXTURES = REPO / "tests" / "fixtures" / "phl"
BASELINE = REPO / "photon_tpu_torch" / "analysis" / "baseline.toml"
SHARED_RULES = ("PHL003", "PHL004", "PHL006", "PHL009", "PHL010")


def _new(src: str, rule: str, path="x.py", hot=True):
    return [f for f in analyze_source(src, path, hot=hot) if f.rule == rule and f.status == "new"]


# --- torch forms of PHL001 and PHL002 -----------------------------------------

PHL001_BAD = '''import numpy as np
import torch


class Snapshots:
    def keep(self, t):
        self.last = t.numpy()

    def keep_many(self, ts):
        self.by_name["a"] = np.asarray(ts[0])


def returned(t):
    return t.numpy()


def handed_over(t, callback):
    callback([t.numpy()])


def yielded(ts):
    for t in ts:
        yield np.asarray(t)


def requested_view(t):
    return np.asarray(t, copy=False)[:4]
'''

PHL001_GOOD = '''import numpy as np
import torch


def copies(t, callback):
    callback(t.numpy().copy())
    callback(np.array(t))
    callback(np.asarray(t, copy=True))
    callback(t.clone().numpy().copy())
    return float(t.numpy().sum())


def local(t):
    view = t.numpy()
    return view.shape
'''

PHL002_BAD = '''import numpy as np
import torch

_HOST = torch.device("cpu")


def sweep(x, stream, event):
    a = x.item()
    b = x.tolist()
    c = x.cpu()
    d = x.numpy().copy()
    e = x.to("cpu")
    f = x.to(_HOST, torch.float64)
    g = x.to(device="cpu")
    h = float(x.sum())
    i = int(x.argmax())
    j = bool(x.any())
    k = np.asarray(x)
    torch.cuda.synchronize()
    stream.synchronize()
    event.synchronize()
    if x.any():
        pass
    while not x.all():
        break
    m = torch.as_tensor(np.ones(3)).to(x.device)
    n = torch.from_numpy(np.ones(3)).cuda()
    o = torch.tensor([1.0], device=x.device)
    return a, b, c, d, e, f, g, h, i, j, k, m, n, o
'''

PHL002_GOOD = '''import numpy as np
import torch


def sweep(x, device, dtype):
    y = x.to(device)
    z = x.to(torch.float64)
    flag = x.any()
    n = float(1.0) + int("3") + bool(0)
    m = torch.where(flag, x, y)
    p = torch.as_tensor(np.ones(3)).to(device, non_blocking=True)
    q = torch.from_numpy(np.ones(3)).to(dtype)
    r = torch.as_tensor(np.ones(3), dtype=torch.float64)
    s = torch.full((), 0.5, device=device)
    return y, z, m, n, x.sum(), p, q, r, s
'''

TORCH_FIXTURES = {
    "PHL001": (PHL001_BAD, PHL001_GOOD),
    "PHL002": (PHL002_BAD, PHL002_GOOD),
}


@pytest.mark.parametrize("rule", ["PHL001", "PHL002", *SHARED_RULES])
def test_rule_fires_on_positive_fixture(rule):
    src = (TORCH_FIXTURES[rule][0] if rule in TORCH_FIXTURES
           else (JAX_FIXTURES / f"{rule.lower()}_bad.py").read_text())
    assert _new(src, rule), f"{rule} missed every planted bug in its positive fixture"


@pytest.mark.parametrize("rule", ["PHL001", "PHL002", *SHARED_RULES])
def test_rule_silent_on_negative_fixture(rule):
    src = (TORCH_FIXTURES[rule][1] if rule in TORCH_FIXTURES
           else (JAX_FIXTURES / f"{rule.lower()}_good.py").read_text())
    found = _new(src, rule)
    assert not found, "\n".join(f.render() for f in found)


@pytest.mark.parametrize("kind", ["bad", "good"])
@pytest.mark.parametrize("rule", SHARED_RULES)
def test_shared_rules_equal_jax_on_its_fixtures(rule, kind):
    """The rules copied from the JAX package find the same (rule, line,
    col) on the JAX package's own fixtures as its engine does."""
    name = f"{rule.lower()}_{kind}.py"
    src = (JAX_FIXTURES / name).read_text()
    want = {(f.rule, f.line, f.col, f.status)
            for f in j_analyze_source(src, name, hot=True, mesh_scoped=True) if f.rule == rule}
    got = {(f.rule, f.line, f.col, f.status)
           for f in analyze_source(src, name, hot=True) if f.rule == rule}
    assert got == want
    assert bool(got) == (kind == "bad") or any(s != "new" for *_, s in got)


def test_phl001_catches_every_escape_route():
    found = _new(PHL001_BAD, "PHL001")
    routes = {f.message.split("(")[1].split(")")[0] for f in found}
    assert routes == {"returned", "passed to a call", "stored on an attribute",
                      "stored in an attribute container"}
    assert sorted(f.line for f in found) == [7, 10, 14, 18, 23, 27]
    # PHL001 claims its nodes: the same views are not PHL002 findings too
    assert not {f.line for f in _new(PHL001_BAD, "PHL002")} & {f.line for f in found}


def test_phl002_flags_each_torch_sync_form():
    lines = sorted(f.line for f in _new(PHL002_BAD, "PHL002"))
    # .item .tolist .cpu .numpy .to("cpu") .to(_HOST) .to(device="cpu")
    # float int bool(+.any() inside it) np.asarray cuda.synchronize
    # stream/event.synchronize, .any() and .all() as branch tests, and
    # the blocking host-to-device copies of host data
    assert lines == [8, 9, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21, 22, 24, 26, 27,
                     28]


def test_phl002_annotation_needs_a_reason_and_suppresses():
    base = "def f(active):\n    if not bool(active.any()):{}\n        return 1\n"
    bare = analyze_source(base.format("  # phl-ok: PHL002"), "x.py", hot=True)
    why = analyze_source(base.format("  # phl-ok: PHL002 per-iteration lane check"), "x.py",
                         hot=True)
    assert [f.status for f in bare if f.rule == "PHL002"] == ["new"]
    assert [f.status for f in why if f.rule == "PHL002"] == ["annotated"]
    above = "def f(t):\n    # phl-ok: PHL002 the one read-back\n    return t.item()\n"
    assert [f.status for f in analyze_source(above, "x.py", hot=True)] == ["annotated"]


def test_hot_path_scoping():
    src = "def f(x):\n    return float(x.sum())\n"
    assert _new(src, "PHL002", "photon_tpu_torch/game/descent.py", hot=None)
    assert _new(src, "PHL002", "photon_tpu_torch/game/streaming.py", hot=None)
    assert _new(src, "PHL002", "photon_tpu_torch/optimize/lbfgs.py", hot=None)
    assert not _new(src, "PHL002", "photon_tpu_torch/io/avro.py", hot=None)
    assert is_hot_path("photon_tpu_torch/game/scoring.py")
    assert not is_hot_path("photon_tpu_torch/obs/tracer.py")
    assert not is_hot_path("photon_tpu/game/descent.py")


def test_syntax_error_is_a_finding_not_a_crash():
    assert [f.rule for f in analyze_source("def broken(:\n", "x.py")] == ["PHL000"]


# --- sites reported by the card → findings ----------------------------------

SITES_SRC = '''import torch


def f(active, x):
    if not bool(
        active.any()
    ):
        return None
    vals = (torch.stack([x, x])
            .cpu()
            .tolist())
    y = x * 2
    return vals, y
'''


def test_statement_span_and_site_matching(tmp_path):
    import ast

    tree = ast.parse(SITES_SRC)
    assert statement_span(tree, 6) == (5, 7)  # a compound statement by its header
    assert statement_span(tree, 8) == (8, 8)  # the body is its own statement
    assert statement_span(tree, 10) == (9, 11)
    path = "photon_tpu_torch/optimize/fake.py"
    (tmp_path / path).parent.mkdir(parents=True)
    (tmp_path / path).write_text(SITES_SRC)
    findings = analyze_source(SITES_SRC, path)
    got = match_sites(tmp_path, [(path, 6), (path, 10), (path, 11), (path, 12)], findings)
    assert got[(path, 6)].line == 5 and got[(path, 10)].line == 9
    assert got[(path, 11)].line == 9
    assert got[(path, 12)] is None


# --- the gate: CLI semantics over a temp tree ---------------------------------


def _tree(tmp_path: Path, files: dict[str, str]) -> Path:
    for rel, src in files.items():
        p = tmp_path / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(src)
    return tmp_path


def test_cli_exit0_on_clean_tree(tmp_path, capsys):
    root = _tree(tmp_path, {"photon_tpu_torch/game/descent.py": "def f(s):\n    return s\n"})
    assert main(["--root", str(root)]) == 0
    assert "PASS" in capsys.readouterr().out


@pytest.mark.parametrize("rule,src,target", [
    ("PHL001", PHL001_BAD, "photon_tpu_torch/game/descent.py"),
    ("PHL002", PHL002_BAD, "photon_tpu_torch/game/streaming.py"),
    ("PHL003", (JAX_FIXTURES / "phl003_bad.py").read_text(), "photon_tpu_torch/game/scoring.py"),
    ("PHL004", (JAX_FIXTURES / "phl004_bad.py").read_text(), "photon_tpu_torch/io/native_avro.py"),
])
def test_cli_blocks_a_planted_bug(tmp_path, capsys, rule, src, target):
    root = _tree(tmp_path, {target: src})
    rc = main(["--root", str(root)])
    out = capsys.readouterr().out
    assert rc == 1 and rule in out


def test_cli_jsonl_artifact(tmp_path, capsys):
    root = _tree(tmp_path, {"photon_tpu_torch/io/native_avro.py":
                            (JAX_FIXTURES / "phl004_bad.py").read_text()})
    artifact = tmp_path / "out" / "findings.jsonl"
    assert main(["--root", str(root), "--jsonl", str(artifact)]) == 1
    rows = [json.loads(ln) for ln in artifact.read_text().splitlines()]
    assert rows and all(r["rule"] == "PHL004" for r in rows)
    assert {"engine", "path", "line", "snippet", "status"} <= set(rows[0])


def test_cli_rules_filter(tmp_path, capsys):
    root = _tree(tmp_path, {"photon_tpu_torch/io/native_avro.py":
                            (JAX_FIXTURES / "phl004_bad.py").read_text()})
    assert main(["--root", str(root), "--rules", "PHL006"]) == 0
    assert main(["--root", str(root), "--rules", "PHL004,PHL006"]) == 1
    with pytest.raises(SystemExit):
        main(["--root", str(root), "--rules", "PHL005"])  # not ported: jit retraces


def test_baseline_allows_and_goes_stale(tmp_path, capsys):
    root = _tree(tmp_path, {"photon_tpu_torch/util/x.py":
                            "import time\n\ndef f():\n    return time.time()\n"})
    baseline = root / "photon_tpu_torch" / "analysis" / "baseline.toml"
    write_baseline(baseline, [BaselineEntry(rule="PHL006", path="photon_tpu_torch/util/x.py",
                                            snippet="return time.time()", note="pinned")])
    assert main(["--root", str(root)]) == 0
    (root / "photon_tpu_torch/util/x.py").write_text(
        "import time\n\ndef f():\n    return time.monotonic()\n")
    assert main(["--root", str(root)]) == 2
    assert "STALE" in capsys.readouterr().out


def test_write_baseline_round_trip(tmp_path, capsys):
    root = _tree(tmp_path, {"photon_tpu_torch/util/x.py": "import time\nT0 = time.time()\n"})
    assert main(["--root", str(root)]) == 1
    assert main(["--root", str(root), "--write-baseline"]) == 0
    entries = load_baseline(root / "photon_tpu_torch/analysis/baseline.toml")
    assert [(e.rule, e.snippet) for e in entries] == [("PHL006", "T0 = time.time()")]
    assert main(["--root", str(root)]) == 0


def test_write_baseline_refuses_phl000_and_partial_scans(tmp_path, capsys):
    root = _tree(tmp_path, {"photon_tpu_torch/util/broken.py": "def broken(:\n"})
    assert main(["--root", str(root)]) == 1
    assert main(["--root", str(root), "--write-baseline"]) == 0
    assert not load_baseline(root / "photon_tpu_torch/analysis/baseline.toml")
    assert main(["--root", str(root)]) == 1
    with pytest.raises(SystemExit):
        main(["--root", str(root), "--rules", "PHL006", "--write-baseline"])


# --- the committed port -------------------------------------------------------


def test_committed_tree_passes_and_baseline_has_no_stale_entries():
    """``python -m photon_tpu_torch.analysis`` exits 0 on the port: no new
    finding, every baseline entry still matches one and carries a note."""
    findings = analyze_tree(REPO)
    entries = load_baseline(BASELINE)
    assert entries and all(e.note and "replace with" not in e.note for e in entries)
    gate = apply_baseline(findings, entries)
    assert not gate.new, "\n".join(f.render() for f in gate.new)
    assert not gate.stale, "\n".join(e.render() for e in gate.stale)
    assert main(["--root", str(REPO)]) == 0


def test_scan_covers_the_port_only():
    files = [p.relative_to(REPO).as_posix() for p in default_scan_files(REPO)]
    assert "photon_tpu_torch/game/coordinate.py" in files
    assert all(f.startswith("photon_tpu_torch/") for f in files)


def test_an_unannotated_sync_in_lbfgs_fails_the_gate(tmp_path, capsys):
    rel = "photon_tpu_torch/optimize/lbfgs.py"
    target = tmp_path / rel
    target.parent.mkdir(parents=True)
    shutil.copy(REPO / rel, target)
    argv = ["--root", str(tmp_path), "--baseline", str(BASELINE), str(target)]
    assert main(argv) == 0
    with open(target, "a") as f:
        f.write("\n\ndef _probe(t):\n    return bool(t.any())\n")
    assert main(argv) == 1
    assert "lbfgs.py" in capsys.readouterr().out


def test_programs_fixture_fit(tmp_path, capsys):
    out = tmp_path / "breakdown.jsonl"
    assert main(["--root", str(REPO), "--programs", "--device", "cpu",
                 "--breakdown-jsonl", str(out)]) == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [r["program"] for r in rows] == [
        "global:sweep", "global:score", "per_user:sweep", "per_user:score"]
    assert "warm-up programs" in capsys.readouterr().out


@pytest.mark.skipif(torch.cuda.is_available(), reason="the refusal needs a host without CUDA")
def test_programs_fit_on_the_card_unless_asked_for_the_cpu(capsys):
    # the fixture fit's device is the card by default; without one it
    # refuses instead of running on the host
    with pytest.raises(SystemExit) as exc:
        main(["--root", str(REPO), "--programs"])
    assert exc.value.code == 2
    assert "device='cpu'" in capsys.readouterr().err


# --- the solve-shape census ---------------------------------------------------


def _built(est, data):
    out = est._build_coordinates(data)
    return out[0] if isinstance(out, tuple) else out


def test_solve_shape_census_equals_jax_and_the_warm_up_covers_it(monkeypatch):
    arrays = _arrays()
    jest = JEstimator(task=JTask.LOGISTIC_REGRESSION, coordinate_configs=_jax_configs(),
                      update_sequence=UPDATE, dtype=jnp.float64)
    want = jhlo.solve_shape_census(_built(jest, _game_data(jdata, arrays)))
    test = GameEstimator(task=TTask.LOGISTIC_REGRESSION, coordinate_configs=_torch_configs(),
                         update_sequence=UPDATE, dtype=torch.float64, device="cpu")
    coords = _built(test, _game_data(tdata, arrays))
    census = solve_shape_census(coords)
    assert census == want and len(census) > 1
    solved = set()
    real = tcoord.solve_lanes

    def spy(config, features, *rest):
        solved.add((int(features.shape[1]), int(features.shape[2])))
        return real(config, features, *rest)

    monkeypatch.setattr(tcoord, "solve_lanes", spy)
    precompile_coordinates(coords)
    assert solved == census
    assert check_shape_budget(coords, len(census)) == []
    over = check_shape_budget(coords, len(census) - 1)
    assert over and "exceed the shape budget" in over[0].message
    assert check_shape_budget(coords, None) == []


def test_streamed_census_is_the_warm_up_solve_keys():
    from photon_tpu_torch.game.streaming import StreamConfig

    test = GameEstimator(task=TTask.LOGISTIC_REGRESSION, coordinate_configs={
        k: v for k, v in _torch_configs().items() if k != "fixed"},
        update_sequence=UPDATE[1:], dtype=torch.float64, device="cpu")
    coords = test._build_coordinates(_game_data(tdata, _arrays()),
                                     stream_cfg=StreamConfig(chunk_rows=256))
    keys = {key for c in coords.values() for key, label, _ in c.precompile_specs()
            if label == "stream_solve"}
    assert {(rows, d) for _, _, rows, d, _ in keys} == solve_shape_census(coords)
    assert np.all([k[1] >= 1 for k in keys])


# --- PHL007 and PHL008: the mesh rules in torch's forms --------------------------

PHL007_BAD = '''import torch


def place(x_host, mesh, device):
    a = torch.as_tensor(x_host).to(device)
    b = x_host.cuda()
    c = torch.as_tensor(x_host, device=mesh.device)
    d = x_host.to(device=device)
    e = x_host.to(torch.device("cuda", 0))
    return a, b, c, d, e
'''

PHL007_GOOD = '''import torch

from photon_tpu_torch.parallel.mesh import row_range, shard_batch


def place(x_host, batch, mesh, device, n):
    lo, hi = row_range(mesh, n)
    a = torch.as_tensor(x_host[lo:hi]).to(device)
    b = shard_batch(batch, mesh)
    c = torch.tensor([1.0], device=mesh.device)
    d = x_host.to(torch.float64)
    e = x_host.to("cpu")
    f = x_host[lo:hi].contiguous().cuda()
    g = torch.as_tensor(x_host, device="cpu")
    return a, b, c, d, e, f, g


def replicate(tree, mesh):
    return tree.to(mesh.device)
'''

PHL008_BAD = '''import torch.distributed as dist
from torch.distributed import all_gather_into_tensor


def sums(t, out, parts):
    dist.all_reduce(t)
    dist.broadcast(t, 0)
    dist.all_gather(parts, t)
    all_gather_into_tensor(out, t)
    torch.distributed.reduce_scatter_tensor(out, t)
'''

PHL008_GOOD = '''import torch.distributed as dist

from photon_tpu_torch.parallel.mesh import all_reduce_sum, gather_rows


def sums(t, mesh):
    dist.barrier()
    n = dist.get_world_size()
    return all_reduce_sum(t, mesh), gather_rows(t, mesh), n
'''

MESH_FIXTURES = {"PHL007": (PHL007_BAD, PHL007_GOOD, 5), "PHL008": (PHL008_BAD, PHL008_GOOD, 5)}


def _mesh_new(src, rule, path="photon_tpu_torch/parallel/x.py"):
    return [f for f in analyze_source(src, path) if f.rule == rule and f.status == "new"]


@pytest.mark.parametrize("rule", sorted(MESH_FIXTURES))
def test_mesh_rule_fires_on_every_planted_form(rule):
    bad, _, n = MESH_FIXTURES[rule]
    assert len(_mesh_new(bad, rule)) == n


@pytest.mark.parametrize("rule", sorted(MESH_FIXTURES))
def test_mesh_rule_silent_on_the_fixed_form(rule):
    found = _mesh_new(MESH_FIXTURES[rule][1], rule)
    assert not found, "\n".join(f.render() for f in found)


def test_phl007_is_mesh_scoped_and_phl008_is_not():
    from photon_tpu_torch.analysis.core import is_mesh_scoped

    assert is_mesh_scoped("photon_tpu_torch/parallel/sparse.py")
    assert is_mesh_scoped("photon_tpu_torch/game/coordinate.py")  # a hot path
    assert not is_mesh_scoped("photon_tpu_torch/io/avro.py")
    assert _mesh_new(PHL007_BAD, "PHL007", "photon_tpu_torch/game/coordinate.py")
    assert not _mesh_new(PHL007_BAD, "PHL007", "photon_tpu_torch/io/avro.py")
    assert _mesh_new(PHL008_BAD, "PHL008", "photon_tpu_torch/io/avro.py")
    annotated = PHL007_BAD.replace(
        "    b = x_host.cuda()", "    # phl-ok: PHL007 a per-process tensor\n    b = x_host.cuda()")
    assert len(_mesh_new(annotated, "PHL007")) == 4


def test_phl008_spares_the_counted_wrappers_only_in_their_file():
    src = (REPO / "photon_tpu_torch" / "parallel" / "mesh.py").read_text()
    assert not _mesh_new(src, "PHL008", "photon_tpu_torch/parallel/mesh.py")
    moved = _mesh_new(src, "PHL008", "photon_tpu_torch/parallel/elsewhere.py")
    assert {f.snippet.split("(")[0] for f in moved} == {"dist.all_reduce", "dist.all_gather"}


# --- the census and the contracts (analysis/spmd.py) ------------------------------


def test_comm_allowance_holds_kinds_payloads_and_named_sites():
    from photon_tpu_torch.analysis import spmd

    fe = spmd.SpmdContract(
        comm=spmd.CommAllowance(ops=("all-reduce",), max_bytes_per_site=136),
        named={"rows": spmd.CommAllowance(ops=("all-gather",), max_bytes_per_site=4096)})
    ok = [spmd.CollectiveSite("all-reduce", None, 136, 2, 9),
          spmd.CollectiveSite("all-gather", "rows", 4096, 2, 3)]
    assert spmd.check_comm_allowance(ok, fe, "train", "fixed:train") == []
    bad = [spmd.CollectiveSite("all-gather", None, 64, 2, 1),  # not by name: refused
           spmd.CollectiveSite("all-reduce", None, 137, 2, 1),  # over the bound
           spmd.CollectiveSite("all-gather", "rows", 8192, 2, 1)]  # over its own bound
    found = spmd.check_comm_allowance(bad, fe, "train", "fixed:train")
    assert [f.check for f in found] == ["comm-allowance"] * 3
    re = spmd.SpmdContract(comm=spmd.COLLECTIVE_FREE, comm_overrides={
        "score": spmd.CommAllowance(ops=("all-reduce",), max_bytes_per_site=4096)})
    fold = [spmd.CollectiveSite("all-reduce", "re_score_fold", 2048, 2, 5)]
    assert spmd.check_comm_allowance(fold, re, "score", "user:score") == []
    assert spmd.check_comm_allowance(fold, re, "train", "user:train")  # the solve: none


def test_census_rows_price_one_execution_per_site():
    from photon_tpu_torch.analysis import spmd

    census = {("fixed", "train"): {("all-reduce", None, 136, 2): 40,
                                   ("all-reduce", None, 8, 2): 80},
              ("user", "score"): {("all-reduce", "re_score_fold", 2048, 2): 3}}
    rows = {r["program"]: r for r in spmd.communication_census(census)}
    assert rows["fixed:train"]["comm_bytes"] == 144 and rows["fixed:train"]["calls"] == 120
    assert rows["fixed:train"]["bytes"] == 40 * 136 + 80 * 8
    assert spmd.census_by_op(census) == {"all-reduce": {"calls": 123,
                                                        "bytes": 40 * 136 + 80 * 8 + 3 * 2048}}


def test_placement_check_finds_a_table_of_full_size():
    """On rank 0 of a 1x2 mesh a random effect's bucket must hold half its
    padded lanes and a fixed effect's batch half the rows; the whole table
    on the rank is the sharding contract's finding."""
    import types

    from photon_tpu_torch.analysis import spmd

    mesh = types.SimpleNamespace(distributed=True, size=2, entity_shards=2, rank=0)

    def re_coord(lanes, table=None):
        host = types.SimpleNamespace(features=np.zeros((7, 3, 2)))
        dev = types.SimpleNamespace(features=torch.zeros((lanes, 3, 2)))
        return types.SimpleNamespace(
            mesh=mesh, dataset=types.SimpleNamespace(buckets=[host]), device_buckets=[dev],
            num_samples=10, initial_state=lambda: [torch.zeros((table or lanes, 2))])

    def fe_coord(rows):
        return types.SimpleNamespace(mesh=mesh, batch=types.SimpleNamespace(
            labels=torch.zeros(rows)))

    assert spmd.check_placement({"user": re_coord(4), "fixed": fe_coord(5)}, mesh) == []
    found = spmd.check_placement({"user": re_coord(8), "fixed": fe_coord(10)}, mesh)
    assert [f.program for f in found] == ["user:bucket0", "user:bucket0", "fixed:rows"]
    assert all("every rank" in f.message for f in found)
    (table,) = spmd.check_placement({"user": re_coord(4, table=8)}, mesh)
    assert table.message.startswith("coefficient table holds 8 entity lanes")
    assert spmd.check_placement({"user": re_coord(8)}, tcoord.LOCAL) == []


def test_programs_report_the_census_in_their_jsonl(tmp_path, capsys):
    out = tmp_path / "lint.jsonl"
    assert main(["--root", str(REPO), "--programs", "--device", "cpu", "--jsonl", str(out)]) == 0
    rows = [json.loads(ln) for ln in out.read_text().splitlines()]
    census = {r["program"]: r for r in rows if r.get("kind") == "comm-census"}
    # a world of one: the fixed effect's solve reduces d-vectors, the random
    # effect's solve makes no collective
    assert set(census) == {"global:train", "global:score", "per_user:score"}
    assert {s["op"] for s in census["global:train"]["collective_sites"]} == {"all-reduce"}
    assert "communication census" in capsys.readouterr().out
