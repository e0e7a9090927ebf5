"""The reviewed allowlist (``photon_tpu_torch/analysis/baseline.toml``) and
its matching: the JAX package's (photon_tpu/analysis/baseline.py).

A baseline entry pins one intentional finding by (rule, path, stripped
source line) — line numbers are deliberately absent so entries survive
unrelated edits, but the entry dies with the line it describes: when no
current finding matches, the entry is STALE and the gate fails until it
is removed (the stale-allowlist detector in tests/test_torch_analysis.py
pins this over the committed file).

The file is TOML (an array of ``[[allow]]`` tables with string values).
``tomllib`` ships only from Python 3.11, and the gate must run on 3.10
with zero new deps, so a fallback parser covers exactly the subset the
writer emits: comments, ``[[allow]]`` headers, and ``key = "string"``
pairs with JSON-style escapes.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Iterable

from photon_tpu_torch.analysis.core import Finding


@dataclasses.dataclass(frozen=True)
class BaselineEntry:
    rule: str
    path: str
    snippet: str
    note: str = ""

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.snippet)

    def render(self) -> str:
        return f"{self.path}: {self.rule}\n    {self.snippet}"


def _parse_toml_subset(text: str) -> list[dict[str, str]]:
    """[[allow]] tables of string key/values; raises ValueError on
    anything outside the subset the writer emits."""
    tables: list[dict[str, str]] = []
    current: dict[str, str] | None = None
    for i, raw in enumerate(text.splitlines(), start=1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        if line == "[[allow]]":
            current = {}
            tables.append(current)
            continue
        if "=" in line and current is not None:
            key, _, value = line.partition("=")
            key, value = key.strip(), value.strip()
            if not (value.startswith('"') and value.endswith('"')):
                raise ValueError(
                    f"baseline line {i}: only string values supported: "
                    f"{raw!r}"
                )
            current[key] = json.loads(value)
            continue
        raise ValueError(f"baseline line {i}: cannot parse {raw!r}")
    return tables


def load_baseline(path: Path) -> list[BaselineEntry]:
    if not Path(path).is_file():
        return []
    text = Path(path).read_text(encoding="utf-8")
    try:
        import tomllib

        tables = tomllib.loads(text).get("allow", [])
    except ModuleNotFoundError:  # Python 3.10
        tables = _parse_toml_subset(text)
    out: list[BaselineEntry] = []
    for t in tables:
        out.append(
            BaselineEntry(
                rule=str(t["rule"]),
                path=str(t["path"]),
                snippet=str(t["snippet"]),
                note=str(t.get("note", "")),
            )
        )
    return out


def write_baseline(path: Path, entries: Iterable[BaselineEntry]) -> None:
    lines = [
        "# photon-lint baseline — the reviewed allowlist of intentional",
        "# findings. Entries match on (rule, path, stripped source line);",
        "# an entry that no longer matches any finding is STALE and fails",
        "# the gate. Regenerate with:",
        "#   python -m photon_tpu_torch.analysis --write-baseline",
        "# and review the diff like code — every entry is a claim that",
        "# the flagged site is intentional.",
        "",
    ]
    for e in sorted(entries, key=lambda e: e.key()):
        lines.append("[[allow]]")
        lines.append(f"rule = {json.dumps(e.rule)}")
        lines.append(f"path = {json.dumps(e.path)}")
        lines.append(f"snippet = {json.dumps(e.snippet)}")
        if e.note:
            lines.append(f"note = {json.dumps(e.note)}")
        lines.append("")
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text("\n".join(lines), encoding="utf-8")


@dataclasses.dataclass
class GateResult:
    new: list[Finding]
    allowed: list[Finding]
    annotated: list[Finding]
    stale: list[BaselineEntry]

    @property
    def ok(self) -> bool:
        return not self.new and not self.stale


def apply_baseline(
    findings: list[Finding], entries: list[BaselineEntry]
) -> GateResult:
    """Partition findings into new/allowed/annotated and detect stale
    entries. A baseline entry may match several findings (identical
    lines in one file); it is stale only when it matches none."""
    by_key: dict[tuple[str, str, str], BaselineEntry] = {
        e.key(): e for e in entries
    }
    matched: set[tuple[str, str, str]] = set()
    new: list[Finding] = []
    allowed: list[Finding] = []
    annotated: list[Finding] = []
    for f in findings:
        if f.status == "annotated":
            annotated.append(f)
            continue
        key = (f.rule, f.path, f.snippet)
        if key in by_key:
            matched.add(key)
            allowed.append(f.with_status("baseline"))
        else:
            new.append(f)
    stale = [e for e in entries if e.key() not in matched]
    return GateResult(
        new=new, allowed=allowed, annotated=annotated, stale=stale
    )
