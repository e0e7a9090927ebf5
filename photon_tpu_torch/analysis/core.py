"""photon-lint core for the port: findings, inline annotations, rule
registry, tree walk.

The AST engine of ``python -m photon_tpu_torch.analysis``, the JAX
package's engine (photon_tpu/analysis/core.py) with the port's paths:
the scan is every ``photon_tpu_torch/**/*.py`` (tests stay out), and the
hot paths whose steady-state loops must not sync are the descent, the
coordinates, the scorer, the streaming trainer and the optimizers; the
mesh scope (PHL007) is the hot paths plus ``photon_tpu_torch/parallel/``.
Rules are deliberately mechanical, a
pattern either matches or it doesn't, and the escape hatches are
explicit and reviewable:

* an inline annotation ``# phl-ok: PHL00X <reason>`` on the finding line
  (or the line directly above) marks an INTENTIONAL site, e.g. the one
  read-back barrier per sweep. The reason text is mandatory — a bare
  annotation does not suppress.
* ``photon_tpu_torch/analysis/baseline.toml`` carries the reviewed long tail of existing
  sites. Baseline entries match on (rule, path, stripped source line), so
  they survive line-number drift but die with the code they describe —
  the stale-allowlist test fails when an entry no longer resolves.

Findings never crash the analyzer: a file that does not parse is reported
as a PHL000 finding instead.
"""
from __future__ import annotations

import ast
import dataclasses
import io
import re
import tokenize
from pathlib import Path
from typing import Any, Callable, Iterable, Iterator, Sequence

#: modules whose steady-state loops run per sweep, per chunk or per
#: batch: PHL001/PHL002/PHL009 fire only here (relative posix paths or
#: directory prefixes under the scan root)
HOT_PATH_FILES = (
    "photon_tpu_torch/game/coordinate.py",
    "photon_tpu_torch/game/descent.py",
    "photon_tpu_torch/game/scoring.py",
    "photon_tpu_torch/game/streaming.py",
)
HOT_PATH_PREFIXES = ("photon_tpu_torch/optimize/",)

#: modules where placement decisions on a mesh live: the hot paths plus
#: the mesh layer. PHL007 (a whole host array placed on the card) fires
#: only here, as JAX's does in its mesh scope
MESH_SCOPED_PREFIXES = ("photon_tpu_torch/parallel/",)

_ANNOTATION_RE = re.compile(
    r"#\s*phl-ok:\s*(?P<rules>PHL\d{3}(?:\s*,\s*PHL\d{3})*)\s*(?P<reason>\S.*)?$"
)


def is_hot_path(relpath: str) -> bool:
    p = relpath.replace("\\", "/")
    return p in HOT_PATH_FILES or any(
        p.startswith(pref) for pref in HOT_PATH_PREFIXES
    )


def is_mesh_scoped(relpath: str) -> bool:
    p = relpath.replace("\\", "/")
    return is_hot_path(p) or any(p.startswith(pref) for pref in MESH_SCOPED_PREFIXES)


@dataclasses.dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # scan-root-relative posix path
    line: int
    col: int
    message: str
    #: the stripped source line — the line-number-independent fingerprint
    #: baseline entries match against
    snippet: str
    #: "new" | "annotated" | "baseline" — set by the gate, not the rules
    status: str = "new"

    def with_status(self, status: str) -> "Finding":
        return dataclasses.replace(self, status=status)

    def to_json(self) -> dict[str, Any]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (
            f"{self.path}:{self.line}:{self.col}: {self.rule} "
            f"{self.message}\n    {self.snippet}"
        )


@dataclasses.dataclass
class FileContext:
    """Everything a rule sees for one file."""

    path: str
    tree: ast.Module
    lines: list[str]
    hot: bool
    #: line → set of rule ids suppressed by a reasoned ``# phl-ok:``
    annotations: dict[int, set[str]]
    #: node-id set shared between cooperating rules (PHL001 claims
    #: escaping views so PHL002 doesn't double-report them)
    claimed: set[int] = dataclasses.field(default_factory=set)
    #: hot-path or mesh-layer module (see is_mesh_scoped)
    mesh_scoped: bool = False
    #: ast parent links, built lazily
    _parents: dict[int, ast.AST] | None = None

    def snippet(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: str, node: ast.AST, message: str) -> Finding:
        line = getattr(node, "lineno", 1)
        return Finding(
            rule=rule,
            path=self.path,
            line=line,
            col=getattr(node, "col_offset", 0) + 1,
            message=message,
            snippet=self.snippet(line),
        )

    def parents(self) -> dict[int, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for parent in ast.walk(self.tree):
                for child in ast.iter_child_nodes(parent):
                    self._parents[id(child)] = parent
        return self._parents

    def parent(self, node: ast.AST) -> ast.AST | None:
        return self.parents().get(id(node))

    def enclosing_function(
        self, node: ast.AST
    ) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
        cur = self.parent(node)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
            cur = self.parent(cur)
        return None

    def is_suppressed(self, f: Finding) -> bool:
        for line in (f.line, f.line - 1):
            if f.rule in self.annotations.get(line, set()):
                return True
        return False


class Rule:
    """One PHL rule. Subclasses set the id/title and implement check()."""

    rule_id: str = "PHL000"
    title: str = ""
    hot_path_only: bool = False
    mesh_scoped_only: bool = False

    def check(self, ctx: FileContext) -> list[Finding]:  # pragma: no cover
        raise NotImplementedError


def parse_annotations(src: str) -> dict[int, set[str]]:
    """``# phl-ok: PHL002 <reason>`` COMMENTS, keyed by 1-based line —
    real comments only, via tokenize, so the marker inside a string
    literal (a log message, a rule's own help text) cannot suppress
    anything. Annotations without a reason are ignored (the finding
    still fires) — the reason is the reviewable artifact."""
    out: dict[int, set[str]] = {}
    try:
        tokens = tokenize.generate_tokens(io.StringIO(src).readline)
        for tok in tokens:
            if tok.type != tokenize.COMMENT:
                continue
            m = _ANNOTATION_RE.search(tok.string)
            if m is None or not m.group("reason"):
                continue
            out[tok.start[0]] = {
                r.strip() for r in m.group("rules").split(",")
            }
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        pass  # ast.parse already succeeded, so this is unreachable
    return out


# --- name-resolution helpers shared by the rule modules -------------------


def dotted_name(node: ast.AST) -> str | None:
    """'np.asarray' for Attribute chains over Names, else None."""
    parts: list[str] = []
    cur = node
    while isinstance(cur, ast.Attribute):
        parts.append(cur.attr)
        cur = cur.value
    if isinstance(cur, ast.Name):
        parts.append(cur.id)
        return ".".join(reversed(parts))
    return None


def call_name(call: ast.Call) -> str | None:
    return dotted_name(call.func)


def root_name(node: ast.AST) -> str | None:
    """The leftmost Name of an Attribute/Subscript/Call chain."""
    cur = node
    while True:
        if isinstance(cur, ast.Name):
            return cur.id
        if isinstance(cur, (ast.Attribute, ast.Subscript, ast.Starred)):
            cur = cur.value
        elif isinstance(cur, ast.Call):
            cur = cur.func
        else:
            return None


def keyword_arg(call: ast.Call, name: str) -> ast.expr | None:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


# --- engine ---------------------------------------------------------------

_REGISTRY: list[Rule] = []


def register(rule_cls: type[Rule]) -> type[Rule]:
    _REGISTRY.append(rule_cls())
    return rule_cls


def all_rules() -> list[Rule]:
    # import for side effect: rule modules self-register
    from photon_tpu_torch.analysis import (  # noqa: F401
        rules_ctypes,
        rules_host_sync,
        rules_mmap,
        rules_retry,
        rules_spmd,
        rules_threads,
    )

    return sorted(_REGISTRY, key=lambda r: r.rule_id)


def analyze_source(
    src: str,
    path: str,
    *,
    hot: bool | None = None,
    mesh_scoped: bool | None = None,
    rules: Iterable[Rule] | None = None,
) -> list[Finding]:
    """Run the AST rules over one file's source. Annotated findings are
    returned with status="annotated"; callers decide whether those gate.
    ``hot=None`` / ``mesh_scoped=None`` classify from the path (tests
    force them for fixtures)."""
    relpath = path.replace("\\", "/")
    lines = src.splitlines()
    try:
        tree = ast.parse(src, filename=relpath)
    except SyntaxError as e:
        return [
            Finding(
                rule="PHL000",
                path=relpath,
                line=e.lineno or 1,
                col=(e.offset or 0) + 1,
                message=f"file does not parse: {e.msg}",
                snippet=lines[(e.lineno or 1) - 1].strip() if lines else "",
            )
        ]
    ctx = FileContext(
        path=relpath,
        tree=tree,
        lines=lines,
        hot=is_hot_path(relpath) if hot is None else hot,
        annotations=parse_annotations(src),
        mesh_scoped=is_mesh_scoped(relpath) if mesh_scoped is None else mesh_scoped,
    )
    findings: list[Finding] = []
    for rule in rules if rules is not None else all_rules():
        if rule.hot_path_only and not ctx.hot:
            continue
        if rule.mesh_scoped_only and not ctx.mesh_scoped:
            continue
        for f in rule.check(ctx):
            findings.append(
                f.with_status("annotated") if ctx.is_suppressed(f) else f
            )
    findings.sort(key=lambda f: (f.path, f.line, f.col, f.rule))
    return findings


def default_scan_files(root: Path) -> list[Path]:
    """The tree the gate walks: every module of the port. Tests are
    excluded on purpose (test code plants these patterns)."""
    base = Path(root) / "photon_tpu_torch"
    if not base.is_dir():
        return []
    return [p for p in sorted(base.rglob("*.py")) if "__pycache__" not in p.parts]


def analyze_tree(
    root: Path,
    files: Sequence[Path] | None = None,
    *,
    rules: Iterable[Rule] | None = None,
    on_file: Callable[[Path], None] | None = None,
) -> list[Finding]:
    root = Path(root)
    findings: list[Finding] = []
    rules = list(rules) if rules is not None else all_rules()
    for p in files if files is not None else default_scan_files(root):
        if on_file is not None:
            on_file(p)
        try:
            rel = p.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:  # explicit path outside the scan root
            rel = p.as_posix()
        findings.extend(
            analyze_source(p.read_text(encoding="utf-8"), rel, rules=rules)
        )
    return findings


# --- card-reported sites → findings -----------------------------------------

_HEADER_FIELDS = {
    ast.If: ("test",), ast.While: ("test",), ast.For: ("target", "iter"),
    ast.AsyncFor: ("target", "iter"), ast.With: ("items",), ast.AsyncWith: ("items",),
}


def _own_lines(stmt: ast.stmt) -> tuple[int, int]:
    """A simple statement's lines; a compound statement's header lines
    only (its body holds statements of its own)."""
    if not hasattr(stmt, "body"):
        return stmt.lineno, stmt.end_lineno or stmt.lineno
    end = stmt.lineno
    for name in _HEADER_FIELDS.get(type(stmt), ()):
        value = getattr(stmt, name)
        for node in value if isinstance(value, list) else [value]:
            for sub in ast.walk(node):
                end = max(end, getattr(sub, "end_lineno", None) or end)
    return stmt.lineno, end


def statement_span(tree: ast.Module, line: int) -> tuple[int, int] | None:
    """The lines of the innermost statement that holds ``line`` (a compound
    statement by its header). A runtime frame may name any line of a
    multi-line statement (Python 3.12 reports a call at its attribute's
    line), so a card-reported site and a finding are matched by this span,
    not by their line."""
    best = None
    for node in ast.walk(tree):
        if isinstance(node, ast.stmt):
            lo, hi = _own_lines(node)
            if lo <= line <= hi and (best is None or hi - lo < best[1] - best[0]):
                best = (lo, hi)
    return best


def match_sites(root: Path, sites: Iterable[tuple[str, int]], findings: Iterable[Finding],
                rule: str = "PHL002") -> dict[tuple[str, int], Finding | None]:
    """``(relpath, line)`` sites (a warning's frame in the scan tree) →
    the finding of ``rule`` in the same statement, or None. Findings of
    every status count: an annotated or baselined one is a reviewed site."""
    trees: dict[str, ast.Module] = {}

    def span(path: str, line: int):
        if path not in trees:
            trees[path] = ast.parse((Path(root) / path).read_text(encoding="utf-8"))
        return statement_span(trees[path], line)

    by_span: dict[tuple[str, tuple[int, int] | None], Finding] = {}
    for f in findings:
        if f.rule == rule:
            by_span.setdefault((f.path, span(f.path, f.line)), f)
    return {(path, line): by_span.get((path, span(path, line))) for path, line in sites}
