"""PHL010 — numpy views over an mmap escaping their owning function.

The feature-cache bug class: ``np.frombuffer(mm)`` over an
``mmap.mmap`` object is a ZERO-COPY view of the mapped pages. If that
view escapes the function that owns the mmap (returned, yielded, handed
to a call, stored on an attribute/container) without a ``.copy()``, the
mmap's lifetime and the view's decouple — ``mm.close()`` (or the owner
being garbage collected after an explicit close) leaves a live array
over unmapped pages: the exact use-after-free family as PHL001 (escaping
numpy views of tensors) and PHL004 (ctypes temporary pools), except the crash is
a SIGBUS at first touch instead of silent garbage.

The sanctioned pattern is an OWNER OBJECT that holds both the mmaps and
every view for a shared lifetime (``photon_tpu_torch/cache/reader.py``, the
baselined sites); everything else copies before the view leaves.
"""
from __future__ import annotations

import ast

from photon_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    register,
)

_MMAP_CALLS = {"mmap.mmap"}
_VIEW_CALLS = {"np.frombuffer", "numpy.frombuffer"}
#: chained attributes that turn the view into a copy / host scalar
_SAFE_CHAIN_ATTRS = {
    "copy", "astype", "tolist", "item", "sum", "mean", "min", "max",
    "nbytes", "shape", "dtype",
}


def _mmap_bound_names(
    fn: ast.FunctionDef | ast.AsyncFunctionDef,
) -> set[str]:
    """Local names assigned from ``mmap.mmap(...)`` inside ``fn``."""
    out: set[str] = set()
    for node in ast.walk(fn):
        if not isinstance(node, ast.Assign):
            continue
        value = node.value
        if (
            isinstance(value, ast.Call)
            and call_name(value) in _MMAP_CALLS
        ):
            for tgt in node.targets:
                if isinstance(tgt, ast.Name):
                    out.add(tgt.id)
    return out


def _first_arg_root(call: ast.Call) -> str | None:
    if not call.args:
        return None
    cur: ast.AST = call.args[0]
    while isinstance(cur, (ast.Subscript, ast.Attribute, ast.Starred)):
        cur = cur.value
    if isinstance(cur, ast.Name):
        return cur.id
    return None


def _first_arg_is_mmap_call(call: ast.Call) -> bool:
    return bool(
        call.args
        and isinstance(call.args[0], ast.Call)
        and call_name(call.args[0]) in _MMAP_CALLS
    )


@register
class MmapViewEscape(Rule):
    rule_id = "PHL010"
    title = "numpy view over an mmap escapes without .copy()"

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for fn in ast.walk(ctx.tree):
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            mmap_names = _mmap_bound_names(fn)
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                if call_name(node) not in _VIEW_CALLS:
                    continue
                over_mmap = _first_arg_is_mmap_call(node) or (
                    _first_arg_root(node) in mmap_names
                )
                if not over_mmap:
                    continue
                escape = self._escape_context(ctx, node)
                if escape is None:
                    continue
                out.append(
                    ctx.finding(
                        self.rule_id,
                        node,
                        f"np.frombuffer view over an mmap escapes this "
                        f"function ({escape}) without .copy() — a closed "
                        f"mmap behind a live view is a use-after-free "
                        f"(SIGBUS at first touch); copy before the view "
                        f"leaves, or keep mmap and view on one owner "
                        f"with a shared lifetime",
                    )
                )
        return out

    def _escape_context(
        self, ctx: FileContext, node: ast.Call
    ) -> str | None:
        """Name of the escape route, or None when the view stays local /
        is immediately copied (the PHL001 walk, shared bug family)."""
        child: ast.AST = node
        parent = ctx.parent(node)
        while isinstance(
            parent,
            (ast.Subscript, ast.Slice, ast.List, ast.Tuple, ast.Set,
             ast.Dict, ast.Starred, ast.ListComp, ast.SetComp,
             ast.DictComp, ast.GeneratorExp),
        ):
            child, parent = parent, ctx.parent(parent)
        if isinstance(parent, ast.Attribute):
            if parent.attr in _SAFE_CHAIN_ATTRS:
                return None
            parent = ctx.parent(parent)
        if isinstance(parent, (ast.Return, ast.Yield)):
            return "returned"
        if isinstance(parent, ast.Call) and child is not parent.func:
            return "passed to a call"
        if isinstance(parent, ast.keyword):
            return "passed to a call"
        if isinstance(parent, ast.Assign):
            for tgt in parent.targets:
                if isinstance(tgt, ast.Attribute):
                    return "stored on an attribute"
                if isinstance(tgt, ast.Subscript) and isinstance(
                    tgt.value, ast.Attribute
                ):
                    return "stored in an attribute container"
        return None
