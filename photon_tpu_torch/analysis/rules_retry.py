"""PHL009 — retry loops carry an attempt cap and a transient classifier.

The fault-tolerance layer rests on one contract (util/retry.py): a
retry loop must (a) be BOUNDED — an uncapped loop turns a permanent
failure into a silent hang, the exact wedge the streaming watchdog
exists to kill — and (b) re-raise NON-TRANSIENT errors immediately — an
``except Exception`` that swallows a shape error or an OOM and retries
just multiplies the time to the real traceback, and in a supervised
``run_with_recovery`` stack it burns the whole restart budget on a bug.
The fault-injection tests prove the classified paths recover; this
rule keeps unclassified ones from creeping back into the
hot paths.

Two mechanical patterns fire, hot-path modules only:

* a ``while True`` loop whose body contains a broad handler (bare
  ``except`` / ``except Exception``) that does not re-raise — a retry
  loop with no attempt cap;
* any loop containing a broad handler that neither re-raises nor
  consults a transient classifier (a call whose name mentions
  ``transient`` or ``classify``) — retries that swallow non-transient
  errors.

The sanctioned form is ``util/retry.retry_call`` (capped, classified,
counted); hand-rolled loops that re-raise on a classifier miss — the
``put_with_retry`` shape — pass on their own.
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


def _is_broad(handler: ast.ExceptHandler) -> bool:
    """Bare ``except:`` or ``except Exception`` / ``BaseException``
    (including as one member of a tuple)."""
    t = handler.type
    if t is None:
        return True
    types = t.elts if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = node.id if isinstance(node, ast.Name) else (
            node.attr if isinstance(node, ast.Attribute) else None
        )
        if name in ("Exception", "BaseException"):
            return True
    return False


def _reraises(handler: ast.ExceptHandler) -> bool:
    return any(
        isinstance(node, ast.Raise)
        for stmt in handler.body
        for node in ast.walk(stmt)
    )


def _consults_classifier(handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node) or ""
            leaf = name.rsplit(".", 1)[-1].lower()
            if "transient" in leaf or leaf.startswith("classify"):
                return True
    return False


def _is_while_true(loop: ast.AST) -> bool:
    return (
        isinstance(loop, ast.While)
        and isinstance(loop.test, ast.Constant)
        and loop.test.value is True
    )


def _nearest_loop(
    ctx: FileContext, node: ast.AST
) -> "ast.While | ast.For | None":
    """The NEAREST enclosing loop of ``node``, stopping at function
    boundaries (a nested function's loops are its own findings). One
    try/except gets exactly one owning loop — a handler inside a
    bounded inner loop nested in a `while True` must not be reported
    twice."""
    cur = ctx.parent(node)
    while cur is not None:
        if isinstance(cur, (ast.While, ast.For)):
            return cur
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return None
        cur = ctx.parent(cur)
    return None


@register
class RetryDiscipline(Rule):
    rule_id = "PHL009"
    title = "uncapped / transient-swallowing retry loop"
    hot_path_only = True

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Try):
                continue
            loop = _nearest_loop(ctx, node)
            if loop is None:
                continue
            for handler in node.handlers:
                if not _is_broad(handler):
                    continue
                if _reraises(handler):
                    continue
                if _consults_classifier(handler):
                    continue
                if _is_while_true(loop):
                    out.append(
                        ctx.finding(
                            self.rule_id,
                            handler,
                            "broad except inside `while True` is a "
                            "retry loop with NO attempt cap — a "
                            "permanent failure becomes a silent "
                            "hang; use util/retry.retry_call "
                            "(capped, classified, counted)",
                        )
                    )
                else:
                    out.append(
                        ctx.finding(
                            self.rule_id,
                            handler,
                            "broad except in a retry loop swallows "
                            "NON-TRANSIENT errors (shape bugs, OOM "
                            "retry as if the device hiccuped) — "
                            "re-raise when util/retry.is_transient "
                            "says no, or use retry_call",
                        )
                    )
        return out
