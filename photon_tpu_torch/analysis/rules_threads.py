"""PHL003 — bounded producer/consumer thread lifecycles.

The streaming scorer once shipped a producer thread that a consumer-side
exception left blocked forever on a full hand-off queue, holding decoded
chunks (the leak was fixed by bounding every put with a stop event and
reaping in a ``finally``). This rule makes the three ingredients of that
fix mandatory wherever a thread is started:

* a thread started in a function must be ``join``-ed in a ``finally``
  block of that same function (the reap survives the failure path);
* hand-off queues must be bounded (``queue.Queue(maxsize=...)``) — an
  unbounded queue turns backpressure into unbounded host memory;
* a blocking ``.put(item)`` inside a loop must carry a ``timeout=`` (or
  ``block=False``) so a stop event can actually interrupt it — a bare
  put in a producer loop is un-interruptible by design.

Threads that intentionally outlive their creator (module-level workers)
carry an annotation.
"""
from __future__ import annotations

import ast
from typing import Iterator

from photon_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    keyword_arg,
    register,
)

_THREAD_CALLS = {"threading.Thread", "Thread"}
_QUEUE_CALLS = {"queue.Queue", "Queue", "queue.SimpleQueue", "SimpleQueue"}


def _finally_blocks(fn: ast.AST) -> Iterator[list[ast.stmt]]:
    for node in ast.walk(fn):
        if isinstance(node, ast.Try) and node.finalbody:
            yield node.finalbody


def _contains_join(stmts: list[ast.stmt]) -> bool:
    """A thread-reap shaped join: ``t.join()`` / ``t.join(timeout=5)``.
    ``str.join`` always takes exactly one positional argument (the
    iterable), so requiring zero positional args keeps a ``",".join(xs)``
    in a finally from satisfying the reap requirement."""
    for stmt in stmts:
        for node in ast.walk(stmt):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "join"
                and not node.args
                and not isinstance(node.func.value, ast.Constant)
            ):
                return True
    return False


def _module_uses_threads(tree: ast.Module) -> bool:
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            if any(a.name in ("threading", "queue") for a in node.names):
                return True
        elif isinstance(node, ast.ImportFrom):
            if node.module in ("threading", "queue"):
                return True
    return False


@register
class ThreadLifecycle(Rule):
    rule_id = "PHL003"
    title = "unreaped thread / unbounded hand-off queue"

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        threaded = _module_uses_threads(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name in _THREAD_CALLS:
                out.extend(self._check_thread(ctx, node))
            elif name in _QUEUE_CALLS:
                out.extend(self._check_queue(ctx, node, name))
            elif threaded:
                out.extend(self._check_put(ctx, node))
        return out

    def _check_thread(
        self, ctx: FileContext, node: ast.Call
    ) -> Iterator[Finding]:
        fn = ctx.enclosing_function(node)
        if fn is None:
            yield ctx.finding(
                self.rule_id,
                node,
                "thread created at module/class scope has no owning "
                "function to reap it — construct threads where a "
                "finally-guarded join can run (the leaked-producer "
                "class); intentional daemons need '# phl-ok: PHL003 "
                "<reason>'",
            )
            return
        if not any(_contains_join(fb) for fb in _finally_blocks(fn)):
            yield ctx.finding(
                self.rule_id,
                node,
                f"thread started in {fn.name}() is never join()-ed in a "
                f"finally block of that function — a consumer-side "
                f"exception leaks the thread and everything it holds "
                f"(the blocked-producer leak); reap with "
                f"try/finally: stop.set(); drain; t.join()",
            )

    def _check_queue(
        self, ctx: FileContext, node: ast.Call, name: str
    ) -> Iterator[Finding]:
        if "SimpleQueue" in name:
            yield ctx.finding(
                self.rule_id,
                node,
                "SimpleQueue cannot be bounded — producer/consumer "
                "hand-off must use queue.Queue(maxsize=...) so decoded "
                "data stages within a fixed host budget",
            )
            return
        maxsize = keyword_arg(node, "maxsize")
        if node.args:
            maxsize = node.args[0]
        if maxsize is None or (
            isinstance(maxsize, ast.Constant) and maxsize.value in (0, None)
        ):
            yield ctx.finding(
                self.rule_id,
                node,
                "unbounded Queue() — a stalled consumer lets the "
                "producer stage unbounded decoded data on the host; "
                "pass maxsize= (the streaming scorer's hard staging "
                "bound is the contract)",
            )

    def _check_put(
        self, ctx: FileContext, node: ast.Call
    ) -> Iterator[Finding]:
        if not (
            isinstance(node.func, ast.Attribute) and node.func.attr == "put"
        ):
            return
        if keyword_arg(node, "timeout") is not None:
            return
        block = keyword_arg(node, "block")
        if isinstance(block, ast.Constant) and block.value is False:
            return
        if len(node.args) >= 3:  # put(item, block, timeout) positionally
            return
        if len(node.args) == 2 and (
            isinstance(node.args[1], ast.Constant)
            and node.args[1].value is False
        ):
            return  # put(item, False): non-blocking — interruptible
        # NB: put(item, True) — positional block with NO timeout — falls
        # through on purpose: it is exactly as un-interruptible as a
        # bare put(item)
        # only flag puts that sit inside a loop — one-shot sentinel puts
        # after the loop are interruptible by construction
        cur = ctx.parent(node)
        while cur is not None and not isinstance(
            cur, (ast.FunctionDef, ast.AsyncFunctionDef)
        ):
            if isinstance(cur, (ast.While, ast.For)):
                yield ctx.finding(
                    self.rule_id,
                    node,
                    ".put(item) with no timeout inside a loop cannot be "
                    "interrupted by a stop event — a dead consumer "
                    "blocks this producer forever (the blocked-producer leak); use "
                    "put(item, timeout=...) in a stop-checking loop",
                )
                return
            cur = ctx.parent(cur)
