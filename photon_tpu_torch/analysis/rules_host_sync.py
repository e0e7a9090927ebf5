"""PHL001/PHL002/PHL006: host/device boundary discipline, in torch's forms.

PHL001 is the aliased-snapshot class: ``t.numpy()`` of a CPU tensor, or
``np.asarray(t)``, is a ZERO-COPY view of the tensor's storage. If that
view escapes the function (returned, yielded, stored on an attribute,
handed to a call such as a callback) while the tensor is later updated
in place (``add_``, ``copy_``, ``out[...] = ...``, a reused staging
slot), the "snapshot" changes under its holder afterwards. This is the
torch form of the JAX package's donated-view checkpoint corruption.
``.clone()``, ``.copy()``, ``np.array(...)`` and ``copy=True`` are
snapshots and pass.

PHL002 is the silent host-sync class: in a hot-path module, a call that
makes the host wait for the card serializes the launch queue. Flagged:
``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``.to("cpu")``
(also through a name bound to ``"cpu"`` or ``torch.device("cpu")``);
a blocking copy of host data to the device, ``torch.as_tensor(...)``,
``torch.tensor(...)`` or ``torch.from_numpy(...)`` followed by
``.to(device)`` or ``.cuda()``, or given ``device=`` (the copy waits for
the stream; ``non_blocking=True`` does not);
``float(...)``, ``int(...)`` and ``bool(...)`` on a non-literal (a 0-d
tensor's value); ``np.asarray(...)``; ``torch.cuda.synchronize()`` and
``.synchronize()`` on a stream or event; ``.any()`` or ``.all()`` used
directly as the test of an ``if`` or ``while`` (an implicit
``Tensor.__bool__``). A genuine barrier carries ``# phl-ok: PHL002
<reason>``; build-time and teardown-time conversions are baselined. The
card can say which of them really synced: ``chip_smoke.py``'s
``sync_sites`` phase runs a fit under ``torch.cuda.set_sync_debug_mode
("warn")`` and requires every hot-path site the card reports to be one
of these findings.

PHL006 is the clock mandate: ``time.time()`` is not monotonic (NTP steps
it), so durations and deadlines computed from it are wrong exactly when
clocks are being corrected. Only epoch anchors may use it, annotated.
"""
from __future__ import annotations

import ast

from photon_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    dotted_name,
    keyword_arg,
    register,
)

_NP_VIEW_CALLS = {"np.asarray", "numpy.asarray"}
# np.array is NOT here: it copies by default, which makes it a declared
# snapshot (the same reason a .copy() chain is exempt below)
_SYNC_METHODS = {
    "item": ".item() reads one scalar back from the card",
    "tolist": ".tolist() reads the tensor back from the card",
    "cpu": ".cpu() copies the tensor to the host and waits for it",
    "numpy": ".numpy() hands the host a view (a CUDA tensor must be copied back first)",
    "synchronize": ".synchronize() blocks the host until the stream, event or card is idle",
}
_SCALAR_CASTS = {"float", "int", "bool"}
#: constructors whose result is a host tensor made from host data (unless
#: they are given a device)
_HOST_CONSTRUCTORS = {"torch.as_tensor", "torch.tensor", "torch.from_numpy"}
_H2D = "a blocking copy of host data to the device waits for the stream"
#: attribute methods that turn a view into a copy or a host scalar before
#: it can alias the tensor's storage
_SAFE_CHAIN_ATTRS = {
    "copy", "astype", "tolist", "item", "sum", "mean", "min", "max",
    "nbytes", "shape", "dtype", "clone",
}
_ANNOTATE = "annotate a genuine barrier with '# phl-ok: PHL002 <reason>'"


def _is_copy_true(call: ast.Call) -> bool:
    """Only a literal copy=True is a declared snapshot: copy=False is an
    explicitly requested view, and a dynamic value proves nothing."""
    kw = keyword_arg(call, "copy")
    return isinstance(kw, ast.Constant) and kw.value is True


def _is_view_call(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    if call_name(node) in _NP_VIEW_CALLS:
        return not _is_copy_true(node)
    return (isinstance(node.func, ast.Attribute) and node.func.attr == "numpy"
            and not node.args and not node.keywords)


def _is_cpu_device_expr(node: ast.AST | None, cpu_names: set[str]) -> bool:
    """``"cpu"``, ``torch.device("cpu")`` or a name bound to either."""
    if node is None:
        return False
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Name):
        return node.id in cpu_names
    if isinstance(node, ast.Call) and call_name(node) in ("torch.device", "device"):
        return bool(node.args) and isinstance(node.args[0], ast.Constant) \
            and node.args[0].value == "cpu"
    return False


def _non_blocking(call: ast.Call) -> bool:
    kw = keyword_arg(call, "non_blocking")
    return isinstance(kw, ast.Constant) and kw.value is True


def _is_dtype_expr(node: ast.AST) -> bool:
    """``torch.float64`` or a name of a dtype (``dtype``,
    ``self._feature_dtype``): a ``.to(dtype)`` moves nothing between
    devices."""
    name = dotted_name(node) or ""
    leaf = name.split(".")[-1]
    return (name.startswith("torch.") and leaf in _TORCH_DTYPES) or "dtype" in leaf


_TORCH_DTYPES = {
    "float16", "float32", "float64", "bfloat16", "half", "float", "double",
    "int8", "int16", "int32", "int64", "long", "int", "uint8", "bool", "complex64",
}


def _cpu_names(tree: ast.Module) -> set[str]:
    """Names assigned ``"cpu"`` or ``torch.device("cpu")`` anywhere in
    the module (a module constant such as ``_HOST``, or a local)."""
    out: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and _is_cpu_device_expr(node.value, set()):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif (isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name)
              and _is_cpu_device_expr(node.value, set())):
            out.add(node.target.id)
    return out


def _escape_context(ctx: FileContext, node: ast.AST) -> str | None:
    """Name of the escape route of a view, or None when it stays local or
    is copied at once."""
    child: ast.AST = node
    parent = ctx.parent(node)
    # subscripts and slices still alias the storage, and containers (a
    # list of views handed to a callback) carry their elements
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
            if isinstance(tgt, ast.Subscript) and isinstance(tgt.value, ast.Attribute):
                return "stored in an attribute container"
    return None


@register
class AliasedViewEscape(Rule):
    rule_id = "PHL001"
    title = "numpy view of a tensor escapes without a copy"
    hot_path_only = True

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not _is_view_call(node):
                continue
            escape = _escape_context(ctx, node)
            if escape is None:
                continue
            ctx.claimed.add(id(node))
            out.append(ctx.finding(
                self.rule_id, node,
                f"a numpy view of a tensor's storage escapes this function ({escape}) "
                f"without a copy: an in-place update of the tensor (add_, copy_, a "
                f"reused staging slot) later changes the 'snapshot' under its holder; "
                f"take .clone(), .copy() or np.array(...) before it leaves",
            ))
        return out


def _test_of_branch(ctx: FileContext, node: ast.Call) -> bool:
    """``node`` is the whole test of an ``if``/``while`` (or its ``not``)."""
    child, parent = node, ctx.parent(node)
    if isinstance(parent, ast.UnaryOp) and isinstance(parent.op, ast.Not):
        child, parent = parent, ctx.parent(parent)
    return isinstance(parent, (ast.If, ast.While, ast.IfExp)) and parent.test is child


@register
class HostSyncInHotPath(Rule):
    rule_id = "PHL002"
    title = "host-sync call in a hot-path module outside a barrier site"
    hot_path_only = True

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        cpu_names = _cpu_names(ctx.tree)
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call) or id(node) in ctx.claimed:
                continue
            msg = self._sync_kind(ctx, node, cpu_names)
            if msg is not None:
                out.append(ctx.finding(self.rule_id, node, f"{msg}; {_ANNOTATE}"))
        return out

    def _sync_kind(self, ctx: FileContext, node: ast.Call, cpu_names: set[str]) -> str | None:
        name = call_name(node)
        if name in _NP_VIEW_CALLS:
            # an explicit copy is a declared snapshot, PHL001's remedy
            if _is_copy_true(node):
                return None
            parent = ctx.parent(node)
            while isinstance(parent, (ast.Subscript, ast.Slice)):
                parent = ctx.parent(parent)
            if isinstance(parent, ast.Attribute) and parent.attr in ("copy", "astype"):
                return None
            return f"{name}() of a tensor copies it to the host and waits for the card"
        if name == "torch.cuda.synchronize":
            return "torch.cuda.synchronize() blocks the host until the card is idle"
        if name in ("torch.as_tensor", "torch.tensor"):
            device = keyword_arg(node, "device")
            if device is not None and not _is_cpu_device_expr(device, cpu_names) \
                    and not _non_blocking(node):
                return _H2D
            return None
        if isinstance(node.func, ast.Name) and node.func.id in _SCALAR_CASTS:
            if node.args and not isinstance(node.args[0], ast.Constant):
                return (f"{node.func.id}(...) on a non-literal reads a 0-d tensor's value "
                        f"back from the card")
            return None
        if not isinstance(node.func, ast.Attribute):
            return None
        attr = node.func.attr
        if attr in _SYNC_METHODS and not node.args and not node.keywords:
            return _SYNC_METHODS[attr]
        host_made = (isinstance(node.func.value, ast.Call)
                     and call_name(node.func.value) in _HOST_CONSTRUCTORS
                     and keyword_arg(node.func.value, "device") is None)
        if attr == "to":
            target = node.args[0] if node.args else keyword_arg(node, "device")
            if _is_cpu_device_expr(target, cpu_names):
                return ".to(\"cpu\") copies the tensor to the host and waits for it"
            if host_made and target is not None and not _non_blocking(node) \
                    and not _is_dtype_expr(target):
                return _H2D
            return None
        if attr == "cuda" and host_made and not _non_blocking(node):
            return _H2D
        if attr in ("any", "all") and not node.args and _test_of_branch(ctx, node):
            return (f"'{attr}()' as the test of a branch reads the tensor's truth value "
                    f"back from the card")
        return None


@register
class WallClockDuration(Rule):
    rule_id = "PHL006"
    title = "time.time() used where a monotonic clock is mandated"

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if isinstance(node, ast.Call) and call_name(node) == "time.time":
                out.append(ctx.finding(
                    self.rule_id, node,
                    "time.time() is not monotonic: durations and deadlines must use "
                    "time.monotonic()/time.perf_counter(); a genuine epoch anchor needs "
                    "'# phl-ok: PHL006 <reason>'",
                ))
        return out
