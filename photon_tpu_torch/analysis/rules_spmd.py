"""PHL007/PHL008: placement and collective discipline on the mesh, in torch's forms.

Counterparts of photon_tpu/analysis/rules_spmd.py. JAX's PHL007 flags a
``jax.device_put`` with no sharding in mesh-scoped code, and its PHL008 a
``shard_map`` with no ``out_specs``. The port has neither call: it places
tensors with ``.to(device)`` and writes its collectives out over
``torch.distributed``. The two failures they guard against keep their
numbers:

PHL007 is the silently replicated table. In mesh-scoped code (the hot
paths and ``photon_tpu_torch/parallel/``), a placement on the card
(``.to(device)``, ``.cuda()``, ``torch.as_tensor(..., device=)`` or
``torch.tensor(..., device=)``) of a host array that did not come through
the mesh's row or entity slicing puts the whole array on every rank:
numerically invisible, O(ranks) memory. A placement passes when what it
places is a slice (``x[lo:hi]``, the form ``row_range`` and
``entity_range`` give), the result of ``shard_batch`` or ``replicate``,
a literal (a scalar flag), or when it is the body of ``replicate``
itself (the declared replication). Any other deliberate placement, such
as a per-process tensor that never meets a mesh, carries
``# phl-ok: PHL007 <reason>``.

PHL008 is the undeclared collective. A raw ``torch.distributed``
collective (``all_reduce``, ``all_gather*``, ``broadcast*``,
``reduce_scatter*``) outside ``parallel/mesh.py``'s counted wrappers
(``all_reduce_sum``, ``gather_rows``, ``gather_entities``) has no
declared layout, and the mesh's census (analysis/spmd.py) never sees
it, so no contract can hold it. It fires on the whole tree.
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

#: the mesh's slicing helpers: what they return is already this rank's
_SLICING_CALLS = {"shard_batch", "replicate"}
#: functions whose placements ARE the declared replication
_REPLICATING_FUNCTIONS = {"replicate"}
_CONSTRUCTORS = {"torch.as_tensor", "torch.tensor"}

#: the raw collectives PHL008 flags (prefix matches cover ``_into_tensor``,
#: ``_object`` and ``_object_list`` forms)
_COLLECTIVE_PREFIXES = ("all_reduce", "all_gather", "broadcast", "reduce_scatter")
#: the counted wrappers of parallel/mesh.py, the one sanctioned home
_WRAPPER_FILE = "photon_tpu_torch/parallel/mesh.py"
_WRAPPERS = {"all_reduce_sum", "gather_rows", "gather_entities"}


def _is_cpu(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and node.value == "cpu"


def _is_device_arg(node: ast.expr) -> bool:
    """Whether ``.to(node)``'s positional argument names a device (not a
    dtype, not the host)."""
    if isinstance(node, ast.Constant):
        return isinstance(node.value, str) and node.value.startswith("cuda")
    if isinstance(node, ast.Call):
        return call_name(node) == "torch.device" and not (node.args and _is_cpu(node.args[0]))
    name = dotted_name(node) or ""
    last = name.rsplit(".", 1)[-1]
    return "device" in last or last == "cuda"


def _placed(call: ast.Call) -> ast.expr | None:
    """What a placement call puts on the card, or None when ``call`` is not
    a placement on the card."""
    func = call.func
    name = call_name(call)
    if name in _CONSTRUCTORS:
        device = keyword_arg(call, "device")
        if device is None or _is_cpu(device) or not call.args:
            return None
        return call.args[0]
    if not isinstance(func, ast.Attribute):
        return None
    if func.attr == "cuda" and not call.args:
        return func.value
    if func.attr == "to":
        device = keyword_arg(call, "device")
        if device is not None:
            return None if _is_cpu(device) else func.value
        if call.args and _is_device_arg(call.args[0]):
            return func.value
    return None


#: wrappers that keep what they wrap: ``torch.as_tensor(x[lo:hi])`` places a slice
_HOST_WRAPPERS = {"torch.as_tensor", "torch.tensor", "torch.from_numpy", "np.asarray",
                  "np.ascontiguousarray", "numpy.asarray"}


def _unwrap_host(node: ast.expr) -> ast.expr:
    """The array a placement chain starts from: through host wrappers
    (``torch.as_tensor(x)`` → ``x``) and method chains
    (``x[lo:hi].contiguous()`` → ``x[lo:hi]``)."""
    while isinstance(node, ast.Call):
        if call_name(node) in _HOST_WRAPPERS and node.args:
            node = node.args[0]
        elif isinstance(node.func, ast.Attribute) and (call_name(node) or "").rsplit(
                ".", 1)[-1] not in _SLICING_CALLS:
            node = node.func.value
        else:
            break
    return node


def _sliced(node: ast.expr) -> bool:
    node = _unwrap_host(node)
    if isinstance(node, (ast.Constant, ast.List, ast.Tuple)):
        return True
    if isinstance(node, ast.Subscript):
        sl = node.slice
        parts = sl.elts if isinstance(sl, ast.Tuple) else [sl]
        return any(isinstance(p, ast.Slice) for p in parts)
    if isinstance(node, ast.Call):
        name = call_name(node) or ""
        return name.rsplit(".", 1)[-1] in _SLICING_CALLS
    return False


@register
class PlacementWithoutSlicing(Rule):
    rule_id = "PHL007"
    title = "a whole host array placed on the card in mesh-scoped code"
    mesh_scoped_only = True

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            placed = _placed(node)
            if placed is None or _sliced(placed):
                continue
            fn = ctx.enclosing_function(node)
            if fn is not None and fn.name in _REPLICATING_FUNCTIONS:
                continue
            out.append(ctx.finding(
                self.rule_id, node,
                "a host array placed on the card whole, not through the mesh's row or "
                "entity slicing (shard_batch, row_range, entity_range, replicate): under a "
                "mesh every rank holds all of it; slice it first, or annotate a deliberate "
                "per-process placement with '# phl-ok: PHL007 <reason>'",
            ))
        return out


def _distributed_aliases(tree: ast.Module) -> tuple[set[str], set[str]]:
    """(module aliases of ``torch.distributed``, collective names imported
    from it)."""
    modules = {"torch.distributed"}
    names: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name == "torch.distributed" and a.asname:
                    modules.add(a.asname)
        elif isinstance(node, ast.ImportFrom):
            if node.module == "torch" and any(a.name == "distributed" for a in node.names):
                modules.update(a.asname or a.name for a in node.names if a.name == "distributed")
            elif node.module == "torch.distributed":
                names.update(a.asname or a.name for a in node.names
                             if a.name.startswith(_COLLECTIVE_PREFIXES))
    return modules, names


@register
class RawCollective(Rule):
    rule_id = "PHL008"
    title = "a torch.distributed collective outside parallel/mesh.py's counted wrappers"

    def check(self, ctx: FileContext) -> list[Finding]:
        modules, names = _distributed_aliases(ctx.tree)
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name is None:
                continue
            prefix, _, last = name.rpartition(".")
            raw = (prefix in modules and last.startswith(_COLLECTIVE_PREFIXES)) or (
                not prefix and last in names)
            if not raw:
                continue
            fn = ctx.enclosing_function(node)
            if ctx.path == _WRAPPER_FILE and fn is not None and fn.name in _WRAPPERS:
                continue
            out.append(ctx.finding(
                self.rule_id, node,
                f"raw collective {name}(...) outside parallel/mesh.py's counted wrappers "
                "(all_reduce_sum, gather_rows, gather_entities): its layout is undeclared "
                "and the mesh's census never sees it, so no coordinate's contract holds it; "
                "call a wrapper (with a site name if it needs an allowance of its own)",
            ))
        return out
