"""PHL004 — ctypes string-pool access must not materialize temporaries.

The native Avro decoder's use-after-free: a C ``char**`` pool bound as
``POINTER(c_char_p)`` looks convenient — ``pool[i]`` gives Python
``bytes`` — but that indexing materializes a TEMPORARY bytes copy (read
to the first NUL), and any pointer taken into it dangles the moment the
temporary is collected. Under allocation churn the freed buffer was
reused and feature keys decoded as heap garbage; every key then missed
the index map and scoring collapsed to intercept-only. The discipline (io/native_avro.py): bind ``char**`` as
``POINTER(c_void_p)`` — raw addresses into C-owned memory, valid until
the C free — and slice strings out with ``ctypes.string_at``.

This rule flags ANY construction of ``POINTER(c_char_p)`` (field types,
casts, restype declarations): there is no safe indexing of one when the
underlying buffers are C-owned.
"""
from __future__ import annotations

import ast

from photon_tpu_torch.analysis.core import (
    FileContext,
    Finding,
    Rule,
    call_name,
    dotted_name,
    register,
)


@register
class CharPointerPool(Rule):
    rule_id = "PHL004"
    title = "POINTER(c_char_p) binding materializes temporary buffers"

    def check(self, ctx: FileContext) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(ctx.tree):
            if not isinstance(node, ast.Call):
                continue
            name = call_name(node)
            if name not in ("POINTER", "ctypes.POINTER") or not node.args:
                continue
            arg = dotted_name(node.args[0])
            if arg in ("c_char_p", "ctypes.c_char_p"):
                out.append(
                    ctx.finding(
                        self.rule_id,
                        node,
                        "POINTER(c_char_p): indexing it materializes a "
                        "TEMPORARY Python bytes copy — pointers into "
                        "that temporary are a use-after-free (the native decoder's "
                        "heap-garbage feature keys); bind char** as "
                        "POINTER(c_void_p) and read via "
                        "ctypes.string_at(addr, length)",
                    )
                )
        return out
