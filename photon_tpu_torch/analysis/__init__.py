"""photon-lint for the PyTorch port: host/device discipline static analysis.

The JAX package's AST engine and the rules that apply to PyTorch code,
over every module of ``photon_tpu_torch``: PHL001 (a numpy view of a
tensor escaping without a copy), PHL002 (host syncs in hot-path modules,
in torch's forms), PHL003 (thread and queue lifecycles), PHL004 (ctypes
``char**`` pools), PHL006 (wall-clock durations), PHL009 (retry loops)
and PHL010 (numpy views over an mmap). ``analysis.shapes`` holds the
solve-shape census of a built fit.

Run it with ``python -m photon_tpu_torch.analysis``: exit 0 when every
finding is annotated (``# phl-ok: PHLnnn <reason>``) or in
``baseline.toml`` and no baseline entry is stale.
"""
from photon_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Rule,
    all_rules,
    analyze_source,
    analyze_tree,
    is_hot_path,
    match_sites,
    statement_span,
)
