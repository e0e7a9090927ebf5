"""The share of the column-window layout's slots that hold a nonzero, in
%: the port's ``windows.nnz`` over ``windows.slots`` (W_inst·L), summed
over the layouts the run built (``ops/sparse_windows.py``; the single-GLM
cells build one). The windowed Xᵀr kernel reads every slot. None where the
port counts neither."""

from port_bench.entries import registry


def read(name, ctx):
    c = registry.counters("windows.nnz", "windows.slots")
    if c is None or not c["windows.slots"]:
        return None
    return 100.0 * c["windows.nnz"] / c["windows.slots"]
