"""The ELL forward-pass kernel's share of its roofline, in %: the pass's
byte floor for the cell's own data (``counts/work.sparse_pass``: each
nonzero's column id and value, the row vector and the column vector once,
not the layout's padding slots) over 3.35 TB/s, over its mean device time
per launch in the trace: the union of the intervals of the kernels whose
name holds ``ell_matvec``, over their launches. The shape is the fixed
effect's in the GAME cell (the entry's ``_fe_shape``) and the data set's in
the GLM cell (``_shape``). None where no such kernel ran (a port without
it)."""

from port_bench import trace
from port_bench.counts import peaks, work

KERNEL = "ell_matvec"


def read(name, ctx):
    t = ctx.traced
    if not t:
        return None
    spans = [s for kernel, ss in t["kernel_spans"].items() if KERNEL in kernel for s in ss]
    seconds = sum(b - a for a, b in trace.merge(spans)) / 1e6
    if not spans or seconds <= 0:
        return None
    cell = ctx.cell
    shape = cell._fe_shape() if hasattr(cell, "_fe_shape") else cell._shape()
    _, nbytes = work.sparse_pass(*shape, item=cell.dtype.itemsize)
    return 100.0 * (nbytes / peaks.HBM_BYTES_PER_S) / (seconds / len(spans))
