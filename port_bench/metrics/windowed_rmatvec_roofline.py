"""The windowed Xᵀr kernel's share of its roofline, in %: its byte floor
for the cell's own data (counts/work.py) over 3.35 TB/s, over its mean
device time per launch in the trace: the union of the intervals of the
partials kernel and its fix-up (which may overlap), over the partials
kernel's launches."""

from port_bench import trace
from port_bench.counts import peaks

PARTIALS, FIXUP = "windowed_partials", "window_fixup"


def read(name, ctx):
    t = ctx.traced
    if not t:
        return None
    spans, launches = [], 0
    for kernel, s in t["kernel_spans"].items():
        if PARTIALS in kernel or FIXUP in kernel:
            spans.extend(s)
            launches += len(s) if PARTIALS in kernel else 0
    seconds = sum(b - a for a, b in trace.merge(spans)) / 1e6
    if not launches or seconds <= 0:
        return None
    return 100.0 * (ctx.cell.kernel_bytes() / peaks.HBM_BYTES_PER_S) / (seconds / launches)
