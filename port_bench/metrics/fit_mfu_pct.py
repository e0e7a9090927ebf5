"""The whole step's share of the H100's peaks: the least time its counted
work needs (the larger of operations over 67 TFLOP/s and bytes over
3.35 TB/s, counts/work.py) over ``fit_s``, in %."""

from port_bench.counts import peaks


def read(name, ctx):
    if not ctx.steps:
        return None
    flops, nbytes = ctx.cell.step_work()
    return 100.0 * peaks.least_seconds(flops, nbytes) / (ctx.window_s / ctx.steps)
