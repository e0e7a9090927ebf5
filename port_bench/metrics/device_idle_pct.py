"""The traced window less the union of the card's kernel, copy and memset
intervals, as a share of the window, in % (port_bench/trace.py)."""


def read(name, ctx):
    t = ctx.traced
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
