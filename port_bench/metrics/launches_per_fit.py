"""Device kernels in the trace over the steps traced."""


def read(name, ctx):
    t = ctx.traced
    if not t or not ctx.traced_steps:
        return None
    return sum(n for _, n in t["kernels"].values()) / ctx.traced_steps
