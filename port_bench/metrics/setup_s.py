"""Process start to the first timed step: imports, data, host build,
warm-up and the first fit (host clock)."""


def read(name, ctx):
    return ctx.setup_s
