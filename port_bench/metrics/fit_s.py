"""The window's wall over the whole steps it ran: one cold fit or solve
(host clock; every step ends with a read-back)."""


def read(name, ctx):
    return ctx.window_s / ctx.steps if ctx.steps else None
