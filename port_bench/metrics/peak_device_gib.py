"""``torch.cuda.max_memory_allocated()`` over set-up and window, in GiB."""


def read(name, ctx):
    return ctx.peak_bytes / 2**30
