"""Device operations (kernels, copies, fills) a step, over the traced epoch."""


def read(ctx):
    return ctx.trace.n_ops / ctx.units if ctx.units else None
