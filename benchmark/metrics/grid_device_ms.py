"""Device-busy milliseconds a request: the union of the device operations'
intervals inside the traced requests, over their count."""


def read(ctx):
    busy = ctx.trace.busy_s
    return 1e3 * busy / ctx.units if ctx.units and busy > 0 else None
