"""Device milliseconds a step in the optimizer's kernels (the ``optimizer``
family of ``kernels/``), over the traced epoch; nothing where the traced
window ran none."""


def read(ctx):
    part = ctx.work.get("optimizer")
    seconds = ctx.trace.work_s(part["works"]) if part else 0.0
    return 1e3 * seconds / ctx.units if seconds > 0 else None
