"""The hash encoder's kernels against their roofline: the least time of the
encoder's work in the traced window (the entry's ``hash`` part: the forward,
and in a fit the table gradient, at the window's shapes and touched rows)
over the device time of the kernels that did it; nothing where none ran."""


def read(ctx):
    part = ctx.work.get("hash")
    seconds = ctx.trace.work_s(part["works"]) if part else 0.0
    return 100.0 * part["least_s"] * ctx.units / seconds if seconds > 0 else None
