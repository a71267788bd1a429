"""The whole step's (or request's) share of the card's roofline: the least
time of all the work in the traced window (``roofline.fit_step`` or
``roofline.grid_request`` at its shapes, times the units traced) over the
window's wall. This memory-bound model's FLOP-only share would read well
under 1%, so the share is of the roofline: the larger of the bytes' and
the operations' time."""


def read(ctx):
    least = ctx.work.get("whole_least_s")
    w = ctx.trace.window_s
    return 100.0 * least * ctx.units / w if least and w > 0 else None
