"""Host microseconds a step inside the port's ``mri.model.gabor`` spans (each
complex Gabor layer's activation, its kernels queued, not waited for): the
window's time inside them, clipped to it, over the steps traced; nothing
where the window holds none (a tree without the span, a model without a
complex Gabor layer)."""

from ..spans import total_wall_s


def read(ctx):
    s = total_wall_s(ctx.trace, "mri.model.gabor")
    return 1e6 * s / ctx.units if s is not None and ctx.units else None
