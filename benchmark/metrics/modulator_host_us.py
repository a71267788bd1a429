"""Host microseconds a step inside the port's ``mri.model.modulator`` spans
(the modulated or hash SIREN's modulator network over its latent: its
layers, ReLUs and concatenations, their kernels queued, not waited for):
the window's time inside them, clipped to it, over the steps traced;
nothing where the window holds none (a tree without the span, a model
without a modulator)."""

from ..spans import total_wall_s


def read(ctx):
    s = total_wall_s(ctx.trace, "mri.model.modulator")
    return 1e6 * s / ctx.units if s is not None and ctx.units else None
