"""Host milliseconds a step in the optimizer: the mean wall of the port's
``mri.train.optimizer`` spans (the schedule and torch's Adam, device
kernels queued, not waited for); nothing where the window holds none."""

from ..spans import mean_wall_s


def read(ctx):
    s = mean_wall_s(ctx.trace, "mri.train.optimizer")
    return None if s is None else 1e3 * s
