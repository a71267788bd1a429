"""Host milliseconds a training step: the mean wall of the port's
``mri.train.step`` spans in the traced epoch (the batch's gather, the
forward, the backward, the update chain and storing the loss); nothing
where the window holds no such span."""

from ..spans import mean_wall_s


def read(ctx):
    s = mean_wall_s(ctx.trace, "mri.train.step")
    return None if s is None else 1e3 * s
