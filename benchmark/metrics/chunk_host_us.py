"""Host microseconds a grid chunk: the mean wall of the port's
``mri.grid.chunk`` spans (a chunk's coordinates, its forward and its
store, queued on the device); nothing where the window holds none."""

from ..spans import mean_wall_s


def read(ctx):
    s = mean_wall_s(ctx.trace, "mri.grid.chunk")
    return None if s is None else 1e6 * s
