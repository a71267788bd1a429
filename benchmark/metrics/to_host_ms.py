"""Host milliseconds of a request's copy to host memory: the mean wall of
the port's ``mri.grid.to_host`` spans (the wait for the request's queued
device work and the copy to pageable memory); nothing where the window
holds none."""

from ..spans import mean_wall_s


def read(ctx):
    s = mean_wall_s(ctx.trace, "mri.grid.to_host")
    return None if s is None else 1e3 * s
