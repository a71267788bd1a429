"""Host microseconds the port's kernel ops take a unit of work (a step of
the fit, a request of the grid eval): the window's time inside the
dispatcher's ``mri_torch::*`` events (each op's whole host path, its CUDA
impl's checks, allocations and the ctypes launch, the port's
``mri.op.launch`` span inside) over the units traced. A fused or removed op
reads as a gain; nothing where no op ran."""

from ..spans import total_wall_s


def read(ctx):
    s = total_wall_s(ctx.trace, "mri_torch::", prefix=True)
    return 1e6 * s / ctx.units if s is not None and ctx.units else None
