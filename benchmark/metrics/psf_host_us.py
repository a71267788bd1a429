"""Host microseconds a step inside the PSF objective's two spans: the mean
wall of the port's ``mri.model.psf_expand`` (the voxel centres to their B x
K rows) plus that of ``mri.model.psf_integrate`` (the Gaussian sum over K
and the MSE), each opened once a step; nothing where the window holds
neither (a tree without them, a model without the objective)."""

from ..spans import mean_wall_s

SPANS = ("mri.model.psf_expand", "mri.model.psf_integrate")


def read(ctx):
    walls = [mean_wall_s(ctx.trace, name) for name in SPANS]
    return None if None in walls else 1e6 * sum(walls)
